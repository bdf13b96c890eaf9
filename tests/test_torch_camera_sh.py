"""hugs_tpu_torch camera and SH math against hugs_tpu, same numpy inputs.

Tolerance atol 1e-6: both evaluate the same float32 expressions, so only
the last bits of transcendental functions and of the 4x4 inverse differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.ops import graphics as jg
from hugs_tpu.ops import sh as jsh
from hugs_tpu_torch.ops import graphics as tg
from hugs_tpu_torch.ops import sh as tsh
from torch_parity import cameras, np_of


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


@pytest.mark.parametrize("case", [
    (None, None, 0.9, 0.7),
    (_rotation(1), np.array([0.3, -1.2, 2.5], np.float32), 1.1, 0.6),
    (_rotation(2), np.array([-1.5, 0.5, 2.0], np.float32), 0.5, 0.5),
])
def test_camera_matrices_match(case):
    R, t, fovx, fovy = case
    jc, tc = cameras(R, t, fovx, fovy)
    for f in jc._fields:
        np.testing.assert_allclose(np_of(getattr(tc, f)),
                                   np_of(getattr(jc, f)), atol=1e-6,
                                   err_msg=f)


def test_graphics_helpers_match():
    R, t = _rotation(3), np.array([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(
        np_of(tg.world_to_view(torch.as_tensor(R), torch.as_tensor(t))),
        np_of(jg.world_to_view(jnp.asarray(R), jnp.asarray(t))), atol=1e-6)
    np.testing.assert_allclose(
        np_of(tg.projection_matrix(0.01, 100.0, 0.9, 0.7, device="cpu")),
        np_of(jg.projection_matrix(0.01, 100.0, 0.9, 0.7)), atol=1e-6)
    assert tg.fov2focal(0.9, 640) == jg.fov2focal(0.9, 640)
    assert tg.focal2fov(500.0, 640) == jg.focal2fov(500.0, 640)


def _sh_inputs(n=257, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = (rng.normal(size=(n, 16, 3)) * 0.5).astype(np.float32)
    return d, sh


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_eval_sh_rows_match(active):
    d, sh = _sh_inputs(seed=active)
    rows = sh.reshape(len(d), 48).T.copy()
    ref = jsh.eval_sh_rows(3, jnp.int32(active), jnp.asarray(rows),
                           *(jnp.asarray(d[:, i]) for i in range(3)))
    out = tsh.eval_sh_rows(3, torch.tensor(active, dtype=torch.int32),
                           torch.as_tensor(rows),
                           *(torch.as_tensor(d[:, i]) for i in range(3)))
    np.testing.assert_allclose(np_of(out), np_of(ref), atol=1e-6)
    # the masked per-point form agrees with the row form
    masked = tsh.eval_sh_masked(3, active, torch.as_tensor(sh).transpose(1, 2),
                                torch.as_tensor(d))
    np.testing.assert_allclose(np_of(masked).T, np_of(ref), atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_match(deg):
    rng = np.random.default_rng(10 + deg)
    d, _ = _sh_inputs(seed=deg)
    sh = rng.normal(size=(len(d), 3, (deg + 1) ** 2)).astype(np.float32)
    ref = jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    out = tsh.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d))
    np.testing.assert_allclose(np_of(out), np_of(ref), atol=1e-6)


def test_rgb_sh_round_trip_match():
    rgb = np.random.default_rng(4).uniform(size=(50, 3)).astype(np.float32)
    sh = tsh.rgb_to_sh(torch.as_tensor(rgb))
    np.testing.assert_allclose(np_of(sh), np_of(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               atol=1e-6)
    np.testing.assert_allclose(np_of(tsh.sh_to_rgb(sh)), rgb, atol=1e-6)
