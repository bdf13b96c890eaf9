"""hugs_tpu_torch blend and render against hugs_tpu, same numpy inputs.

Bar: images atol 2e-5, the bar tests/test_pallas_blend.py sets between
the JAX package's own backends. The sums of colour and transmittance run
in another order in each implementation, so results agree to float32
rounding, not bit for bit. hugs_tpu's Pallas kernel runs in interpret
mode here, as in its own tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.render import render as jax_render
from hugs_tpu_torch.render import cuda_blend, render
from hugs_tpu_torch.render.blend import (
    blend_tiles_plain, gauss_features, plain_blend, tile_overflow,
)
from hugs_tpu_torch.render.oracle import LOG_TEPS
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import bin_gaussians
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, cameras, cuda_device, make_saturating_scene, make_scene, np_of,
    to_jax, to_torch,
)

ARGS = ("means", "scales", "rotq", "opacity", "shs")
ATOL = 2e-5


def _jax_image(scene, backend, bg, active=3, **kw):
    jc, _ = cameras()
    js = to_jax(scene)
    return np_of(jax_render(*(js[a] for a in ARGS), camera=jc, width=W,
                            height=H, bg=jnp.asarray(bg),
                            active_sh_degree=active, backend=backend,
                            instance_budget=16384, **kw)["render"])


def _torch_render(scene, backend, bg, active=3):
    _, tc = cameras()
    ts = to_torch(scene)
    return render(*(ts[a] for a in ARGS), camera=tc, width=W, height=H,
                  bg=torch.as_tensor(bg), active_sh_degree=active,
                  backend=backend, instance_budget=16384)


def _scene(name):
    return (make_saturating_scene() if name == "saturating"
            else make_scene(n=300, seed=int(name)))


@pytest.mark.parametrize("name,bg", [
    ("0", (0.0, 0.0, 0.0)), ("1", (0.2, 0.3, 0.4)),
    ("saturating", (0.9, 0.1, 0.2))])
def test_blend_tiles_plain_matches_jax_tiled(name, bg):
    scene = _scene(name)
    active = 2 if name == "saturating" else 3
    _, tc = cameras()
    ts = to_torch(scene)
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, active)
    bins = bin_gaussians(pg, W, H, 16384)
    img = blend_tiles_plain(pg, bins, W, H, torch.tensor(bg))
    ref = _jax_image(scene, "tiled", bg, active, tile_cap=2048)
    np.testing.assert_allclose(np_of(img), ref, atol=ATOL)


@pytest.mark.parametrize("name,bg", [
    ("2", (0.2, 0.3, 0.4)), ("saturating", (0.9, 0.1, 0.2))])
def test_render_matches_jax_pallas(name, bg):
    scene = _scene(name)
    active = 2 if name == "saturating" else 3
    out = _torch_render(scene, "tiled", bg, active)
    ref = _jax_image(scene, "pallas", bg, active, power_mxu=False)
    np.testing.assert_allclose(np_of(out["render"]), ref, atol=ATOL)
    assert not bool(out["overflowed"])


@pytest.mark.parametrize("name,bg", [
    ("3", (0.5, 0.5, 0.5)), ("saturating", (0.9, 0.1, 0.2))])
def test_oracle_matches_jax_oracle(name, bg):
    scene = _scene(name)
    out = _torch_render(scene, "oracle", bg)
    ref = _jax_image(scene, "oracle", bg)
    np.testing.assert_allclose(np_of(out["render"]), ref, atol=ATOL)
    # and the tiled path agrees with the dense oracle
    tiled = _torch_render(scene, "tiled", bg)["render"]
    np.testing.assert_allclose(np_of(tiled), np_of(out["render"]), atol=ATOL)


def test_tile_cap_truncates_like_jax():
    scene = make_scene(n=300, seed=5)
    bg = (0.1, 0.2, 0.3)
    _, tc = cameras()
    ts = to_torch(scene)
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, 3)
    bins = bin_gaussians(pg, W, H, 16384)
    cap = 40
    assert bool(tile_overflow(bins, cap))
    img = blend_tiles_plain(pg, bins, W, H, torch.tensor(bg), tile_cap=cap)
    ref = _jax_image(scene, "tiled", bg, tile_cap=cap)
    np.testing.assert_allclose(np_of(img), ref, atol=ATOL)


def test_plain_blend_outputs_on_saturated_scene():
    """log T and the per-pixel pair counts: every pixel of the saturated
    scene ends below T_EPS and stops testing before its list ends."""
    scene = make_saturating_scene()
    _, tc = cameras()
    ts = to_torch(scene)
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, 2)
    bins = bin_gaussians(pg, W, H, 16384)
    img, log_t, pairs = plain_blend(gauss_features(pg), bins.gauss_id,
                                    bins.starts, bins.ends,
                                    torch.zeros(3), W, H)
    assert img.shape == (3, H, W) and log_t.shape == (H, W)
    assert bool((log_t < LOG_TEPS).all())
    counts = np_of(bins.ends - bins.starts).reshape(3, 4)
    per_pixel = np.kron(counts, np.ones((16, 16), np.int64))
    tested, blended = np_of(pairs)
    assert (blended <= tested).all() and (tested < per_pixel).all()


def test_cuda_blend_routes_cpu_tensors_to_plain():
    scene = make_scene(n=200, seed=6)
    _, tc = cameras()
    ts = to_torch(scene)
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, 3)
    bins = bin_gaussians(pg, W, H, 16384)
    bg = torch.tensor([0.3, 0.2, 0.1])
    before = cuda_blend.LAUNCHES
    img = cuda_blend.blend_tiles(pg, bins, W, H, bg)
    assert cuda_blend.LAUNCHES == before
    np.testing.assert_array_equal(
        np_of(img), np_of(blend_tiles_plain(pg, bins, W, H, bg)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["7", "saturating"])
def test_k1_matches_plain_on_card(cuda_device, name):
    """K1 against the plain blend on the card, at a test-sized scene:
    raw images atol 2e-5; final log T atol 1e-4 on the pixels that did not
    saturate (K1 stops summing where a pixel saturates, the plain blend
    does not, and the two sum in another order)."""
    scene = _scene(name)
    _, tc = cameras()
    tc = type(tc)(*(x.to(cuda_device) for x in tc))
    ts = {k: v.to(cuda_device) for k, v in to_torch(scene).items()}
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, 3)
    bins = bin_gaussians(pg, W, H, 16384)
    bg = torch.tensor([0.2, 0.3, 0.4], device=cuda_device)
    feat = gauss_features(pg)
    img, log_t, n_walked, walked = cuda_blend.blend_fwd(
        feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H)
    ref, ref_log_t, _ = plain_blend(feat, bins.gauss_id, bins.starts,
                                    bins.ends, bg, W, H)
    torch.cuda.synchronize()
    np.testing.assert_allclose(np_of(img), np_of(ref), atol=ATOL)
    live = np_of(ref_log_t) >= LOG_TEPS
    np.testing.assert_allclose(np_of(log_t)[live], np_of(ref_log_t)[live],
                               atol=1e-4)
    listed = np_of(bins.ends - bins.starts)
    assert (np_of(walked) <= listed).all()
    per_pixel = np.kron(np_of(walked).reshape(3, 4),
                        np.ones((16, 16), np.int64))
    assert (np_of(n_walked) <= per_pixel).all()
    if name == "saturating":        # the early exit cut the walk short
        assert not live.any() and np_of(walked).sum() < listed.sum()



@pytest.mark.cuda
@pytest.mark.parametrize("name", ["multichunk_empty", "tight_budget"])
def test_k1_matches_plain_on_edge_scenes_on_card(cuda_device, name):
    """K1 against the plain blend on two of scripts/kernel_parity_tpu.py's
    scenes (micro/kernel_parity.py): several of K1's 256-instance batches
    a tile with empty tiles beside them, and the budget equal to the exact
    slot demand. Raw images atol 2e-5, final log T atol 1e-4 where a pixel
    did not saturate, as above."""
    from hugs_tpu_torch.micro import kernel_parity as kp
    inp, _, _, pg, bins, _ = kp.case_bins(name, cuda_device)
    w, h = inp["W"], inp["H"]
    feat = gauss_features(pg).detach()
    bg = torch.as_tensor(inp["bg"], device=cuda_device)
    args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, w, h)
    img, log_t, n_walked, walked = cuda_blend.blend_fwd(*args)
    ref, ref_log_t, _ = plain_blend(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(np_of(img), np_of(ref), atol=ATOL)
    live = np_of(ref_log_t) >= LOG_TEPS
    np.testing.assert_allclose(np_of(log_t)[live], np_of(ref_log_t)[live],
                               atol=1e-4)
    listed = np_of(bins.ends - bins.starts)
    assert (np_of(walked) <= listed).all()
    if name == "multichunk_empty":
        assert listed.max() > 2 * kp.K1_BATCH and (listed == 0).any()
