"""hugs_tpu_torch rotations, covariance, losses and optimizer against
hugs_tpu, on the same numpy inputs.

Tolerances: rotations, covariance and loss values atol 1e-6 (float32
rounding of the same formulas); the SSIM gradient atol 1e-6; expon_lr
rtol 1e-6; three Adam steps from the same gradients and state: params,
mu and nu atol 1e-7 and rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.losses import basic as jloss
from hugs_tpu.ops import covariance as jcov
from hugs_tpu.ops import rotations as jrot
from hugs_tpu.train import optim as joptim
from hugs_tpu_torch.convert import adam_state_from_numpy
from hugs_tpu_torch.losses import basic as tloss
from hugs_tpu_torch.ops import covariance as tcov
from hugs_tpu_torch.ops import rotations as trot
from hugs_tpu_torch.train import optim as toptim
from torch_parity import np_of

ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _quats(n, seed):
    return _rng(seed).normal(size=(n, 4)).astype(np.float32)


def _rotmats(n, seed):
    return np.asarray(jrot.quat_to_matrix(jrot.quat_normalize(
        jnp.asarray(_quats(n, seed)))))


def _close(got, want, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(np_of(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


# (function name, input maker): every function of the module, one input
_ROT_CASES = [
    ("quat_normalize", lambda: (_quats(64, 0),)),
    ("quat_to_matrix", lambda: (_quats(64, 1),)),
    ("matrix_to_quat", lambda: (_rotmats(64, 2),)),
    ("quat_multiply", lambda: (_quats(64, 3), _quats(64, 4))),
    ("axis_angle_to_quat", lambda: (np.concatenate(
        [_rng(5).normal(size=(62, 3)), np.zeros((2, 3))]).astype(np.float32),)),
    ("quat_to_axis_angle", lambda: (_quats(64, 6),)),
    ("axis_angle_to_matrix", lambda: (
        _rng(7).normal(size=(64, 3)).astype(np.float32),)),
    ("matrix_to_axis_angle", lambda: (_rotmats(64, 8),)),
    ("rotation_6d_to_matrix", lambda: (
        _rng(9).normal(size=(64, 6)).astype(np.float32),)),
    ("matrix_to_rotation_6d", lambda: (_rotmats(64, 10),)),
    ("axis_angle_to_rotation_6d", lambda: (
        _rng(11).normal(size=(64, 3)).astype(np.float32),)),
    ("rotation_6d_to_axis_angle", lambda: (
        _rng(12).normal(size=(64, 6)).astype(np.float32),)),
    ("rotation_matrix_from_vectors", lambda: (
        np.concatenate([_rng(13).normal(size=(62, 3)),
                        [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]]).astype(np.float32),
        np.concatenate([_rng(14).normal(size=(62, 3)),
                        [[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]]]).astype(np.float32))),
    ("euler_to_matrix", lambda: (
        _rng(15).uniform(-3.0, 3.0, size=(64, 3)).astype(np.float32),)),
    ("matrix_to_euler", lambda: (_rotmats(64, 16),)),
]


@pytest.mark.parametrize("name,make", _ROT_CASES, ids=[c[0] for c in _ROT_CASES])
def test_rotations_match_jax(name, make):
    args = make()
    want = getattr(jrot, name)(*(jnp.asarray(a) for a in args))
    got = getattr(trot, name)(*(torch.as_tensor(a) for a in args))
    _close(got, want, msg=name)


def test_covariance_matches_jax():
    q = _quats(64, 20)
    s = np.exp(_rng(21).normal(size=(64, 3)) * 0.5 - 2.0).astype(np.float32)
    jq, js = jnp.asarray(q), jnp.asarray(s)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s)
    _close(tcov.build_rotation(tq), jcov.build_rotation(jq))
    _close(tcov.build_scaling_rotation(ts, tq),
           jcov.build_scaling_rotation(js, jq))
    cov_t = tcov.covariance_from_scaling_rotation(ts, tq, 1.3)
    cov_j = jcov.covariance_from_scaling_rotation(js, jq, 1.3)
    _close(cov_t, cov_j)
    _close(tcov.strip_symmetric(cov_t), jcov.strip_symmetric(cov_j))


def _images(seed, h=40, w=56):
    rng = _rng(seed)
    a = rng.uniform(size=(3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


def test_image_losses_match_jax():
    a, b = _images(30)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    mask = (_rng(31).uniform(size=(1, 40, 56)) > 0.3)
    for name in ("l1_loss", "l2_loss", "psnr", "ssim"):
        _close(getattr(tloss, name)(ta, tb), getattr(jloss, name)(ja, jb),
               msg=name)
    _close(tloss.l1_loss(ta, tb, torch.as_tensor(mask)),
           jloss.l1_loss(ja, jb, jnp.asarray(mask)))
    _close(tloss.total_variation_loss(ta), jloss.total_variation_loss(ja))
    _close(tloss.total_variation_loss(ta, torch.as_tensor(mask)),
           jloss.total_variation_loss(ja, jnp.asarray(mask)))
    # a rectangle, zero outside it
    valid = np.zeros((1, 40, 56), bool)
    valid[:, 5:30, 8:44] = True
    za, zb = a * valid, b * valid
    _close(tloss.ssim_masked(torch.as_tensor(za), torch.as_tensor(zb),
                             torch.as_tensor(valid), torch.tensor(25 * 36)),
           jloss.ssim_masked(jnp.asarray(za), jnp.asarray(zb),
                             jnp.asarray(valid), jnp.int32(25 * 36)))


def test_psnr_value():
    """psnr against float64 numpy: 1e-4 on a value near 20, float32's
    rounding of the mean and the log10 at that magnitude."""
    a, b = _images(32)
    want = 20.0 * np.log10(1.0 / np.sqrt(np.mean(
        (a.astype(np.float64) - b) ** 2)))
    assert abs(float(tloss.psnr(torch.as_tensor(a), torch.as_tensor(b)))
               - want) < 1e-4


def test_ssim_gradient_matches_jax():
    a, b = _images(33)
    want = jax.grad(lambda x: jloss.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    ta = torch.as_tensor(a).requires_grad_(True)
    tloss.ssim(ta, torch.as_tensor(b)).backward()
    _close(ta.grad, want)


def test_pcd_laplacian_smoothing_matches_jax():
    rng = _rng(34)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    edges = rng.integers(0, 50, size=(120, 2)).astype(np.int32)
    _close(tloss.pcd_laplacian_smoothing(torch.as_tensor(verts),
                                         torch.as_tensor(edges)),
           jloss.pcd_laplacian_smoothing(jnp.asarray(verts),
                                         jnp.asarray(edges)))


@pytest.mark.parametrize("delay", [0, 50])
def test_expon_lr_matches_jax(delay):
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=delay,
              lr_delay_mult=0.01, max_steps=30_000)
    j, t = joptim.expon_lr(**kw), toptim.expon_lr(**kw)
    for step in (-1, 0, 1, 7, 49, 50, 1000, 29_999, 30_000, 40_000):
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6,
                                   err_msg=str(step))
    zero = toptim.expon_lr(0.0, 0.0)
    assert float(zero(10)) == 0.0


def test_group_adam_matches_jax():
    """Three steps from the same gradients and a nonzero state; a group
    absent from `lrs` stays frozen."""
    rng = _rng(40)
    shapes = {"xyz": (32, 3), "features_dc": (32, 1, 3), "opacity": (32, 1)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    mu = {k: rng.normal(size=s).astype(np.float32) * 1e-3
          for k, s in shapes.items()}
    nu = {k: rng.uniform(size=s).astype(np.float32) * 1e-6
          for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(3)]
    lrs_np = {"xyz": np.float32(1.6e-4), "features_dc": 0.0025}

    jstate = joptim.GroupAdamState(
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()}, step=jnp.int32(4))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tstate = adam_state_from_numpy(mu, nu, 4, device="cpu")
    tparams = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    tlrs = {"xyz": torch.tensor(lrs_np["xyz"]), "features_dc": 0.0025}
    jlrs = {"xyz": jnp.asarray(lrs_np["xyz"]), "features_dc": 0.0025}
    for g in grads:
        jparams, jstate = joptim.group_adam_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams, jlrs)
        toptim.group_adam_update({k: torch.as_tensor(v) for k, v in g.items()},
                                 tstate, tparams, tlrs)
    assert int(tstate.step) == int(jstate.step) == 7
    for k in shapes:
        for got, want in ((tparams[k], jparams[k]), (tstate.mu[k], jstate.mu[k]),
                          (tstate.nu[k], jstate.nu[k])):
            _close(got, want, atol=1e-7, rtol=1e-6, msg=k)
    np.testing.assert_array_equal(np_of(tparams["opacity"]),
                                  params["opacity"])
