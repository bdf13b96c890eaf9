"""The backward of the port's blend against hugs_tpu, same numpy inputs.

- The image clip's gradient: hugs_tpu clips with jnp.clip, whose
  gradient is 0.5 at exactly 0 or 1; the port's clip01 matches it, so
  d(loss)/d(bg) at bg = 0 over empty pixels (raw colour exactly 0)
  agrees to atol 1e-6.
- plain_blend_bwd (K2's plain version) against autograd through
  plain_blend: atol 1e-6; the two sum the per-Gaussian rows in another
  order.
- The gradients of the port's render (means, scales, rotq, opacity, shs,
  bg and the mean2d hook) against hugs_tpu's render(backend="pallas"),
  whose Pallas kernels run in interpret mode here, and "tiled": atol
  1e-6 and rtol 1e-4, the bar tests/test_pallas_blend.py:62 sets between
  hugs_tpu's own backends; on the saturated scene atol 2e-5 and rtol
  1e-3, its bar there (:163), since every pixel's sums end at the T_EPS
  threshold.
- K2 against plain_blend_bwd on the card, with the padding slots of a
  budget far above demand, and against itself across two calls (marked
  cuda, skipped here).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.render import render as jax_render
from hugs_tpu_torch.render import cuda_blend, render
from hugs_tpu_torch.render.blend import (
    gauss_features, plain_blend, plain_blend_bwd,
)
from hugs_tpu_torch.render.oracle import clip01
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import bin_gaussians
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, cameras, cuda_device, make_saturating_scene, make_scene, np_of,
    to_jax, to_torch,
)

ARGS = ("means", "scales", "rotq", "opacity", "shs")
GRADS = ARGS + ("bg", "mean2d_hook")
BUDGET = 16384


def _scene(name):
    if name == "saturating":
        return make_saturating_scene(), 2, np.array([0.9, 0.1, 0.2],
                                                    np.float32)
    # bg 0: pixels that no splat covers are exactly 0 before the clip
    return make_scene(n=300, seed=int(name)), 3, np.zeros(3, np.float32)


def _target():
    return np.random.default_rng(7).uniform(size=(3, H, W)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grads(name, backend):
    """hugs_tpu's d(mean squared error)/d(every input) of its render."""
    scene, active, bg = _scene(name)
    jc, _ = cameras()
    target = jnp.asarray(_target())
    kw = ({"tile_cap": 2048} if backend == "tiled" else {"power_mxu": False})

    def loss(m, s, q, o, c, b, hook):
        img = jax_render(m, s, q, o, c, camera=jc, width=W, height=H, bg=b,
                         active_sh_degree=active, backend=backend,
                         instance_budget=BUDGET, mean2d_grad_hook=hook,
                         **kw)["render"]
        return jnp.mean((img - target) ** 2)

    js = to_jax(scene)
    n = scene["means"].shape[0]
    args = [js[a] for a in ARGS] + [jnp.asarray(bg), jnp.zeros((n, 2))]
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*args)
    return {k: np.asarray(g) for k, g in zip(GRADS, grads)}


def _torch_grads(name):
    """The port's gradients of the same loss, and its render output."""
    scene, active, bg = _scene(name)
    _, tc = cameras()
    ts = {k: v.clone().requires_grad_(True)
          for k, v in to_torch(scene).items()}
    b = torch.as_tensor(bg).clone().requires_grad_(True)
    hook = torch.zeros((scene["means"].shape[0], 2), requires_grad=True)
    out = render(*(ts[a] for a in ARGS), tc, W, H, bg=b,
                 active_sh_degree=active, instance_budget=BUDGET,
                 mean2d_grad_hook=hook)
    loss = torch.mean((out["render"] - torch.as_tensor(_target())) ** 2)
    grads = torch.autograd.grad(loss, [ts[a] for a in ARGS] + [b, hook])
    return {k: np_of(g) for k, g in zip(GRADS, grads)}, out


def test_clip01_gradient_at_bounds():
    """0.5 at exactly 0 and 1, as jnp.clip; torch.clamp would give 1."""
    x = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    clip01(x).sum().backward()
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray([0.0, 0.5,
                                                               1.0])))
    np.testing.assert_array_equal(np_of(x.grad), want)
    np.testing.assert_array_equal(want, [0.5, 1.0, 0.5])


@pytest.mark.parametrize("backend", ["tiled", "pallas"])
def test_bg_gradient_at_the_clip_bound_matches_jax(backend):
    """bg = 0 with empty pixels: every empty pixel's raw colour is exactly
    0, where the clip's gradient is 0.5, so d(loss)/d(bg) carries half
    their weight in hugs_tpu. atol 1e-6."""
    got, out = _torch_grads("0")
    empty = int((out["render"] == 0.0).all(dim=0).sum())
    assert empty > 20, "the scene needs pixels no splat covers"
    np.testing.assert_allclose(got["bg"], _jax_grads("0", backend)["bg"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["0", "saturating"])
@pytest.mark.parametrize("backend", ["tiled", "pallas"])
def test_render_gradients_match_jax(name, backend):
    atol, rtol = (2e-5, 1e-3) if name == "saturating" else (1e-6, 1e-4)
    got, out = _torch_grads(name)
    assert not bool(out["overflowed"])
    want = _jax_grads(name, backend)
    for k in GRADS:
        # the saturated scene's splats are isotropic and hide the
        # background everywhere: no rotation or background gradient
        assert np.abs(want[k]).max() > 0 or (
            name == "saturating" and k in ("rotq", "bg")), k
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _bins_and_grad(name, device="cpu", budget=BUDGET, scene=None):
    default, active, bg = _scene(name)
    scene = default if scene is None else scene
    _, tc = cameras()
    tc = type(tc)(*(x.to(device) for x in tc))
    ts = {k: v.to(device) for k, v in to_torch(scene).items()}
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, W, H, active)
    bins = bin_gaussians(pg, W, H, budget)
    # the gradient a mean squared error hands the raw colour
    rng = np.random.default_rng(11)
    g = rng.normal(size=(3, H, W)).astype(np.float32) * (2.0 / (3 * H * W))
    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    return (gauss_features(pg).detach().contiguous(), bins, bg,
            torch.as_tensor(g, device=device))


@pytest.mark.parametrize("name", ["1", "saturating"])
def test_plain_blend_bwd_matches_autograd(name):
    """Batch by batch against autograd through the whole plain_blend:
    atol 1e-6 (the per-Gaussian rows are summed in another order)."""
    feat, bins, bg, g = _bins_and_grad(name)
    f = feat.clone().requires_grad_(True)
    b = bg.clone().requires_grad_(True)
    img = plain_blend(f, bins.gauss_id, bins.starts, bins.ends, b, W, H)[0]
    want_f, want_b = torch.autograd.grad(img, (f, b), g)
    got_f, got_b = plain_blend_bwd(feat, bins.gauss_id, bins.starts,
                                   bins.ends, bg, W, H, g)
    assert float(want_f.abs().max()) > 0
    np.testing.assert_allclose(np_of(got_f), np_of(want_f), atol=1e-6)
    np.testing.assert_allclose(np_of(got_b), np_of(want_b), atol=1e-6)


def test_cpu_render_takes_no_kernel():
    """A CPU render and its backward run the plain blend under autograd:
    neither kernel's count moves."""
    before = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES)
    _torch_grads("1")
    assert (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES) == before


def _assert_k2_bars(got_f, got_b, want_f, want_b):
    """K2's bars against a reference: per feature column, at least 99.9 %
    of entries within atol 1e-5 + rtol 1e-3 and ||d|| / ||g_ref|| <= 1e-4;
    the radius column exactly 0; grad_bg rtol 1e-4."""
    for c in range(9):
        d = (got_f[:, c] - want_f[:, c]).abs()
        within = d <= 1e-5 + 1e-3 * want_f[:, c].abs()
        assert float(within.float().mean()) >= 0.999, c
        assert float(d.norm()) <= 1e-4 * float(want_f[:, c].norm()) + 1e-12, c
    assert float(got_f[:, 9].abs().max()) == 0.0
    np.testing.assert_allclose(np_of(got_b), np_of(want_b), rtol=1e-4)


def _k2_on_card(name, device, budget=BUDGET, scene=None):
    """K1 then K2 on the card, and plain_blend_bwd on the same bins."""
    feat, bins, bg, g = _bins_and_grad(name, device, budget, scene)
    _, log_t, n_walked, walked = cuda_blend.blend_fwd(
        feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H)
    args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H, g)
    got = cuda_blend.blend_bwd(*args, log_t, n_walked)
    want = plain_blend_bwd(*args)
    torch.cuda.synchronize()
    assert int(n_walked.max()) <= int(walked.max())
    return got, want, (args, log_t, n_walked)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["2", "saturating"])
def test_k2_matches_plain_on_card(cuda_device, name):
    """K2 (with its atomics onto the Gaussians) against plain_blend_bwd on
    the card, within _assert_k2_bars: the sums run in another order, the
    atomics add in an order that is not fixed, and a pair at the T_EPS
    threshold may flip."""
    (got_f, got_b), (want_f, want_b), _ = _k2_on_card(name, cuda_device)
    _assert_k2_bars(got_f, got_b, want_f, want_b)


@pytest.mark.cuda
def test_k2_leaves_the_padding_gaussian_alone(cuda_device):
    """A budget far above demand fills the list's unused slots with
    Gaussian 0; with Gaussian 0 off screen its gradient is the plain
    version's (zero), bit for bit: K2 reads and writes no padding slot."""
    scene = make_scene(n=300, seed=2)
    scene["means"][0] = (40.0, 0.0, 4.0)      # far right of the image
    (got_f, got_b), (want_f, want_b), (args, _, _) = _k2_on_card(
        "2", cuda_device, budget=16 * BUDGET, scene=scene)
    bins_slots = args[1].shape[0]
    listed = int((args[3] - args[2]).sum())
    assert bins_slots - listed > 10 * listed, "most slots must be padding"
    assert torch.equal(got_f[0], want_f[0])
    assert float(got_f[0].abs().max()) == 0.0
    assert float(got_f[:, 9].abs().max()) == 0.0
    _assert_k2_bars(got_f, got_b, want_f, want_b)


@pytest.mark.cuda
def test_k2_two_calls_agree(cuda_device):
    """The atomics make K2 not bit-reproducible; two calls on the same
    inputs agree within the bars K2 is held to against plain."""
    (f1, b1), _, (args, log_t, n_walked) = _k2_on_card("2", cuda_device)
    f2, b2 = cuda_blend.blend_bwd(*args, log_t, n_walked)
    torch.cuda.synchronize()
    _assert_k2_bars(f2, b2, f1, b1)
