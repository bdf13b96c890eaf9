"""The blend's POWER_MXU mode against hugs_tpu's, same numpy inputs.

hugs_tpu/render/pallas_blend.py's mode evaluates the Gaussian exponent as
one matrix product of a recentred bf16 pixel basis and per-instance
coefficients split into three bf16 terms (`_grid_basis`, `_power_mxu`,
`_chunk_alpha(basis=...)`); the port's plain version is
render/blend.py's `grid_basis`, `mxu_coefficients`, `power_mxu` and
`alpha_mxu`, and its kernels' mode is K1's and K2's (card tests).

- The basis equals `_grid_basis(16)` exactly, and its lo half is zero
  (the kernels leave its passes out). The coefficient split and the grid
  index, read off `_power_mxu` itself through a selector basis (its
  output is then c1 + c2 per row, or c1 + c2 + c3), equal the port's
  exactly; the power of a random chunk (means inside and outside the
  tile) agrees to atol 1e-5 + rtol 1e-6 (the products are exact and
  only the float32 sums' order may differ).
- render(power_mxu=True) against hugs_tpu's render(backend="pallas",
  tile=16, power_mxu=True) in interpret mode, on test_pallas_blend.py's
  64x48 scene (seeds 0 and 1): images atol 2e-5, and the same bar
  against hugs_tpu's exact `tiled` backend.
- The gradients of a mean squared error with respect to means, scales,
  rotations, opacities and SH against hugs_tpu's mode: atol 1e-6 + rtol
  1e-4 per entry, tighter than test_pallas_gradients_mxu_mode's 1e-4 +
  1e-4 max|g|, which they are also held to. The plain mode's derivative
  is the mode's K2's (alpha_mxu): autograd through the bf16 split, or
  through min(power, 0), fails these tests.
- micro/kernel_parity.py's gather scene (a feature table and lists built
  by hand) holds what it is for: warps keeping every third slot, groups
  of 8 kept instances across 32-slot windows and over all four grid
  points, means outside the tile, pixels that saturate part-way through
  a group as K1 and K2 group their kept instances; the plain mode on it
  against hugs_tpu's blend_tiles_pallas(power_mxu=True) in interpret mode
  (the image at 2e-5, the gradients with respect to the feature table at
  atol 1e-6 + rtol 1e-4).
- On the card (marked cuda): K1 and K2 in the mode against the plain
  mode at chip_smoke.py phase 3k (a)'s bars, on a rendered scene and on
  the gather scene, and K1 and K2 agreeing on every alpha: K2 rebuilds
  each pixel's first transmittance T_0 from K1's final log T and its own
  alphas, which must give 1.
JAX's interpret-mode results are computed once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.render import pallas_blend as jpb
from hugs_tpu.render import render as jax_render
from hugs_tpu_torch.micro import kernel_parity as kp
from hugs_tpu_torch.render import cuda_blend, render
from hugs_tpu_torch.render.blend import (
    POW_EPS, alpha_mxu, gauss_features, grid_basis, mxu_coefficients,
    plain_blend, plain_blend_bwd, power_mxu,
)
from hugs_tpu_torch.render.oracle import LOG_TEPS
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import bin_gaussians
from torch_parity import (  # noqa: F401 (fixtures)
    H, W, cameras, cuda_device, few_threads, make_scene, np_of, to_jax,
    to_torch,
)

ARGS = ("means", "scales", "rotq", "opacity", "shs")
BG = np.array([0.2, 0.3, 0.4], np.float32)
BUDGET = 16384
IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _target():
    return np.random.default_rng(7).uniform(size=(3, H, W)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_mode(seed):
    """hugs_tpu's mode (Pallas in interpret mode, 16-px tiles): the image
    and the gradients of the mean squared error, and its exact `tiled`
    image."""
    jc, _ = cameras()
    js = to_jax(make_scene(n=300, seed=seed))
    kw = dict(camera=jc, width=W, height=H, bg=jnp.asarray(BG),
              active_sh_degree=3, instance_budget=BUDGET)
    target = jnp.asarray(_target())

    def loss(*a):
        img = jax_render(*a, backend="pallas", tile=16, power_mxu=True,
                         **kw)["render"]
        return jnp.mean((img - target) ** 2), img

    f = _jax_vg(loss)
    (_, img), grads = f(*(js[a] for a in ARGS))
    exact = jax_render(*(js[a] for a in ARGS), backend="tiled",
                       tile_cap=2048, **kw)["render"]
    return np.asarray(img), [np.asarray(g) for g in grads], np.asarray(exact)


def _jax_vg(loss):
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True))


def _port_mode(seed, **kw):
    """The port's render(power_mxu=True) on the CPU and the gradients of
    the same loss."""
    _, tc = cameras()
    ts = {k: v.clone().requires_grad_(True)
          for k, v in to_torch(make_scene(n=300, seed=seed)).items()}
    out = render(*(ts[a] for a in ARGS), tc, W, H, bg=torch.as_tensor(BG),
                 active_sh_degree=3, instance_budget=BUDGET, **kw)
    loss = torch.mean((out["render"] - torch.as_tensor(_target())) ** 2)
    grads = torch.autograd.grad(loss, [ts[a] for a in ARGS])
    return np_of(out["render"]), [np_of(g) for g in grads], out


def _chunk(seed, n=128, tx0=32.0, ty0=16.0):
    """A random chunk: means over the tile and 20 pixels around it,
    positive-definite conics over two decades."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(tx0 - 20, tx0 + 36, n)
    my = rng.uniform(ty0 - 20, ty0 + 36, n)
    ca = np.exp(rng.uniform(np.log(0.01), np.log(2.0), n))
    cc = np.exp(rng.uniform(np.log(0.01), np.log(2.0), n))
    cb = rng.uniform(-0.95, 0.95, n) * np.sqrt(ca * cc)
    chunk = np.zeros((jpb.N_FEAT, n), np.float32)
    for row, v in ((jpb.F_MX, mx), (jpb.F_MY, my), (jpb.F_CA, ca),
                   (jpb.F_CB, cb), (jpb.F_CC, cc)):
        chunk[row] = v
    feat = torch.zeros((n, 10))
    for col, row in ((4, jpb.F_MX), (5, jpb.F_MY), (6, jpb.F_CA),
                     (7, jpb.F_CB), (8, jpb.F_CC)):
        feat[:, col] = torch.as_tensor(chunk[row])
    return chunk, feat, tx0, ty0


def _jax_power(chunk, basis, tx0, ty0):
    return np.asarray(jpb._power_mxu(jnp.asarray(chunk), basis,
                                     jnp.float32(tx0), jnp.float32(ty0), 16))


def test_grid_basis_matches_jax():
    hi, lo = jpb._grid_basis(16)
    thi, tlo = grid_basis(16)
    assert tuple(thi.shape) == (32, 256) and thi.dtype == torch.bfloat16
    np.testing.assert_array_equal(thi.float().numpy(),
                                  np.asarray(hi.astype(jnp.float32)))
    np.testing.assert_array_equal(tlo.float().numpy(),
                                  np.asarray(lo.astype(jnp.float32)))
    # every entry an integer of at most 144: exact in bf16, lo zero
    assert float(thi.float().abs().max()) == 144.0
    assert float(tlo.float().abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_coefficients_and_power_match_jax(seed):
    chunk, feat, tx0, ty0 = _chunk(seed)
    gi, (c1, c2, c3) = mxu_coefficients(feat, tx0, ty0)
    eye = jnp.eye(32, dtype=jnp.bfloat16)
    zero = jnp.zeros((32, 32), jnp.bfloat16)
    # with the selector basis, row k of the output is c1 + c2 (+ c3) of
    # row k of each instance's coefficients, summed in float32 in order
    s12 = _jax_power(chunk, (zero, eye), tx0, ty0)
    s123 = _jax_power(chunk, (eye, zero), tx0, ty0)
    np.testing.assert_array_equal((c1.float() + c2.float()).T.numpy(), s12)
    np.testing.assert_array_equal(
        (c1.float() + c2.float() + c3.float()).T.numpy(), s123)
    # the grid point: the instance's six rows
    rows = np.abs(s123) > 0
    assert (rows.sum(0) == 6).all()
    np.testing.assert_array_equal(gi.numpy(), rows.argmax(0) // 6)
    assert len(set(gi.tolist())) == 4        # every grid point used
    # the power at the tile's 256 pixels
    want = _jax_power(chunk, jpb._grid_basis(16), tx0, ty0).T
    got = power_mxu(feat, tx0, ty0, grid_basis(16)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_jax_mode(seed):
    img, _, out = _port_mode(seed, power_mxu=True)
    want, _, exact = _jax_mode(seed)
    assert not bool(out["overflowed"])
    np.testing.assert_allclose(img, want, atol=IMG_ATOL)
    np.testing.assert_allclose(img, exact, atol=IMG_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_match_jax_mode(seed):
    _, grads, _ = _port_mode(seed, power_mxu=True)
    _, want, _ = _jax_mode(seed)
    for k, got, ref in zip(ARGS, grads, want):
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 + 1e-4 * scale, (k, err)     # the mode's bar
        np.testing.assert_allclose(got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=k)


def test_alpha_mxu_derivative_is_k2s():
    """At pairs whose product power lies in (0, POW_EPS], where
    min(power, 0) has no derivative, the mode's K2 takes d alpha / d power
    = alpha (pallas_blend.py:603-613): alpha_mxu's derivative with
    respect to the mean is alpha times the exact quadratic's, and its
    value the product power's."""
    f = torch.tensor([[0, 0, 0, 0.6, 10.3, 7.8, 0.5, 0.1, 0.4, 20.0]])
    f = f.requires_grad_(True)
    px = torch.tensor([[9.0, 10.0, 11.0]])
    py = torch.tensor([[7.0, 8.0, 9.0]])
    power = torch.tensor([[5e-5, -0.25, POW_EPS]])   # the product's values
    a = alpha_mxu(f, f[:, 3], px, py, power)
    np.testing.assert_allclose(
        np_of(a), [[0.6, 0.6 * float(np.exp(-0.25)), 0.6]], rtol=1e-6)
    (g,) = torch.autograd.grad(a.sum(), f)
    a = a.detach()
    dx, dy = 10.3 - px, 7.8 - py
    want = (a * -(0.5 * dx + 0.1 * dy)).sum()
    np.testing.assert_allclose(float(g[0, 4]), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(g[0, 3]), float((a / 0.6).sum()),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 2])
def test_warp_cull_drops_nothing_the_mode_keeps(seed):
    """The warp cull proves alpha < 1/255 over a warp's 16x2 pixels from
    the exact exponent with a 0.999 margin; no (warp, instance) pair it
    drops reaches 1/255 in the mode (micro.mxu_cull_misses, the count
    chip_smoke.py phase 3k takes on the card's frames)."""
    from hugs_tpu_torch.micro import mxu_cull_misses
    feat, bins, bg, _ = _bins_and_grad("cpu", seed=seed)
    n_walked = plain_blend(feat, bins.gauss_id, bins.starts, bins.ends, bg,
                           W, H, power_mxu=True)[2][0].int()
    got = mxu_cull_misses(feat, bins, n_walked, W, H)
    assert got["dropped"] > 1000 and got["missed"] == 0


def test_render_default_is_the_module_flag(monkeypatch):
    """render(power_mxu=None) follows cuda_blend.POWER_MXU (from
    HUGS_POWER_MXU, off unless set); the mode's CPU path launches no
    kernel."""
    assert cuda_blend.POWER_MXU is False
    before = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES,
              cuda_blend.MXU_LAUNCHES, cuda_blend.K2_MXU_LAUNCHES)
    mode, _, _ = _port_mode(1, power_mxu=True)
    exact, _, _ = _port_mode(1)
    monkeypatch.setattr(cuda_blend, "POWER_MXU", True)
    default, _, _ = _port_mode(1)
    np.testing.assert_array_equal(default, mode)
    assert not np.array_equal(mode, exact)
    assert (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES,
            cuda_blend.MXU_LAUNCHES, cuda_blend.K2_MXU_LAUNCHES) == before


def test_mode_launchers_refuse_cpu_tensors():
    feat, bins, bg, g = _bins_and_grad("cpu")
    args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blend.blend_fwd(*args, power_mxu=True)
    log_t = torch.zeros((H, W))
    n_walked = torch.zeros((H, W), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blend.blend_bwd(*args, g, log_t, n_walked, power_mxu=True)


def _bins_and_grad(device, seed=2, w=W, h=H):
    _, tc = cameras()
    tc = type(tc)(*(x.to(device) for x in tc))
    ts = {k: v.to(device)
          for k, v in to_torch(make_scene(n=300, seed=seed)).items()}
    pg = project_gaussians(*(ts[a] for a in ARGS), tc, w, h, 3)
    bins = bin_gaussians(pg, w, h, BUDGET)
    rng = np.random.default_rng(11)
    g = rng.normal(size=(3, h, w)).astype(np.float32) * (2.0 / (3 * h * w))
    return (gauss_features(pg).detach().contiguous(), bins,
            torch.as_tensor(BG, device=device),
            torch.as_tensor(g, device=device))


def _gather(device):
    """kernel_parity's gather scene on `device`: feat (N, 10), its bins,
    the background and the loss's target."""
    inp = kp.gather_inputs()
    return (torch.as_tensor(inp["feat"], device=device),
            kp.gather_bins(inp, device),
            torch.as_tensor(inp["bg"], device=device),
            torch.as_tensor(inp["target"], device=device))


def _groups(kept, batch, back, walk):
    """The mode's groups of one warp, as its kernel forms them: its kept
    slots of each batch of `batch` below `walk`, in list order (back to
    front with `back`), cut into runs of 8."""
    out = []
    for b0 in range(0, walk, batch):
        ks = [i for i in kept if b0 <= i < min(b0 + batch, walk)]
        ks = ks[::-1] if back else ks
        out += [ks[i:i + 8] for i in range(0, len(ks), 8)]
    return out


def test_gather_scene_stresses_the_grouping():
    """The gather scene, per tile and warp (the warp cull's own keep on
    the CPU): warps 0, 3 and 6 keep every third of slots 0-383; in K1's
    groups (batches of 256, front to back) and K2's (batches of 128 below
    the warp's walk, back to front) some group spans two 32-slot windows
    and some all four grid points; some mean lies outside the tile on
    each side; some pixel saturates at an instance that is neither the
    last of its K1 group nor of its K2 group; most pixels stay
    unsaturated (the alpha agreement test reads those)."""
    feat, bins, bg, _ = _gather("cpu")
    w, h = kp.GATHER_W, kp.GATHER_H
    _, log_t, pairs = plain_blend(feat, bins.gauss_id, bins.starts,
                                  bins.ends, bg, w, h, power_mxu=True)
    assert float((log_t >= LOG_TEPS).float().mean()) > 0.8
    n = kp.GATHER_LIST
    for t in range(2):
        f = feat[bins.gauss_id[t * n:(t + 1) * n].long()]
        tx0 = 16.0 * t
        grid = (torch.clamp(torch.floor(f[:, 5] / 8), 0, 1) * 2
                + torch.clamp(torch.floor((f[:, 4] - tx0) / 8), 0, 1))
        for side in (f[:, 4] < tx0, f[:, 4] >= tx0 + 16, f[:, 5] < 0,
                     f[:, 5] >= 16):
            assert int(side.sum()) > 0
        found = {"straddle": 0, "four": 0, "mid": 0}
        for warp in range(8):
            keep = cuda_blend.warp_cull(
                feat, bins.gauss_id[t * n:(t + 1) * n],
                torch.full((n,), t, dtype=torch.int32),
                torch.full((n,), warp, dtype=torch.int32))
            kept = torch.nonzero(keep)[:, 0].tolist()
            if warp in (0, 3, 6):
                assert keep[:384].tolist() == [
                    i % 3 == warp // 3 for i in range(384)], warp
            rows = slice(2 * warp, 2 * warp + 2)
            cols = slice(16 * t, 16 * t + 16)
            walked = pairs[0][rows, cols].reshape(-1)
            saturated = (log_t[rows, cols] < LOG_TEPS).reshape(-1)
            sat_at = set((walked[saturated] - 1).tolist())
            mid = {0: set(), 1: set()}
            for k, (batch, back) in enumerate(((256, False), (128, True))):
                for g in _groups(kept, batch, back, int(walked.max())):
                    found["straddle"] += len({i // 32 for i in g}) > 1
                    found["four"] += len({int(grid[i]) for i in g}) == 4
                    mid[k] |= set(g[:-1]) & sat_at
            found["mid"] += len(mid[0] & mid[1])
        assert all(v > 0 for v in found.values()), (t, found)


def test_mxu_groups_counts_the_kernels_groups():
    """micro.mxu_groups on the gather scene against the groups written
    out per tile and warp: K1's of each 256-slot batch its warp enters,
    front to back, run while their first instance lies within the warp's
    walk; K2's of each 128-slot batch below the walk, back to front;
    each 12 mma; the columns filled; the groups within one row of grid
    points."""
    from hugs_tpu_torch.micro import mxu_groups
    feat, bins, bg, _ = _gather("cpu")
    w, h = kp.GATHER_W, kp.GATHER_H
    pairs = plain_blend(feat, bins.gauss_id, bins.starts, bins.ends, bg, w,
                        h, power_mxu=True)[2]
    got = mxu_groups(feat, bins, pairs[0].to(torch.int32), w, h)
    n = kp.GATHER_LIST
    want = {k: [] for k in ("K1", "K2")}
    for t in range(2):
        gid = bins.gauss_id[t * n:(t + 1) * n]
        row = torch.clamp(torch.floor(feat[gid.long(), 5] / 8), 0, 1)
        for warp in range(8):
            kept = torch.nonzero(cuda_blend.warp_cull(
                feat, gid, torch.full((n,), t, dtype=torch.int32),
                torch.full((n,), warp, dtype=torch.int32)))[:, 0].tolist()
            walk = int(pairs[0][2 * warp:2 * warp + 2,
                                16 * t:16 * t + 16].max())
            # each group as (its size, whether one row of grid points
            # holds it)
            for k, groups in (
                    ("K1", [g for g in _groups(kept, 256, False, n)
                            if g[0] < walk]),
                    ("K2", _groups(kept, 128, True, walk))):
                want[k] += [(len(g), len({int(row[i]) for i in g}) == 1)
                            for g in groups]
    for k, groups in want.items():
        assert got[k] == len(groups) > 0
        assert got[k + "_mma"] == 12 * len(groups)
        assert got[k + "_fill"] == pytest.approx(
            sum(m for m, _ in groups) / (8 * len(groups)))
        assert got[k + "_one_step"] == pytest.approx(
            sum(one for _, one in groups) / len(groups))
    assert got["K1_staged"] == got["K2_staged"] == 2 * n


@functools.lru_cache(maxsize=None)
def _jax_gather():
    """hugs_tpu's Pallas blend in the mode (interpret mode) on the gather
    scene: the image and the gradient of the L1 loss with respect to the
    feature table (10, N)."""
    from hugs_tpu.render.project import ProjectedGaussians
    from hugs_tpu.render.tiles import TileBins
    inp = kp.gather_inputs()
    n = inp["feat"].shape[0]
    total = jnp.int32(n)
    bins = TileBins(jnp.asarray(inp["gauss_id"]), jnp.asarray(inp["starts"]),
                    jnp.asarray(inp["ends"]), total, total, jnp.bool_(False),
                    total)
    target = jnp.asarray(inp["target"])

    def loss(ft):
        pg = ProjectedGaussians(
            mean2d=ft[4:6].T, conic=ft[6:9].T, depth=jnp.zeros(n),
            radius=ft[9], rgb=ft[0:3].T, opacity=ft[3],
            mask=jnp.ones(n, bool), feat=ft)
        img = jpb.blend_tiles_pallas(pg, bins, inp["W"], inp["H"],
                                     jnp.asarray(inp["bg"]), tile=16,
                                     power_mxu=True)
        return jnp.mean(jnp.abs(img - target)), img

    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(inp["feat"].T))
    return np.asarray(img), np.asarray(g).T


def test_gather_scene_matches_jax_mode():
    feat, bins, bg, target = _gather("cpu")
    feat = feat.requires_grad_(True)
    img = cuda_blend.blend_feat(feat, bins.gauss_id, bins.starts, bins.ends,
                                bg, kp.GATHER_W, kp.GATHER_H, power_mxu=True)
    (g,) = torch.autograd.grad(torch.mean(torch.abs(img - target)), feat)
    want_img, want_g = _jax_gather()
    np.testing.assert_allclose(np_of(img), want_img, atol=IMG_ATOL)
    assert np.abs(want_g[:, :9]).max() > 0
    np.testing.assert_allclose(np_of(g)[:, :9], want_g[:, :9],
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _hold_mxu_kernels(feat, bins, bg, g, w, h):
    """K1 and K2 in the mode against the plain mode at phase 3k (a)'s
    bars, each launch counted as the mode's."""
    args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, w, h)
    before = (cuda_blend.LAUNCHES, cuda_blend.MXU_LAUNCHES,
              cuda_blend.K2_LAUNCHES, cuda_blend.K2_MXU_LAUNCHES)
    img, log_t, n_walked, _ = cuda_blend.blend_fwd(*args, power_mxu=True)
    got_f, got_b = cuda_blend.blend_bwd(*args, g, log_t, n_walked,
                                        power_mxu=True)
    torch.cuda.synchronize()
    assert (cuda_blend.LAUNCHES, cuda_blend.MXU_LAUNCHES,
            cuda_blend.K2_LAUNCHES, cuda_blend.K2_MXU_LAUNCHES) == (
        before[0], before[1] + 1, before[2], before[3] + 1)
    ref = plain_blend(*args, power_mxu=True)[0]
    share = float(((img - ref).abs().amax(0) <= IMG_ATOL).float().mean())
    assert share >= 0.9999
    want_f, want_b = plain_blend_bwd(*args, g, power_mxu=True)
    for c in range(9):
        d = (got_f[:, c] - want_f[:, c]).abs()
        within = d <= 1e-5 + 1e-3 * want_f[:, c].abs()
        assert float(within.float().mean()) >= 0.999, c
        assert float(d.norm()) <= 1e-4 * float(want_f[:, c].norm()) + 1e-12
    assert float(got_f[:, 9].abs().max()) == 0.0
    np.testing.assert_allclose(np_of(got_b), np_of(want_b), rtol=5e-4)


@pytest.mark.cuda
def test_mxu_kernels_match_plain_mode_on_gather_scene_on_card(cuda_device):
    """_hold_mxu_kernels on the gather scene, g uniform from a seed."""
    feat, bins, bg, _ = _gather(cuda_device)
    g = torch.as_tensor(np.random.default_rng(11).uniform(
        -1, 1, (3, kp.GATHER_H, kp.GATHER_W)).astype(np.float32),
        device=cuda_device)
    _hold_mxu_kernels(feat, bins, bg, g, kp.GATHER_W, kp.GATHER_H)


@pytest.mark.cuda
def test_mxu_kernels_match_plain_mode_on_card(cuda_device):
    """K1 and K2 in the mode against the plain mode: K1's raw image on at
    least 99.99 % of pixels within 2e-5; K2 per column on at least 99.9 %
    of entries within 1e-5 + 1e-3 |g| with ||d|| / ||g|| <= 1e-4, grad_bg
    within the mode's relative gradient bar 5e-4 (a pixel where a pair at
    the 1/255 cutoff flips moves its T_fin by 1/255); each launch counted
    as the mode's."""
    feat, bins, bg, g = _bins_and_grad(cuda_device)
    _hold_mxu_kernels(feat, bins, bg, g, W, H)


@pytest.mark.cuda
def test_mxu_k1_and_k2_agree_on_alpha_on_card(cuda_device):
    """On a 32x32 frame with colours (1, 0, 0), a zero background and g
    one-hot at one pixel p (red), K2's colour gradient sums to sum_i
    alpha_i T_i = T_0 - T_fin at an unsaturated p, with T_i rebuilt from
    K1's final log T and K2's own alphas: T_0 is 1 only where K2's alphas
    are K1's (a pair at a cutoff that one kernel kept and the other
    dropped moves it by 1/255 or more). Both modes, on a rendered scene
    and on the gather scene (K1 and K2 group the kept instances of a
    warp differently there: front to back in batches of 256, back to
    front in batches of 128)."""
    w = h = 32
    feat, bins, _, _ = _bins_and_grad(cuda_device, seed=4, w=w, h=h)
    scenes = [(feat, bins, w, h),
              (*_gather(cuda_device)[:2], kp.GATHER_W, kp.GATHER_H)]
    for feat, bins, w, h in scenes:
        feat[:, 0:3] = torch.tensor([1.0, 0.0, 0.0], device=cuda_device)
        bg = torch.zeros(3, device=cuda_device)
        args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, w, h)
        for mode in (False, True):
            _, log_t, n_walked, _ = cuda_blend.blend_fwd(*args,
                                                         power_mxu=mode)
            live = log_t >= LOG_TEPS
            assert int(live.sum()) > h * w // 2
            t0 = torch.empty((h, w), device=cuda_device)
            for p in range(h * w):
                g = torch.zeros((3, h, w), device=cuda_device)
                g[0].view(-1)[p] = 1.0
                gf, _ = cuda_blend.blend_bwd(*args, g, log_t, n_walked,
                                             power_mxu=mode)
                t0.view(-1)[p] = gf[:, 0].sum()
            t0 = t0 + torch.exp(log_t)
            torch.cuda.synchronize()
            assert float((t0 - 1.0)[live].abs().max()) <= 1e-5, (w, mode)
