"""The warp cull of K1 and K2 (render/cuda_blend.py::warp_cull).

Each warp of a 16x16 tile covers a 16x2 rectangle of pixel centres, and
both kernels skip the instances that tiles._tight_cull_keep, evaluated at
that rectangle, drops. That is safe only if a dropped pair has alpha
exactly 0 at every pixel the warp covers:

- safety, on the CPU: over seeded random anisotropic Gaussians and edge
  cases (means on pixel centres and on the rectangle's edges, opacities
  at 1/255 and at 0.99, nearly degenerate conics, radii at the distance
  of the rectangle's nearest corner), every dropped (Gaussian, rectangle)
  pair has oracle.gaussian_alpha(..., radius) == 0 at all 32 pixel
  centres, exactly;
- the port's _tight_cull_keep at tile (16, 2) against hugs_tpu's, on the
  same float32 inputs: equal masks;
- on the card (marked cuda): the kernels' device cull gives the plain
  function's mask, bit for bit (both are built without fused
  multiply-adds and evaluate in one operation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.render.tiles import _tight_cull_keep as jax_cull_keep
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.oracle import MIN_ALPHA, gaussian_alpha
from hugs_tpu_torch.render.tiles import _tight_cull_keep
from torch_parity import cuda_device, np_of  # noqa: F401 (a fixture)

RW, RH = cuda_blend.WARP_RECT
N = 20000


def _gaussians(case, seed=0, n=N):
    """(feat (n, 10) float32, tx, ty): Gaussians about one 16x2 rectangle
    each, at rectangle (tx, ty) of the grid of 16x2 rectangles."""
    rng = np.random.default_rng(seed)
    tx = rng.integers(0, 60, n)
    ty = rng.integers(0, 270, n)
    x0, y0 = (tx * RW).astype(np.float64), (ty * RH).astype(np.float64)
    x1, y1 = x0 + RW - 1, y0 + RH - 1
    mx = rng.uniform(x0 - 24, x1 + 24)
    my = rng.uniform(y0 - 24, y1 + 24)
    theta = rng.uniform(0, np.pi, n)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(10.0), n))
    s2 = np.exp(rng.uniform(np.log(0.3), np.log(10.0), n))
    op = rng.uniform(MIN_ALPHA, 0.99, n)
    if case == "pixel_centres":
        mx, my = np.round(mx), np.round(my)
    elif case == "rect_edges":
        pick = rng.integers(0, 4, n), np.arange(n)
        edge_x = np.stack([x0, x1, x0 - 0.5, x1 + 0.5])[pick]
        edge_y = np.stack([y0, y1, y0 - 0.5, y1 + 0.5])[pick]
        on_x = rng.uniform(size=n) < 0.5
        mx = np.where(on_x, edge_x, mx)
        my = np.where(on_x, my, edge_y)
    elif case == "opacity_min":
        # alpha reaches 1/255 only within a fraction of a pixel of the
        # mean: keep the means at the rectangle
        mx = rng.uniform(x0 - 1, x1 + 1)
        my = rng.uniform(y0 - 1, y1 + 1)
        s1, s2 = 3.0 * s1 + 1.0, 3.0 * s2 + 1.0
        op = MIN_ALPHA * rng.choice([1.0, 1.0005, 1.001, 1.002, 1.01], n)
    elif case == "opacity_max":
        op = rng.choice([0.99, 0.999, 1.0], n)
    elif case == "degenerate_conic":
        s1 = np.exp(rng.uniform(np.log(2.0), np.log(10.0), n))
        s2 = s1 / rng.choice([1e2, 1e3, 3e3], n)
    cos, sin = np.cos(theta), np.sin(theta)
    cxx = cos ** 2 * s1 ** 2 + sin ** 2 * s2 ** 2
    cyy = sin ** 2 * s1 ** 2 + cos ** 2 * s2 ** 2
    cxy = cos * sin * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy ** 2
    ca, cb, cc = cyy / det, -cxy / det, cxx / det
    rad = np.ceil(3.0 * np.maximum(s1, s2)) * rng.uniform(0.3, 1.0, n)
    if case == "corner_radius":
        # the radius at the distance of the rectangle's nearest corner
        # pixel centre, and one float32 ulp either side of it
        cx = np.where(np.abs(mx - x0) < np.abs(mx - x1), x0, x1)
        cy = np.where(np.abs(my - y0) < np.abs(my - y1), y0, y1)
        f32 = np.float32
        dx = cx.astype(f32) - mx.astype(f32)
        dy = cy.astype(f32) - my.astype(f32)
        rad = np.sqrt(dx * dx + dy * dy)
        rad = np.nextafter(rad, rad * rng.choice([0.0, 1.0, 2.0], n),
                           dtype=np.float32)
    if case == "degenerate_conic":
        # exactly singular and slightly indefinite conics too: no ellipse
        # test there, only the disk
        cb = np.where(rng.uniform(size=n) < 0.2,
                      np.sqrt(ca * cc) * rng.choice([1.0, 1.0001], n), cb)
    rgb = rng.uniform(size=(n, 3))
    feat = np.concatenate([rgb, np.stack([op, mx, my, ca, cb, cc, rad], 1)],
                          1).astype(np.float32)
    return feat, tx.astype(np.int32), ty.astype(np.int32)


def _rect_alpha(feat, tx, ty):
    """(n, 32) alpha of each Gaussian at the 32 pixel centres of its
    rectangle, with the blend's cutoffs (radius included)."""
    lin = torch.arange(RW * RH)
    px = (tx.long() * RW)[:, None] + lin % RW
    py = (ty.long() * RH)[:, None] + lin // RW
    f = feat[:, None, :]
    return gaussian_alpha(f[..., 4:6], f[..., 6:9], f[..., 3], px.float(),
                          py.float(), radius=f[..., 9])


CASES = ["seed0", "seed1", "seed2", "seed3", "pixel_centres", "rect_edges",
         "opacity_min", "opacity_max", "degenerate_conic", "corner_radius"]


@pytest.mark.parametrize("case", CASES)
def test_warp_cull_drops_only_pairs_with_zero_alpha(case):
    seed = int(case[4:]) if case.startswith("seed") else len(case)
    feat, tx, ty = (torch.as_tensor(a) for a in _gaussians(case, seed))
    gid = torch.arange(feat.shape[0], dtype=torch.int32)
    keep = cuda_blend.warp_cull(feat, gid, tx, ty)
    alpha = _rect_alpha(feat, tx, ty)
    hit = (alpha > 0).any(dim=1)
    dropped = ~keep
    assert int(dropped.sum()) > 100, "the cull must drop pairs here"
    assert int((keep & hit).sum()) > 100, "and keep pairs that hit"
    assert not bool((dropped & hit).any()), (
        f"{int((dropped & hit).sum())} dropped pairs have alpha > 0")


def test_warp_cull_matches_jax_tight_cull():
    """The same float32 rows through hugs_tpu's _tight_cull_keep at tile
    (16, 2), whose instance table holds them as int32 bit patterns."""
    feat, tx, ty = _gaussians("seed0", 5)
    cols = np.zeros((12, feat.shape[0]), np.int32)
    # hugs_tpu's rows 5-11: mean x y, conic a b c, opacity, radius
    for row, col in zip(range(5, 12), (4, 5, 6, 7, 8, 3, 9)):
        cols[row] = feat[:, col].view(np.int32)
    want = np.asarray(jax_cull_keep(jnp.asarray(cols), jnp.asarray(tx),
                                    jnp.asarray(ty), (RW, RH)))
    got = cuda_blend.warp_cull(torch.as_tensor(feat),
                               torch.arange(feat.shape[0], dtype=torch.int32),
                               torch.as_tensor(tx), torch.as_tensor(ty))
    assert 0 < int(want.sum()) < want.size
    np.testing.assert_array_equal(np_of(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed1", "rect_edges", "opacity_min",
                                  "degenerate_conic", "corner_radius"])
def test_device_warp_cull_matches_plain_on_card(cuda_device, case):
    feat, tx, ty = (torch.as_tensor(a, device=cuda_device)
                    for a in _gaussians(case, 7))
    gid = torch.randperm(feat.shape[0], device=cuda_device).to(torch.int32)
    got = cuda_blend.warp_cull(feat, gid, tx, ty)
    f = feat[gid.long()]
    want = _tight_cull_keep(f[:, 4], f[:, 5], f[:, 6], f[:, 7], f[:, 8],
                            f[:, 3], f[:, 9], tx, ty, (RW, RH))
    torch.cuda.synchronize()
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want)
