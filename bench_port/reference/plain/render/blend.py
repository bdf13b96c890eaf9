"""Tiled alpha-blend compositing, plain PyTorch.

The reference for the CUDA blend kernels (render/cuda_blend.py), forward
(`plain_blend`) and backward (`plain_blend_bwd`), and the path a render
takes on the CPU. Each tile evaluates a dense (K, P) alpha
matrix over its depth-sorted instance list (K instances, P pixels),
takes an exclusive log-space cumsum along K for transmittance and
contracts colours against the weights; oracle.py states the semantics.
Differentiable through autograd.

`power_mxu=True` takes the exponent from the POWER_MXU mode of
hugs_tpu/render/pallas_blend.py (`_grid_basis`, `_power_mxu` and
`_chunk_alpha(basis=...)`, :116-188 and :279-313): the Gaussian's
power at a pixel, a quadratic in the pixel's coordinates, as one matrix
product of a bf16 basis over tile-local pixel coordinates recentred to
a grid point (every 8 pixels) and a (K, instances) matrix of per-
instance coefficients split into three bf16 terms, accumulated in
float32; the `power <= 0` guard widens to `power <= POW_EPS`. The radius
and 1/255 tests keep their exact forms, and the gradient is the mode's
K2's (`alpha_mxu`).
"""
from __future__ import annotations

import torch

from bench_port.reference.plain.render.oracle import (
    LOG_TEPS, MAX_ALPHA, MIN_ALPHA, gaussian_alpha,
)
from bench_port.reference.plain.render.project import ProjectedGaussians
from bench_port.reference.plain.render.tiles import TILE, tile_grid, tile_wh

N_FEAT = 10           # per-Gaussian rows: r g b op mx my ca cb cc rad
_PAIRS_PER_BATCH = 1 << 24   # (instance, pixel) pairs per batch of tiles
GRID_SP = 8           # the POWER_MXU mode's recentring grid spacing (pixels)
POW_EPS = 1e-4        # its widened `power <= 0` guard (pallas_blend._POW_EPS)


def gauss_features(pg: ProjectedGaussians) -> torch.Tensor:
    """(N, 10) float32 per-Gaussian table, columns r g b, opacity (zero
    where culled), mean x y, conic a b c, radius: the layout the CUDA
    blend gathers from."""
    opac = torch.where(pg.mask, pg.opacity, 0.0)
    return torch.cat([pg.rgb, opac[:, None], pg.mean2d, pg.conic,
                      pg.radius[:, None]], dim=1).contiguous()


def grid_basis(tile=TILE, device=None):
    """The POWER_MXU mode's pixel basis: (K, P) bf16 hi and lo, as
    hugs_tpu's `_grid_basis`. Row 6 g + s, for grid point g = gy ngx + gx
    at tile-local (8 gx + 4, 8 gy + 4), holds term s of [1, u', v', u'^2,
    v'^2, u'v'], u' and v' the row-major pixel's tile-local coordinates
    relative to the grid point; rows past 6 ngx ngy are zero, K the rows
    rounded up to 32. Every entry is an integer below 2^10, so hi + lo is
    exact (at a 16-pixel tile every entry is at most 144 and lo is
    zero)."""
    tw, th = tile_wh(tile)
    ngx, ngy = tw // GRID_SP, th // GRID_SP
    k_rows = -(-6 * ngx * ngy // 32) * 32
    r = torch.arange(k_rows, device=device)[:, None]
    p = torch.arange(tw * th, device=device)[None, :]
    g = r // 6
    sub = r - 6 * g
    u = ((p % tw) - ((g % ngx) * GRID_SP + GRID_SP // 2)).float()
    v = ((p // tw) - ((g // ngx) * GRID_SP + GRID_SP // 2)).float()
    val = torch.where(sub == 0, 1.0,
          torch.where(sub == 1, u,
          torch.where(sub == 2, v,
          torch.where(sub == 3, u * u,
          torch.where(sub == 4, v * v, u * v)))))
    val = torch.where(g < ngx * ngy, val, 0.0)
    hi = val.to(torch.bfloat16)
    lo = (val - hi.float()).to(torch.bfloat16)
    return hi, lo


def mxu_coefficients(f: torch.Tensor, tx0, ty0, tile=TILE):
    """The POWER_MXU mode's coefficients of instances with feature rows f
    (..., 10) in the tile whose top-left pixel is (tx0, ty0)
    (broadcastable to f[..., 0]), as hugs_tpu's `_power_mxu` forms them:
    each instance's grid point g (floor of its tile-local mean over 8,
    clipped to the tile's grid, so a mean outside the tile keeps a
    residual beyond 4 pixels: pallas_blend.py:94-104), and its (..., K)
    column [a0, bu, bv, -ca/2, -cc/2, -cb] in rows 6 g .. 6 g + 5, zero
    elsewhere, split into three bf16 terms c1 + c2 + c3. Returns (g,
    (c1, c2, c3))."""
    tw, th = tile_wh(tile)
    ngx, ngy = tw // GRID_SP, th // GRID_SP
    k_rows = -(-6 * ngx * ngy // 32) * 32
    mx, my = f[..., 4], f[..., 5]
    ca, cb, cc = f[..., 6], f[..., 7], f[..., 8]
    mxl = mx - tx0                                  # tile-local mean
    myl = my - ty0
    gx = torch.clamp(torch.floor(mxl * (1.0 / GRID_SP)), 0, ngx - 1)
    gy = torch.clamp(torch.floor(myl * (1.0 / GRID_SP)), 0, ngy - 1)
    gi = (gy * ngx + gx).to(torch.int64)
    rx = mxl - (gx * GRID_SP + GRID_SP // 2)        # mean - grid point
    ry = myl - (gy * GRID_SP + GRID_SP // 2)
    a0 = -0.5 * (ca * rx * rx + cc * ry * ry) - cb * rx * ry
    bu = ca * rx + cb * ry
    bv = cc * ry + cb * rx
    six = torch.stack([a0, bu, bv, -0.5 * ca, -0.5 * cc, -cb], dim=-1)
    r = torch.arange(k_rows, device=f.device)
    g = r // 6
    sub = (r - 6 * g).clamp(max=5)
    cof = torch.where(g == gi[..., None], six[..., sub], 0.0)   # (..., K)
    c1 = cof.to(torch.bfloat16)
    rem = cof - c1.float()
    c2 = rem.to(torch.bfloat16)
    c3 = (rem - c2.float()).to(torch.bfloat16)
    return gi, (c1, c2, c3)


def power_mxu(f: torch.Tensor, tx0, ty0, basis, tile=TILE) -> torch.Tensor:
    """The POWER_MXU mode's exponent (..., I, P) of instances f (..., I,
    10) at the tile's P pixels: bh c1 + bh c2 + bh c3 + bl c1 + bl c2,
    each a float32 product of bf16 terms over the K rows, summed in that
    order (hugs_tpu's `_power_mxu`; its dropped bl c3 is below 2^-27
    relative). basis: grid_basis's (hi, lo)."""
    bh, bl = (b.float() for b in basis)
    _, (c1, c2, c3) = mxu_coefficients(f, tx0, ty0, tile)
    c1, c2, c3 = c1.float(), c2.float(), c3.float()
    return (c1 @ bh + c2 @ bh + c3 @ bh + c1 @ bl + c2 @ bl)


def alpha_mxu(f: torch.Tensor, opac: torch.Tensor, px, py,
              power: torch.Tensor) -> torch.Tensor:
    """alpha (..., I, P) in the POWER_MXU mode from its exponent `power`:
    min(0.99, op exp(min(power, 0))), zero unless power <= POW_EPS, alpha
    >= 1/255 and dist^2 <= radius^2 (hugs_tpu's `_chunk_alpha` with a
    basis). The value is the product's; the derivative is the mode's K2's
    (pallas_blend.py:589-613): the power's from the exact quadratic in
    the mean and conic, and d alpha / d power = alpha wherever the pair
    is kept and alpha < 0.99, also for 0 < power <= POW_EPS, where
    min(power, 0) would give 0. Autograd through the product would take
    the bf16 casts' rounded gradient instead."""
    mx, my = f[..., 4, None], f[..., 5, None]
    ca, cb, cc = f[..., 6, None], f[..., 7, None], f[..., 8, None]
    dx = mx - px
    dy = my - py
    exact = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    # the product's value (+ an exact zero), the exact power's derivative
    power = power.detach() + (exact - exact.detach())
    e0 = torch.exp(torch.clamp(power.detach(), max=0.0))
    e = e0 + e0 * (power - power.detach())      # exp(min(power, 0)), de = e
    alpha = torch.clamp(opac[..., None] * e, max=MAX_ALPHA)
    rad = f[..., 9, None]
    keep = (power <= POW_EPS) & (alpha >= MIN_ALPHA) \
        & (dx * dx + dy * dy <= rad * rad)
    return torch.where(keep, alpha, 0.0)


def _tile_batches(gauss_id, starts, ends, width, height, tile_cap, tile):
    """The batches of tiles the plain blend walks, each at most
    _PAIRS_PER_BATCH (instance, pixel) pairs. Without tile_cap, tiles go
    densest first and a batch pads its tiles to its own largest count,
    so that sparse tiles do not pay for the densest one; with tile_cap,
    in order, each padded to tile_cap. Yields (t, g, live, px, py): tile
    ids (B,), Gaussian ids (B, K), valid-instance mask (B, K) and pixel
    centres (B, P)."""
    dev = gauss_id.device
    nx, ny = tile_grid(width, height, tile)
    tw, th = tile_wh(tile)
    T, P = nx * ny, tw * th
    counts = (ends - starts).to(torch.int64)
    if tile_cap is None:
        order = torch.argsort(counts, descending=True, stable=True)
        ks = counts[order].clamp(min=1).tolist()
    else:
        order = torch.arange(T, device=dev)
        ks = [max(int(tile_cap), 1)] * T
    # pad so that start + k never leaves the array
    gid_pad = torch.cat([gauss_id.to(torch.int64),
                         torch.zeros(ks[0] if T else 1, dtype=torch.int64,
                                     device=dev)])
    lin = torch.arange(P, device=dev)
    t0 = 0
    while t0 < T:
        K = ks[t0]
        batch = max(1, min(T - t0, _PAIRS_PER_BATCH // (K * P)))
        t = order[t0:t0 + batch]
        k = torch.arange(K, device=dev)
        live = k[None, :] < counts[t, None]                       # (B, K)
        g = torch.where(live, gid_pad[starts[t].long()[:, None] + k], 0)
        px = ((t % nx) * tw)[:, None] + lin % tw                  # (B, P)
        py = ((t // nx) * th)[:, None] + lin // tw
        yield t, g, live, px.float(), py.float()
        t0 += batch


def _blend_batch(feat, bg, g, live, px, py, mxu=False):
    """One batch of tiles: raw colour (B, 3, P), final log T (B, P), and
    per pixel the instances tested and blended (B, 2, P). mxu: the
    exponent from the POWER_MXU mode (the tile's origin is its pixel 0)."""
    f = feat[g]                                               # (B, K, 10)
    opac = torch.where(live, f[..., 3], 0.0)
    if mxu:
        power = power_mxu(f.detach(), px[:, :1], py[:, :1],
                          grid_basis(TILE, feat.device))      # (B, K, P)
        alpha = alpha_mxu(f, opac, px[:, None, :], py[:, None, :], power)
    else:
        alpha = gaussian_alpha(f[..., None, 4:6], f[..., None, 6:9],
                               opac[..., None], px[:, None, :],
                               py[:, None, :],
                               radius=f[..., None, 9])        # (B, K, P)
    log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
    excl = torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]], dim=1)
    tested = excl >= LOG_TEPS
    w = alpha * torch.exp(excl) * tested
    color = torch.einsum("bkc,bkp->bcp", f[..., 0:3], w)
    final = log_t[:, -1]                                      # (B, P)
    final_t = torch.exp(final) * (final >= LOG_TEPS)
    pairs = torch.stack([(tested & live[..., None]).sum(1),
                         (tested & (alpha > 0)).sum(1)], dim=1)
    return color + bg[None, :, None] * final_t[:, None, :], final, pairs


def _assemble(tiles, width, height, tile):
    """(T, C, P) per-tile rows -> (C, H, W) image."""
    nx, ny = tile_grid(width, height, tile)
    tw, th = tile_wh(tile)
    c = tiles.shape[1]
    img = tiles.reshape(ny, nx, c, th, tw).permute(2, 0, 3, 1, 4)
    return img.reshape(c, ny * th, nx * tw)[:, :height, :width]


def _disassemble(img, tile):
    """(C, H, W) image -> (T, C, P) per-tile rows, zero past the edge."""
    c, height, width = img.shape
    nx, ny = tile_grid(width, height, tile)
    tw, th = tile_wh(tile)
    pad = img.new_zeros((c, ny * th, nx * tw))
    pad[:, :height, :width] = img
    return pad.reshape(c, ny, th, nx, tw).permute(1, 3, 0, 2, 4) \
        .reshape(nx * ny, c, th * tw)


def plain_blend(feat: torch.Tensor, gauss_id: torch.Tensor,
                starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
                width: int, height: int, tile_cap: int | None = None,
                tile=TILE, power_mxu: bool = False):
    """The function the CUDA blend computes, in plain PyTorch.

    feat: (N, 10) from gauss_features; gauss_id/starts/ends: TileBins
    fields. tile_cap truncates each tile's list to its first tile_cap
    instances; None means the largest tile count, which truncates
    nothing. power_mxu: the POWER_MXU mode's exponent (16-pixel tiles,
    as the kernels' mode). Returns
      img   (3, H, W) raw colour, not yet clipped to [0, 1];
      log_t (H, W) final log transmittance, summed over the whole list;
      pairs (2, H, W) int64: per pixel, the instances it tests before
            its transmittance falls below T_EPS (row 0), and those of
            them that blend, with nonzero alpha (row 1).
    """
    if power_mxu and tile_wh(tile) != (TILE, TILE):
        raise ValueError(f"the POWER_MXU mode takes {TILE}-pixel tiles")
    ts, imgs, logts, pairs = [], [], [], []
    for t, g, live, px, py in _tile_batches(gauss_id, starts, ends, width,
                                            height, tile_cap, tile):
        img, final, pr = _blend_batch(feat, bg, g, live, px, py, power_mxu)
        ts.append(t)
        imgs.append(img)
        logts.append(final)
        pairs.append(pr)
    # the batches' tiles back in tile order
    t = torch.cat(ts)
    back = torch.empty_like(t)
    back[t] = torch.arange(t.numel(), device=t.device)
    return (_assemble(torch.cat(imgs)[back], width, height, tile),
            _assemble(torch.cat(logts)[back][:, None], width, height,
                      tile)[0],
            _assemble(torch.cat(pairs)[back], width, height, tile))


def plain_blend_bwd(feat: torch.Tensor, gauss_id: torch.Tensor,
                    starts: torch.Tensor, ends: torch.Tensor,
                    bg: torch.Tensor, width: int, height: int,
                    grad_raw: torch.Tensor, power_mxu: bool = False):
    """The function the CUDA backward blend (K2) computes, in plain
    PyTorch: the gradient of plain_blend's raw colour (in the POWER_MXU
    mode with power_mxu: the mode's K2's gradient, alpha_mxu).

    grad_raw: (3, H, W) d(loss)/d(raw colour). Returns grad_feat (N, 10)
    and grad_bg (3,). Each batch of tiles re-runs its forward under
    autograd and is differentiated alone, so memory holds one batch's
    intermediates, not the whole frame's."""
    grad_feat = torch.zeros_like(feat)
    grad_bg = torch.zeros_like(bg)
    g_tiles = _disassemble(grad_raw.detach(), TILE)
    for t, g, live, px, py in _tile_batches(gauss_id, starts, ends, width,
                                            height, None, TILE):
        with torch.enable_grad():
            f = feat.detach().requires_grad_(True)
            b = bg.detach().requires_grad_(True)
            color = _blend_batch(f, b, g, live, px, py, power_mxu)[0]
            gf, gb = torch.autograd.grad(color, (f, b), g_tiles[t])
        grad_feat += gf
        grad_bg += gb
    return grad_feat, grad_bg
