"""Tiled alpha-blend compositing, plain PyTorch.

The reference for the CUDA blend kernels (render/cuda_blend.py), forward
(`plain_blend`) and backward (`plain_blend_bwd`), and the path a render
takes on the CPU. Each tile evaluates a dense (K, P) alpha
matrix over its depth-sorted instance list (K instances, P pixels),
takes an exclusive log-space cumsum along K for transmittance and
contracts colours against the weights; oracle.py states the semantics.
Differentiable through autograd.
"""
from __future__ import annotations

import torch

from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01, gaussian_alpha
from hugs_tpu_torch.render.project import ProjectedGaussians
from hugs_tpu_torch.render.tiles import TILE, TileBins, tile_grid, tile_wh

N_FEAT = 10           # per-Gaussian rows: r g b op mx my ca cb cc rad
_PAIRS_PER_BATCH = 1 << 24   # (instance, pixel) pairs per batch of tiles


def gauss_features(pg: ProjectedGaussians) -> torch.Tensor:
    """(N, 10) float32 per-Gaussian table, columns r g b, opacity (zero
    where culled), mean x y, conic a b c, radius: the layout the CUDA
    blend gathers from."""
    opac = torch.where(pg.mask, pg.opacity, 0.0)
    return torch.cat([pg.rgb, opac[:, None], pg.mean2d, pg.conic,
                      pg.radius[:, None]], dim=1).contiguous()


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


def _blend_batch(feat, bg, g, live, px, py):
    """One batch of tiles: raw colour (B, 3, P), final log T (B, P), and
    per pixel the instances tested and blended (B, 2, P)."""
    f = feat[g]                                               # (B, K, 10)
    opac = torch.where(live, f[..., 3], 0.0)
    alpha = gaussian_alpha(f[..., None, 4:6], f[..., None, 6:9],
                           opac[..., None], px[:, None, :], py[:, None, :],
                           radius=f[..., None, 9])            # (B, K, P)
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
                tile=TILE):
    """The function the CUDA blend computes, in plain PyTorch.

    feat: (N, 10) from gauss_features; gauss_id/starts/ends: TileBins
    fields. tile_cap truncates each tile's list to its first tile_cap
    instances; None means the largest tile count, which truncates
    nothing. Returns
      img   (3, H, W) raw colour, not yet clipped to [0, 1];
      log_t (H, W) final log transmittance, summed over the whole list;
      pairs (2, H, W) int64: per pixel, the instances it tests before
            its transmittance falls below T_EPS (row 0), and those of
            them that blend, with nonzero alpha (row 1).
    """
    ts, imgs, logts, pairs = [], [], [], []
    for t, g, live, px, py in _tile_batches(gauss_id, starts, ends, width,
                                            height, tile_cap, tile):
        img, final, pr = _blend_batch(feat, bg, g, live, px, py)
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
                    grad_raw: torch.Tensor):
    """The function the CUDA backward blend (K2) computes, in plain
    PyTorch: the gradient of plain_blend's raw colour.

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
            color = _blend_batch(f, b, g, live, px, py)[0]
            gf, gb = torch.autograd.grad(color, (f, b), g_tiles[t])
        grad_feat += gf
        grad_bg += gb
    return grad_feat, grad_bg


def blend_tiles_plain(pg: ProjectedGaussians, bins: TileBins, width: int,
                      height: int, bg: torch.Tensor,
                      tile_cap: int | None = None,
                      tile=TILE) -> torch.Tensor:
    """Composite all tiles. Returns (3, H, W) in [0, 1]."""
    return clip01(plain_blend(gauss_features(pg), bins.gauss_id, bins.starts,
                              bins.ends, bg, width, height, tile_cap,
                              tile)[0])


def tile_overflow(bins: TileBins, tile_cap: int) -> torch.Tensor:
    """True if any tile's instance list was truncated by tile_cap."""
    return torch.max(bins.ends - bins.starts) > tile_cap
