"""Tiled alpha-blend compositing, plain PyTorch.

The reference for the CUDA forward blend (render/cuda_blend.py) and the
path a render takes on the CPU. Each tile evaluates a dense (K, P) alpha
matrix over its depth-sorted instance list (K instances, P pixels),
takes an exclusive log-space cumsum along K for transmittance and
contracts colours against the weights; oracle.py states the semantics.
Differentiable through autograd.
"""
from __future__ import annotations

import torch

from hugs_tpu_torch.render.oracle import LOG_TEPS, gaussian_alpha
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


def plain_blend(feat: torch.Tensor, gauss_id: torch.Tensor,
                starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
                width: int, height: int, tile_cap: int | None = None,
                tile=TILE):
    """The function the CUDA blend computes, in plain PyTorch.

    feat: (N, 10) from gauss_features; gauss_id/starts/ends: TileBins
    fields. tile_cap truncates each tile's list to its first tile_cap
    instances; None means the largest tile count, which truncates
    nothing. Returns
      img   (3, H, W) clipped to [0, 1];
      log_t (H, W) final log transmittance, summed over the whole list;
      pairs (2, H, W) int64: per pixel, the instances it tests before
            its transmittance falls below T_EPS (row 0), and those of
            them that blend, with nonzero alpha (row 1).
    """
    dev = feat.device
    nx, ny = tile_grid(width, height, tile)
    tw, th = tile_wh(tile)
    T, P = nx * ny, tw * th
    counts = (ends - starts).to(torch.int64)
    K = int(counts.max()) if tile_cap is None else int(tile_cap)
    K = max(K, 1)
    # pad so that start + k never leaves the array
    gid_pad = torch.cat([gauss_id.to(torch.int64),
                         torch.zeros(K, dtype=torch.int64, device=dev)])
    k = torch.arange(K, device=dev)
    lin = torch.arange(P, device=dev)
    batch = max(1, min(T, _PAIRS_PER_BATCH // (K * P)))
    imgs, logts, pairs = [], [], []
    for t0 in range(0, T, batch):
        t = torch.arange(t0, min(t0 + batch, T), device=dev)
        live = k[None, :] < counts[t, None]                       # (B, K)
        g = torch.where(live, gid_pad[starts[t].long()[:, None] + k], 0)
        f = feat[g]                                               # (B, K, 10)
        opac = torch.where(live, f[..., 3], 0.0)
        px = ((t % nx) * tw)[:, None] + lin % tw                  # (B, P)
        py = ((t // nx) * th)[:, None] + lin // tw
        alpha = gaussian_alpha(f[..., None, 4:6], f[..., None, 6:9],
                               opac[..., None], px[:, None, :].float(),
                               py[:, None, :].float(),
                               radius=f[..., None, 9])            # (B, K, P)
        log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
        excl = torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]],
                         dim=1)
        tested = excl >= LOG_TEPS
        w = alpha * torch.exp(excl) * tested
        color = torch.einsum("bkc,bkp->bcp", f[..., 0:3], w)
        final = log_t[:, -1]                                      # (B, P)
        final_t = torch.exp(final) * (final >= LOG_TEPS)
        imgs.append(color + bg[None, :, None] * final_t[:, None, :])
        logts.append(final)
        pairs.append(torch.stack([(tested & live[..., None]).sum(1),
                                  (tested & (alpha > 0)).sum(1)], dim=1))

    def assemble(tiles):                  # (T, C, P) -> (C, H, W)
        c = tiles.shape[1]
        img = tiles.reshape(ny, nx, c, th, tw).permute(2, 0, 3, 1, 4)
        return img.reshape(c, ny * th, nx * tw)[:, :height, :width]

    img = torch.clamp(assemble(torch.cat(imgs)), 0.0, 1.0)
    log_t = assemble(torch.cat(logts)[:, None])[0]
    return img, log_t, assemble(torch.cat(pairs))


def blend_tiles_plain(pg: ProjectedGaussians, bins: TileBins, width: int,
                      height: int, bg: torch.Tensor,
                      tile_cap: int | None = None,
                      tile=TILE) -> torch.Tensor:
    """Composite all tiles. Returns (3, H, W) in [0, 1]."""
    return plain_blend(gauss_features(pg), bins.gauss_id, bins.starts,
                       bins.ends, bg, width, height, tile_cap, tile)[0]


def tile_overflow(bins: TileBins, tile_cap: int) -> torch.Tensor:
    """True if any tile's instance list was truncated by tile_cap."""
    return torch.max(bins.ends - bins.starts) > tile_cap
