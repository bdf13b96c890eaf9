"""Bilinear 2D grid sampling, plain PyTorch (gather form).

The triplane's feature lookup: F.grid_sample with align_corners=True,
written as four flat gathers in the JAX package's operation order. Grid
coordinates in [-1, 1] map to pixel-centre coordinates [0, S-1];
samples outside are clamped to the border.

The gathers are index_select, whose backward is index_add_ (atomic adds
on the card). Indexing plane[idx] would differentiate through
index_put_(accumulate=True), which on the card sorts the indices and
sums each run of equal ones serially: an avatar at training capacity
has hundreds of thousands of dead rows at the origin, all in one cell,
and that sum took over a second per plane.
"""
from __future__ import annotations

import torch


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample a feature plane at continuous 2D locations.

    plane: (H, W, C) feature image; coords: (N, 2) in [-1, 1], coords[:, 0]
    along W (x) and coords[:, 1] along H (y), as F.grid_sample takes them.
    Returns (N, C), differentiable in plane and coords.
    """
    H, W, _ = plane.shape
    x = (coords[:, 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    x = torch.clamp(x, 0.0, W - 1)
    y = torch.clamp(y, 0.0, H - 1)

    # x0 at most W - 2, so the upper edge interpolates with weight 1 on x1
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = (x - x0.to(x.dtype))[:, None]
    wy = (y - y0.to(y.dtype))[:, None]

    flat = plane.reshape(H * W, -1)
    f00 = torch.index_select(flat, 0, y0 * W + x0)
    f01 = torch.index_select(flat, 0, y0 * W + x1)
    f10 = torch.index_select(flat, 0, y1 * W + x0)
    f11 = torch.index_select(flat, 0, y1 * W + x1)

    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    return top * (1.0 - wy) + bot * wy
