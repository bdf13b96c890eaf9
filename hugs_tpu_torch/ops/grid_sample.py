"""Bilinear 2D grid sampling, plain PyTorch (gather form).

The triplane's feature lookup: F.grid_sample with align_corners=True,
written as four flat gathers in the JAX package's operation order. Grid
coordinates in [-1, 1] map to pixel-centre coordinates [0, S-1];
samples outside are clamped to the border.
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
    f00 = flat[y0 * W + x0]
    f01 = flat[y0 * W + x1]
    f10 = flat[y1 * W + x0]
    f11 = flat[y1 * W + x1]

    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    return top * (1.0 - wy) + bot * wy
