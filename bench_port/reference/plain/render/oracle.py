"""The blend's semantics, its constants and a pair's alpha, which the
plain tiled blend (render/blend.py) computes:
  alpha_i = min(0.99, opacity_i * exp(-0.5 d^T Conic d))
  alpha_i := 0 where the Gaussian-space power > 0, alpha_i < 1/255 or
             dist^2 > radius^2
  T_i     = prod_{j<i} (1 - alpha_j)          (exclusive transmittance)
  C(p)    = sum_i rgb_i * alpha_i * T_i * [T_i >= T_EPS]
            + bg * T_fin * [T_fin >= T_EPS]
in front-to-back depth order, with T_EPS = 1e-4, clipped to [0, 1].
The [T_i >= T_EPS] indicator is the order-independent form of 3DGS's
`T < 1e-4 -> done` early termination: once transmittance drops below
1e-4, later splats and the background contribute nothing. The radius
cutoff makes the result independent of the tiling.
"""
from __future__ import annotations

import torch


MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
T_EPS = 1e-4
LOG_TEPS = float(torch.log(torch.tensor(T_EPS, dtype=torch.float32)))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] with jnp.clip's gradient: 0.5 at exactly 0 or 1
    (torch.clamp passes 1 there). A pixel with no splat on a zero
    background is exactly 0, so the bound is common in training."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def gaussian_alpha(mean2d, conic, opacity, px, py, radius=None):
    """alpha of Gaussians (..., 2)/(..., 3)/(...) at pixel centres px, py
    (broadcastable). Returns the clamped alpha with the cutoffs applied;
    with `radius`, contributions beyond the screen-space radius are
    zeroed."""
    dx = mean2d[..., 0] - px
    dy = mean2d[..., 1] - py
    power = -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) \
        - conic[..., 1] * dx * dy
    alpha = torch.clamp(opacity * torch.exp(torch.clamp(power, max=0.0)),
                        max=MAX_ALPHA)
    keep = (power <= 0.0) & (alpha >= MIN_ALPHA)
    if radius is not None:
        keep = keep & (dx * dx + dy * dy <= radius * radius)
    return torch.where(keep, alpha, 0.0)
