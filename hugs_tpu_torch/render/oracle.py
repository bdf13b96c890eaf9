"""Reference (oracle) renderer: dense per-pixel alpha blending.

Slow but exact O(N * H * W) renderer; it states the blend semantics that
every backend of the port (the plain tiled blend and the CUDA kernel)
follows:
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

import math

import torch

from hugs_tpu_torch.render.project import ProjectedGaussians

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


def render_oracle(pg: ProjectedGaussians, width: int, height: int,
                  bg: torch.Tensor) -> torch.Tensor:
    """Render (H, W, 3). Dense: every Gaussian against every pixel."""
    depth = torch.where(pg.mask, pg.depth, math.inf)
    order = torch.argsort(depth, stable=True)
    mean2d = pg.mean2d[order]
    conic = pg.conic[order]
    rgb = pg.rgb[order]
    opac = torch.where(pg.mask, pg.opacity, 0.0)[order]
    radius = pg.radius[order]

    dev = mean2d.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")          # (H, W)
    px, py = px.reshape(-1), py.reshape(-1)                 # (P,)

    alpha = gaussian_alpha(mean2d[:, None, :], conic[:, None, :],
                           opac[:, None], px[None, :], py[None, :],
                           radius=radius[:, None])          # (N, P)
    log_t = torch.cumsum(torch.log1p(-alpha), dim=0)
    log_t_excl = torch.cat([torch.zeros_like(log_t[:1]), log_t[:-1]], dim=0)
    w = alpha * torch.exp(log_t_excl) * (log_t_excl >= LOG_TEPS)
    color = rgb.T @ w                                       # (3, P)
    if alpha.shape[0]:
        final_t = torch.exp(log_t[-1]) * (log_t[-1] >= LOG_TEPS)
    else:
        final_t = torch.ones(alpha.shape[1], device=dev)
    img = color + bg[:, None] * final_t[None, :]
    return clip01(img.reshape(3, height, width).permute(1, 2, 0))
