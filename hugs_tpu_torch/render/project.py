"""EWA projection of 3D Gaussians to screen space, plain PyTorch.

The 'preprocess' stage of the splatting pipeline (3DGS's preprocessCUDA):
  1. world -> camera point t (row-vector world_view), near cull at z<=0.2;
  2. world -> NDC via full_proj, to pixel coords;
  3. cov3D = R S S^T R^T; cov2D = J W cov3D W^T J^T + 0.3 I (low-pass);
  4. conic = cov2D^{-1}; radius = opacity-aware, capped at 3 sigma;
  5. view-dependent RGB from SH along (mean - campos).

All math runs on (N,) rows with the JAX package's operation order, so
the two agree to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.ops.sh import eval_sh_rows
from hugs_tpu_torch.render.camera import Camera


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor    # (N, 3) packed inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # (N,) camera-space z
    radius: torch.Tensor   # (N,) float screen-space radius (0 = culled)
    rgb: torch.Tensor      # (N, 3) view-dependent color
    opacity: torch.Tensor  # (N,) in [0, 1]
    mask: torch.Tensor     # (N,) bool: visible (not culled, finite footprint)


def update_mean2d(pg: ProjectedGaussians,
                  delta: torch.Tensor) -> ProjectedGaussians:
    """mean2d += delta. delta: (N, 2) per Gaussian, or a broadcastable
    (2,) shift. With a zero `delta` that requires grad, d(loss)/d(delta)
    is the pixel-space mean2d gradient the densifier reads."""
    return pg._replace(mean2d=pg.mean2d + delta)


def ndc_to_pixel(ndc: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1, 1] -> continuous pixel coordinate (3DGS convention)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means3d: torch.Tensor,      # (N, 3)
    scales: torch.Tensor,       # (N, 3), already exp-activated
    rotq: torch.Tensor,         # (N, 4) quaternions wxyz
    opacity: torch.Tensor,      # (N,) or (N, 1)
    shs: torch.Tensor,          # (N, K, 3) SH coeffs or (N, 3) rgb
    camera: Camera,
    width: int,
    height: int,
    active_sh_degree: torch.Tensor | int = 0,
    scaling_modifier: float = 1.0,
    alive: torch.Tensor | None = None,  # (N,) bool capacity mask
    near: float = 0.2,
) -> ProjectedGaussians:
    opacity = opacity.reshape(-1)
    n = means3d.shape[0]
    m0, m1, m2 = means3d.T

    # camera-space position and depth: t = x @ wv[:3, :3] + wv[3, :3]
    wv = camera.world_view
    t0 = m0 * wv[0, 0] + m1 * wv[1, 0] + m2 * wv[2, 0] + wv[3, 0]
    t1 = m0 * wv[0, 1] + m1 * wv[1, 1] + m2 * wv[2, 1] + wv[3, 1]
    depth = m0 * wv[0, 2] + m1 * wv[1, 2] + m2 * wv[2, 2] + wv[3, 2]

    # pixel-space mean through full_proj (only x, y, w are used)
    fp = camera.full_proj
    hx = m0 * fp[0, 0] + m1 * fp[1, 0] + m2 * fp[2, 0] + fp[3, 0]
    hy = m0 * fp[0, 1] + m1 * fp[1, 1] + m2 * fp[2, 1] + fp[3, 1]
    hw = m0 * fp[0, 3] + m1 * fp[1, 3] + m2 * fp[2, 3] + fp[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    mx = ndc_to_pixel(hx * p_w, width)
    my = ndc_to_pixel(hy * p_w, height)

    # 2D covariance (EWA), with the camera point clamped to 1.3x the
    # frustum for a stable Jacobian
    focal_x = width / (2.0 * camera.tan_fovx)
    focal_y = height / (2.0 * camera.tan_fovy)
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    tz = torch.where(torch.abs(depth) < 1e-6, 1e-6, depth)
    tx = torch.clamp(t0 / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t1 / tz, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # cov2d = (J W^T) Sigma (J W^T)^T in closed form: with u = row0(J W^T),
    # v = row1(J W^T), p = diag(s) R^T u^T and q = diag(s) R^T v^T,
    # cov2d = [[p.p, p.q], [p.q, q.q]].
    a1 = focal_x * inv_z
    a2 = -focal_x * tx * inv_z2
    b1 = focal_y * inv_z
    b2 = -focal_y * ty * inv_z2
    u0 = a1 * wv[0, 0] + a2 * wv[0, 2]
    u1 = a1 * wv[1, 0] + a2 * wv[1, 2]
    u2 = a1 * wv[2, 0] + a2 * wv[2, 2]
    v0 = b1 * wv[0, 1] + b2 * wv[0, 2]
    v1 = b1 * wv[1, 1] + b2 * wv[1, 2]
    v2 = b1 * wv[2, 1] + b2 * wv[2, 2]
    qT = rotq.T
    qnorm = torch.sqrt(qT[0] * qT[0] + qT[1] * qT[1] + qT[2] * qT[2]
                       + qT[3] * qT[3]).clamp(min=1e-12)
    qw, qx, qy, qz = qT[0] / qnorm, qT[1] / qnorm, qT[2] / qnorm, \
        qT[3] / qnorm
    xs, ys, zs = 2.0 * qx, 2.0 * qy, 2.0 * qz
    wx, wy, wz = qw * xs, qw * ys, qw * zs
    xx, xy, xz = qx * xs, qx * ys, qx * zs
    yy, yz, zz = qy * ys, qy * zs, qz * zs
    r00, r01, r02 = 1.0 - (yy + zz), xy - wz, xz + wy
    r10, r11, r12 = xy + wz, 1.0 - (xx + zz), yz - wx
    r20, r21, r22 = xz - wy, yz + wx, 1.0 - (xx + yy)
    sT = scales.T
    s0 = scaling_modifier * sT[0]
    s1 = scaling_modifier * sT[1]
    s2 = scaling_modifier * sT[2]
    p0 = s0 * (r00 * u0 + r10 * u1 + r20 * u2)
    p1 = s1 * (r01 * u0 + r11 * u1 + r21 * u2)
    p2 = s2 * (r02 * u0 + r12 * u1 + r22 * u2)
    q0 = s0 * (r00 * v0 + r10 * v1 + r20 * v2)
    q1 = s1 * (r01 * v0 + r11 * v1 + r21 * v2)
    q2 = s2 * (r02 * v0 + r12 * v1 + r22 * v2)
    a = p0 * p0 + p1 * p1 + p2 * p2 + 0.3
    c = q0 * q0 + q1 * q1 + q2 * q2 + 0.3
    b = p0 * q0 + p1 * q1 + p2 * q2

    det = a * c - b * b
    det_safe = torch.where(det <= 0, 1.0, det)
    inv_det = 1.0 / det_safe
    conic_a = c * inv_det
    conic_b = -b * inv_det
    conic_c = a * inv_det

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    # Opacity-aware extent: the blend drops alpha < 1/255, so the radius
    # only needs to cover 0.5 d'Σ⁻¹d <= ln(255 op), i.e. d² <= 2 λ1
    # ln(255 op), capped at the 3-sigma bound of 3DGS's computeCov2D.
    lim = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * 255.0)
    k3 = torch.sqrt(torch.clamp(lim, 0.0, 9.0))
    radius = torch.ceil(k3 * torch.sqrt(lam1))

    if shs.ndim == 2:
        rgbT = shs.T
    else:
        K = shs.shape[1]
        max_deg = int(round(K ** 0.5)) - 1
        dx = m0 - camera.center[0]
        dy = m1 - camera.center[1]
        dz = m2 - camera.center[2]
        inv_n = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz),
                                  min=1e-8)
        # torch.maximum, not torch.clamp: at a colour of exactly 0 (an SH
        # fitted to a colour clipped to 0) its gradient is 0.5, as
        # jnp.maximum's is; torch.clamp's is 1
        rgb_raw = eval_sh_rows(max_deg, active_sh_degree,
                               shs.reshape(n, K * 3).T,
                               dx * inv_n, dy * inv_n, dz * inv_n) + 0.5
        rgbT = torch.maximum(rgb_raw, rgb_raw.new_zeros(()))

    mask = (depth > near) & (det > 0) & (radius > 0)
    if alive is not None:
        mask = mask & alive
    radius = torch.where(mask, radius, 0.0)

    return ProjectedGaussians(
        mean2d=torch.stack([mx, my], dim=-1),
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        depth=depth, radius=radius, rgb=rgbT.T, opacity=opacity, mask=mask)
