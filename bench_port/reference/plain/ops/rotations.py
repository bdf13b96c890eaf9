"""Rotation representation conversions, plain PyTorch.

Quaternions (w, x, y, z convention), rotation matrices, axis-angle, the
continuous 6D representation of Zhou et al. 2019 and XYZ Euler angles.
All functions are batched over leading axes and differentiable, with no
data-dependent branching, in the JAX package's operation order.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternions to unit norm. q: (..., 4) in (w, x, y, z)."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.clamp(torch.sum(q * q, dim=-1), min=_EPS)
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0.

    Branch-free: all four Shepperd candidates are computed and the one
    with the largest pivot is taken."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def safe_div(a, b):
        return a / torch.clamp(b, min=_EPS)

    def pivot(x2):
        return torch.sqrt(torch.clamp(x2, min=_EPS)) * 2.0

    sw, sx, sy, sz = pivot(qw2), pivot(qx2), pivot(qy2), pivot(qz2)
    cand_w = torch.stack([0.25 * sw, safe_div(m21 - m12, sw),
                          safe_div(m02 - m20, sw), safe_div(m10 - m01, sw)],
                         dim=-1)
    cand_x = torch.stack([safe_div(m21 - m12, sx), 0.25 * sx,
                          safe_div(m01 + m10, sx), safe_div(m02 + m20, sx)],
                         dim=-1)
    cand_y = torch.stack([safe_div(m02 - m20, sy), safe_div(m01 + m10, sy),
                          0.25 * sy, safe_div(m12 + m21, sy)], dim=-1)
    cand_z = torch.stack([safe_div(m10 - m01, sz), safe_div(m02 + m20, sz),
                          safe_div(m12 + m21, sz), 0.25 * sz], dim=-1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4) wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """||x|| along the last axis with a gradient defined (zero) at x=0."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=1e-24))


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) (direction * angle) -> quaternion (..., 4) wxyz."""
    angle = _safe_norm(aa)
    half = 0.5 * angle
    # sin(half) / angle, with its series below 1e-6
    k = torch.where(angle > 1e-6,
                    torch.sin(half) / torch.clamp(angle, min=_EPS),
                    0.5 - angle * angle / 48.0)
    return torch.cat([torch.cos(half), aa * k], dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> axis-angle (..., 3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = _safe_norm(v)
    angle = 2.0 * torch.atan2(vnorm, w)
    k = torch.where(vnorm > 1e-6, angle / torch.clamp(vnorm, min=_EPS),
                    2.0 / torch.clamp(w, min=_EPS))
    return v * k


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    return quat_to_matrix(axis_angle_to_quat(aa))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(matrix_to_quat(m))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rep (..., 6) -> rotation matrix (..., 3, 3), by
    Gram-Schmidt on the two 3-vectors (Zhou et al. 2019); the rows are
    b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=_EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True),
                           min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6D rep (first two rows, flattened)."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def axis_angle_to_rotation_6d(aa: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(aa))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def rotation_matrix_from_vectors(a: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) rotating unit direction a onto b:
    R = I + K + K^2 / (1 + a.b) with K the cross-product matrix of a x b,
    and a half turn about an axis orthogonal to a where a and b are
    antiparallel."""
    a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=_EPS)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=_EPS)
    v = torch.linalg.cross(a, b, dim=-1)
    c = torch.sum(a * b, dim=-1)
    zeros = torch.zeros_like(c)
    K = torch.stack([
        zeros, -v[..., 2], v[..., 1],
        v[..., 2], zeros, -v[..., 0],
        -v[..., 1], v[..., 0], zeros,
    ], dim=-1).reshape(a.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(K.shape)
    denom = torch.clamp(1.0 + c, min=_EPS)[..., None, None]
    R = eye + K + torch.matmul(K, K) / denom
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ortho = torch.linalg.cross(
        a, torch.where(torch.abs(a[..., :1]) < 0.9, e_x, e_y), dim=-1)
    ortho = ortho / torch.clamp(torch.linalg.norm(ortho, dim=-1, keepdim=True),
                                min=_EPS)
    R180 = quat_to_matrix(torch.cat([zeros[..., None], ortho], dim=-1))
    return torch.where((c < -1.0 + 1e-6)[..., None, None], R180, R)
