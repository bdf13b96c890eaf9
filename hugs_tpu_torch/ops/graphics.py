"""Camera/projection math in PyTorch.

Row-vector convention, as in the JAX package: points are multiplied as
p_hom @ M, so the matrices built here are the TRANSPOSE of the usual
column-vector OpenGL forms. `world_to_view(R, t)` corresponds to 3DGS's
getWorld2View and `projection_matrix` to get_projection_matrix, both
returned already transposed for row-vector use.
"""
from __future__ import annotations

import math

import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World->camera 4x4, ROW-VECTOR convention (already transposed).

    R: (3, 3) camera rotation (COLMAP convention: world axes in the camera
    frame are R^T); t: (3,) translation. The column-vector form is
    [[R^T, t], [0, 1]]; this returns its transpose.
    """
    Rt = torch.zeros((4, 4), dtype=torch.float32, device=R.device)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.T


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Perspective projection 4x4, ROW-VECTOR convention (transposed).

    Z maps to [0, 1] NDC with z_sign=+1 (3DGS convention).
    """
    tan_x = math.tan(fovx / 2.0)
    tan_y = math.tan(fovy / 2.0)
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.T


def projection_matrix_center(znear: float, zfar: float, fx: float,
                             fy: float, cx: float, cy: float, width: float,
                             height: float,
                             device: torch.device | str = "cuda"
                             ) -> torch.Tensor:
    """Principal-point-aware projection (reference graphics.py:61-73),
    ROW-VECTOR convention (transposed)."""
    cx_flip = width - cx
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 2.0 * fx / width
    P[1, 1] = 2.0 * fy / height
    P[0, 2] = 1.0 - 2.0 * cx_flip / width
    P[1, 2] = 2.0 * cy / height - 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.T


def full_projection(world_view: torch.Tensor,
                    proj: torch.Tensor) -> torch.Tensor:
    """Composed world->NDC transform in row-vector convention:
    p @ full = (p @ world_view) @ proj."""
    return world_view @ proj


def camera_center(world_view: torch.Tensor) -> torch.Tensor:
    """Camera position in world coords from a row-vector world_view."""
    return torch.linalg.inv(world_view)[3, :3]


def transform_points(points: torch.Tensor, mat4: torch.Tensor) -> torch.Tensor:
    """Apply a row-vector 4x4 to (N, 3) points, perspective divide."""
    ones = torch.ones_like(points[..., :1])
    hom = torch.cat([points, ones], dim=-1) @ mat4
    return hom[..., :3] / (hom[..., 3:4] + 1e-7)
