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


def full_projection(world_view: torch.Tensor,
                    proj: torch.Tensor) -> torch.Tensor:
    """Composed world->NDC transform in row-vector convention:
    p @ full = (p @ world_view) @ proj."""
    return world_view @ proj


def camera_center(world_view: torch.Tensor) -> torch.Tensor:
    """Camera position in world coords from a row-vector world_view."""
    return torch.linalg.inv(world_view)[3, :3]
