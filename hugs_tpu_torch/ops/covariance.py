"""3D Gaussian covariance construction, plain PyTorch: a Gaussian's
covariance is R S S^T R^T, with R from a unit quaternion and
S = diag(scales)."""
from __future__ import annotations

import torch

from hugs_tpu_torch.ops.rotations import quat_normalize, quat_to_matrix


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (N, 4) wxyz, normalized here -> rotations (N, 3, 3)."""
    return quat_to_matrix(quat_normalize(q))


def build_scaling_rotation(scales: torch.Tensor,
                           q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(scales): (N, 3, 3)."""
    return build_rotation(q) * scales[..., None, :]


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric (N, 3, 3) -> packed upper-triangular 6 values
    (xx, xy, xz, yy, yz, zz), the 3DGS on-the-wire covariance layout."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def covariance_from_scaling_rotation(scales: torch.Tensor, q: torch.Tensor,
                                     scaling_modifier: float = 1.0
                                     ) -> torch.Tensor:
    """Full 3x3 covariance matrices (N, 3, 3)."""
    L = build_scaling_rotation(scaling_modifier * scales, q)
    return torch.matmul(L, L.transpose(-1, -2))
