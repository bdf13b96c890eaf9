"""Camera as a NamedTuple of tensors.

Fields mirror the per-frame dicts 3DGS datasets produce: row-vector
`world_view` / `full_proj` transforms, the camera center and the
half-angle tangents. Image width and height travel beside the camera on
the render calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.ops.graphics import (
    camera_center, full_projection, projection_matrix, world_to_view,
)


class Camera(NamedTuple):
    world_view: torch.Tensor  # (4, 4) row-vector world->camera
    full_proj: torch.Tensor   # (4, 4) row-vector world->NDC
    center: torch.Tensor      # (3,) camera position in world
    tan_fovx: torch.Tensor    # () tan(fovx / 2)
    tan_fovy: torch.Tensor    # () tan(fovy / 2)


def make_camera(R, t, fovx: float, fovy: float, znear: float = 0.01,
                zfar: float = 100.0,
                device: torch.device | str = "cuda") -> Camera:
    """Build a Camera from COLMAP-style extrinsics (R, t) and fovs.

    R and t may be tensors, arrays or nested lists; t may be a scalar
    that broadcasts over the three axes."""
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device).expand(3)
    wv = world_to_view(R, t)
    proj = projection_matrix(znear, zfar, fovx, fovy, device=device)
    # tan in float32, as the JAX package evaluates it
    half = torch.tensor([fovx / 2.0, fovy / 2.0], dtype=torch.float32,
                        device=device)
    tan = torch.tan(half)
    return Camera(world_view=wv, full_proj=full_projection(wv, proj),
                  center=camera_center(wv), tan_fovx=tan[0],
                  tan_fovy=tan[1])
