"""Camera as a NamedTuple of tensors.

Fields mirror the per-frame dicts 3DGS datasets produce: row-vector
`world_view` / `full_proj` transforms, the camera center and the
half-angle tangents. Image width and height travel beside the camera on
the render calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    world_view: torch.Tensor  # (4, 4) row-vector world->camera
    full_proj: torch.Tensor   # (4, 4) row-vector world->NDC
    center: torch.Tensor      # (3,) camera position in world
    tan_fovx: torch.Tensor    # () tan(fovx / 2)
    tan_fovy: torch.Tensor    # () tan(fovy / 2)
