"""Synthetic cameras and canonical SMPL pose helpers.

Equivalents of hugs/datasets/utils.py:15-201: a static camera, an
orbiting camera ring (for canonical and animation renders), predefined
body poses (da / a / t) and static and canonical SMPL parameter dicts.
Cameras come as frame dicts {'camera': Camera, 'width', 'height', ...},
the `data` argument of render_human_scene.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch.ops.graphics import (
    camera_center, full_projection, projection_matrix,
)
from hugs_tpu_torch.ops.rotations import (
    axis_angle_to_matrix, matrix_to_axis_angle,
)
from hugs_tpu_torch.render.camera import Camera


def _camera_from_w2c(w2c_rowvec: torch.Tensor, fovx: float, fovy: float,
                     znear=0.01, zfar=100.0) -> Camera:
    dev = w2c_rowvec.device
    proj = projection_matrix(znear, zfar, fovx, fovy, device=dev)
    # tan in float64, rounded once, as the JAX package evaluates it here
    return Camera(
        world_view=w2c_rowvec,
        full_proj=full_projection(w2c_rowvec, proj),
        center=camera_center(w2c_rowvec),
        tan_fovx=torch.tensor(np.tan(fovx / 2), dtype=torch.float32,
                              device=dev),
        tan_fovy=torch.tensor(np.tan(fovy / 2), dtype=torch.float32,
                              device=dev),
    )


def get_static_camera(img_size: int = 512, fov: float = 0.4,
                      device: torch.device | str = "cuda") -> dict:
    """Identity-extrinsics camera (reference datasets/utils.py:15-53)."""
    cam = _camera_from_w2c(torch.eye(4, device=device), fov, fov)
    return {"camera": cam, "width": img_size, "height": img_size,
            "fovx": fov, "fovy": fov, "near": 0.01, "far": 100.0}


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def get_rotating_camera(img_size=512, fov: float = 0.4, dist: float = 5.0,
                        nframes: int = 40, angle_limit: float = 2 * np.pi,
                        device: torch.device | str = "cuda") -> list[dict]:
    """Orbit around the origin: camera circles at `dist`, always looking
    at the center, with the y-down flip the reference applies
    (R[:, 1:3] *= -1). img_size is an int or (height, width).

    Deviation from reference datasets/utils.py:64-124 (by design): the
    reference composes rot(-azim) for the position with rot(azim) for
    the orientation, which makes the origin's camera depth d*cos(2
    azim) — the subject drifts out of the frustum and sits BEHIND the
    camera for half of every orbit. Here orientation and position use
    the SAME rotation, a true look-at: the origin projects to the image
    center at depth `dist` for every azimuth."""
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # y-down look-at
    out = []
    for azim in np.linspace(0.0, angle_limit, nframes):
        rot = _rot_y(azim)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = rot @ flip
        c2w[:3, 3] = rot @ np.array([0.0, 0.0, dist], np.float32)
        w2c = np.linalg.inv(c2w).T     # row-vector convention
        cam = _camera_from_w2c(torch.tensor(w2c, device=device), fov, fov)
        out.append({"camera": cam, "width": img_size[1],
                    "height": img_size[0], "fovx": fov, "fovy": fov,
                    "near": 0.01, "far": 100.0})
    return out


def get_predefined_pose(pose_type: str,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """(69,) body pose (reference datasets/utils.py:127-141)."""
    pose = np.zeros(69, np.float32)
    if pose_type == "da_pose":
        pose[2], pose[5] = 1.0, -1.0
    elif pose_type == "a_pose":
        pose[2], pose[5] = 0.2, -0.2
        pose[47], pose[50] = -0.8, 0.8
    elif pose_type == "t_pose":
        pass
    else:
        raise ValueError(pose_type)
    return torch.as_tensor(pose, device=device)


def get_smpl_static_params(betas, pose_type: str = "da_pose",
                           device: torch.device | str = "cuda") -> dict:
    return {
        "betas": torch.as_tensor(betas, dtype=torch.float32,
                                 device=device).reshape(10),
        "global_orient": torch.zeros(3, device=device),
        "body_pose": get_predefined_pose(pose_type, device),
        "transl": torch.zeros(3, device=device),
        "smpl_scale": torch.tensor(1.0, device=device),
    }


def get_smpl_canon_params(betas, nframes: int = 40,
                          pose_type: str = "da_pose",
                          device: torch.device | str = "cuda") -> dict:
    """Turntable body poses (reference datasets/utils.py:169-201): rotate
    the body about y, composed with the 180deg x flip."""
    orients = []
    Rx = axis_angle_to_matrix(torch.tensor([np.pi, 0.0, 0.0],
                                           dtype=torch.float32,
                                           device=device))
    for idx in range(nframes):
        ang = 2 * np.pi * idx / nframes
        R = axis_angle_to_matrix(torch.tensor(
            [0.0, ang, 0.0], dtype=torch.float32, device=device)) @ Rx
        orients.append(matrix_to_axis_angle(R))
    body_pose = get_predefined_pose(pose_type, device)[None].repeat(
        nframes, 1)
    return {
        "betas": torch.as_tensor(betas, dtype=torch.float32,
                                 device=device).reshape(1, 10).repeat(
                                     nframes, 1),
        "global_orient": torch.stack(orients),
        "body_pose": body_pose,
        "transl": torch.tensor([[0.0, 0.05, 5.0]],
                               device=device).repeat(nframes, 1),
        "smpl_scale": torch.ones((nframes, 1), device=device),
    }
