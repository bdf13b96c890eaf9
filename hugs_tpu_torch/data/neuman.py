"""NeuMan dataset: a monocular human video and its COLMAP scene.

The counterpart of the JAX package's NeumanDataset (reference
hugs/datasets/neuman.py:183-407) on the same layout:

  {root}/{seq}/images/*.png          frames
  {root}/{seq}/segmentations/*.png   human masks
  {root}/{seq}/sparse/               COLMAP model (text or binary)
  {root}/{seq}/4d_humans/smpl_optimized_aligned_scale.npz
                                     per-frame SMPL parameters and scale

Each item is a dict: 'rgb' (3, H, W) and 'mask' (H, W) float32 tensors
on the dataset's device, 'bbox' (x0, y0, x1, y1) in numpy, 'camera' (a
Camera on the device), 'width', 'height', the field of view, and the
frame's SMPL parameters in numpy. Also the train / val / test split rule
(every 5th offset frame, half test and half val, neuman.py:47-59), the
scene point cloud with the optional background sphere (neuman.py:
246-273) and the camera-extent radius of densification. Images are read
with utils/png.py. The anim split (AMASS mocap, neuman.py:62-180) comes
with the animation slice and raises here.
"""
from __future__ import annotations

import math
import os
from typing import Any

import numpy as np
import torch

from hugs_tpu_torch.data.cameras import _camera_from_w2c
from hugs_tpu_torch.data.colmap import read_colmap_scene
from hugs_tpu_torch.ops.graphics import focal2fov
from hugs_tpu_torch.utils.png import read_png


def get_data_splits(n_frames: int):
    """Reference split rule (neuman.py:47-59)."""
    num_val = n_frames // 5
    length = int(1 / num_val * n_frames)
    offset = length // 2
    val_list = list(range(n_frames))[offset::length]
    train_list = sorted(set(range(n_frames)) - set(val_list))
    test_list = val_list[:len(val_list) // 2]
    val_list = val_list[len(val_list) // 2:]
    return train_list, val_list, test_list


def fibonacci_sphere(n: int) -> np.ndarray:
    samples = np.arange(n)
    y = 1 - (samples / float(n - 1)) * 2
    radius = np.sqrt(1 - y * y)
    phi = math.pi * (math.sqrt(5.0) - 1.0)
    theta = phi * samples
    return np.stack([np.cos(theta) * radius, y,
                     np.sin(theta) * radius], axis=1).astype(np.float32)


def _load_image(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32) / 255.0


def dilate_mask(msk: np.ndarray, k: int = 20) -> np.ndarray:
    """k x k box dilation (grayscale max filter), the reference's
    cv2.dilate with a 20x20 kernel in scene mode (neuman.py:327).
    Separable: a row max-filter then a column max-filter; cv2 anchors the
    kernel at its center (floor(k/2) back, k-1-floor(k/2) forward)."""
    if k <= 1:
        return msk
    lo, hi = k // 2, k - 1 - k // 2
    out = msk
    for axis in (0, 1):
        n = out.shape[axis]
        padded = np.pad(out, [(lo, hi) if a == axis else (0, 0)
                              for a in range(2)], constant_values=-np.inf)
        acc = out
        for d in range(k):
            sl = tuple(slice(d, d + n) if a == axis else slice(None)
                       for a in range(2))
            acc = np.maximum(acc, padded[sl])
        out = acc
    return out


def remove_statistical_outliers(xyz: np.ndarray, nb_neighbors: int = 100,
                                std_ratio: float = 0.5) -> np.ndarray:
    """open3d's remove_statistical_outlier(nb_neighbors, std_ratio)
    (reference neuman.py:234-244, behind scene.clean_pcd): drops the
    points whose mean distance to their nb_neighbors nearest neighbours
    exceeds the global mean + std_ratio x std. Returns inlier indices."""
    from scipy.spatial import cKDTree
    n = xyz.shape[0]
    k = min(nb_neighbors, n - 1)
    if k < 1:
        return np.arange(n)
    tree = cKDTree(np.asarray(xyz, np.float64))
    dists, _ = tree.query(xyz, k=k + 1, workers=-1)   # the point itself first
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.flatnonzero(mean_d <= thresh)


def camera_extent(c2w_positions: np.ndarray) -> float:
    """3DGS's 'nerf normalization' radius: 1.1 x the largest camera
    distance from the mean camera centre (spatial_lr_scale, densify
    extent)."""
    center = c2w_positions.mean(axis=0, keepdims=True)
    return float(1.1 * np.linalg.norm(c2w_positions - center,
                                      axis=1).max())


class NeumanDataset:
    def __init__(self, root: str, seq: str, split: str,
                 render_mode: str = "human_scene",
                 add_bg_points: bool = False, num_bg_points: int = 204_800,
                 bg_sphere_dist: float = 5.0, clean_pcd: bool = False,
                 cache: bool = True,
                 device: torch.device | str = "cuda"):
        if split == "anim":
            raise NotImplementedError(
                "the anim split (AMASS mocap) comes with the animation "
                "slice (ROADMAP Slice F)")
        self.seq = seq
        self.split = split
        self.render_mode = render_mode
        self.device = torch.device(device)
        path = os.path.join(root, seq)
        scene = read_colmap_scene(os.path.join(path, "sparse"))
        self.colmap = scene

        img_dir = os.path.join(path, "images")
        self.img_files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith(".png"))
        seg_dir = os.path.join(path, "segmentations")
        self.msk_files = sorted(
            os.path.join(seg_dir, f) for f in os.listdir(seg_dir)
            if f.lower().endswith(".png")) if os.path.isdir(seg_dir) else []

        z = np.load(os.path.join(
            path, "4d_humans", "smpl_optimized_aligned_scale.npz"))
        sp = {k: np.asarray(z[k], np.float32) for k in z.files}
        n = len(scene.images)
        self.smpl_params = {
            "betas": np.broadcast_to(sp["betas"].reshape(-1, 10)[:1],
                                     (n, 10)).copy()
            if sp["betas"].shape[0] != n else sp["betas"][:, :10],
            "global_orient": sp["global_orient"].reshape(n, 3),
            "body_pose": sp["body_pose"].reshape(n, -1)[:, :69],
            "transl": sp["transl"].reshape(n, 3),
            "scale": sp.get("scale", np.ones(n, np.float32)).reshape(n),
        }

        # point cloud and background sphere (reference neuman.py:246-273)
        pcd_xyz, pcd_col = scene.points, scene.colors
        if clean_pcd:
            keep = remove_statistical_outliers(pcd_xyz)
            pcd_xyz, pcd_col = pcd_xyz[keep], pcd_col[keep]
        if add_bg_points:
            mx, mn = pcd_xyz.max(0), pcd_xyz.min(0)
            center, size = (mx + mn) / 2, np.max(mx - mn)
            sphere = fibonacci_sphere(num_bg_points)
            sphere = sphere * size * bg_sphere_dist + center
            pcd_xyz = np.concatenate([pcd_xyz, sphere], axis=0)
            pcd_col = np.concatenate(
                [pcd_col, np.full((num_bg_points, 3), 0.5, np.float32)],
                axis=0)
        self.init_pcd = (pcd_xyz, pcd_col)

        c2w_pos = np.stack([-im.R.T @ im.t for im in scene.images])
        self.radius = camera_extent(c2w_pos)

        tr, va, te = get_data_splits(n)
        self.indices = {"train": tr, "val": va, "test": te}[split]
        self.cached_data = ([self.get_single_item(i)
                             for i in range(len(self))] if cache else None)

    def __len__(self):
        return len(self.indices)

    def _camera_of(self, R, t, cam_id):
        cc = self.colmap.cameras[cam_id]
        fovx = focal2fov(cc.fx, cc.width)
        fovy = focal2fov(cc.fy, cc.height)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = t
        cam = _camera_from_w2c(torch.as_tensor(np.asarray(w2c.T, np.float32),
                                               device=self.device),
                               fovx, fovy)
        return cam, cc.width, cc.height, fovx, fovy

    def get_single_item(self, i: int) -> dict[str, Any]:
        idx = self.indices[i]
        im = self.colmap.images[idx]
        rgb = _load_image(self.img_files[idx])[..., :3]
        if self.msk_files:
            msk = _load_image(self.msk_files[idx])
            if msk.ndim == 3:
                msk = msk[..., 0]
        else:
            msk = np.zeros(rgb.shape[:2], np.float32)
        if self.render_mode == "scene":
            # scene-only training masks out the human and a margin
            # (reference neuman.py:327: a 20x20 cv2.dilate)
            msk = dilate_mask(msk, 20)
        rows = np.any(msk > 0, axis=0)
        cols = np.any(msk > 0, axis=1)
        if rows.any():
            ymin, ymax = np.where(rows)[0][[0, -1]]
            xmin, xmax = np.where(cols)[0][[0, -1]]
        else:
            ymin = xmin = 0
            ymax, xmax = msk.shape[1] - 1, msk.shape[0] - 1
        cam, w, h, fovx, fovy = self._camera_of(im.R, im.t, im.camera_id)
        return {
            "rgb": torch.as_tensor(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                                   device=self.device),
            "mask": torch.as_tensor(msk, device=self.device),
            "bbox": np.array([xmin, ymin, xmax, ymax], np.float32),
            "camera": cam, "width": w, "height": h,
            "fovx": fovx, "fovy": fovy, "near": 0.01, "far": 100.0,
            "betas": self.smpl_params["betas"][idx],
            "global_orient": self.smpl_params["global_orient"][idx],
            "body_pose": self.smpl_params["body_pose"][idx],
            "transl": self.smpl_params["transl"][idx],
            "smpl_scale": self.smpl_params["scale"][idx],
        }

    def __getitem__(self, i):
        if self.cached_data is not None:
            return self.cached_data[i]
        return self.get_single_item(i)
