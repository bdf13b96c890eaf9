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
with utils/png.py.

The anim split (neuman.py:62-180): an AMASS motion clip per sequence
(SMPL-H poses cut to SMPL's joints), read from `amass_root` (default
{root}/..), with the sequence's manual alignment into the scene and
cameras on an ellipse or a slide about one capture. Its items have no
'rgb', 'mask' or 'bbox'; they carry 'manual_trans', 'manual_rotmat' and
'manual_scale' instead.
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

# AMASS SMPL-H -> SMPL joint subset (reference hugs/cfg/constants.py:11-16)
AMASS_SMPLH_TO_SMPL_JOINTS = np.arange(0, 156).reshape(-1, 3)[[
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 37]].reshape(-1)

# each sequence's mocap clip: (path under amass_root, start, stop, step)
# (reference neuman.py:62-86)
MOCAP_PATHS = {
    "seattle": ("SFU/0005/0005_SideSkip001_poses.npz", 0, 800, 4),
    "citron": ("MPI_mosh/00093/irish_dance_poses.npz", 0, 1000, 4),
    "parkinglot": ("SFU/0005/0005_2FeetJump001_poses.npz", 0, 1200, 4),
    "bike": ("MPI_mosh/50002/misc_poses.npz", 0, 250, 1),
    "jogging": ("SFU/0007/0007_Cartwheel001_poses.npz", 200, 1000, 8),
    "lab": ("SFU/0008/0008_ChaCha001_poses.npz", 0, 1000, 4),
}

# the manual scene <- mocap alignment: (translation, XYZ euler degrees,
# scale) (reference neuman.py:89-118)
ALIGNMENTS = {
    "seattle": ([-2.25, 1.08, 8.18], [90.4, -4.2, -1], 1.8),
    "citron": ([6.33, 1.7, 10.7], [72.4, 168.2, -4.4], 2.5),
    "parkinglot": ([-0.8, 2.35, 12.67], [94, -85, -363], 3.0),
    "bike": ([0.0, 0.88, 3.89], [88.8, 180, 1.8], 1.0),
    "jogging": ([0.0, 0.24, 0.33], [95.8, -1.2, -2.2], 0.25),
    "lab": ([5.76, 3.03, 11.69], [90.4, -4.2, -1.8], 3.0),
}

# the anim cameras: (capture index, kind, parameters) (reference
# rendering_caps, neuman.py:121-180)
ANIM_CAMS = {
    "seattle": (20, "ellipse", dict(a=1.5, b=0.05, laps=1, x0=0.0, fwd=0.0)),
    "citron": (33, "ellipse", dict(a=0.45, b=0.09, laps=2, x0=0.2, fwd=0.0)),
    "parkinglot": (23, "ellipse", dict(a=1.5, b=0.15, laps=2, x0=0.2,
                                       fwd=0.0)),
    "bike": (25, "slide", dict(interval=0.01)),
    "jogging": (67, "slide", dict(interval=-0.01)),
    "lab": (39, "ellipse", dict(a=1.5, b=0.03, laps=1, x0=0.0, fwd=0.2)),
}


def euler_matrix(ax, ay, az) -> np.ndarray:
    """Rotation of XYZ euler angles in radians, Rz Ry Rx (the 'sxyz'
    convention of transformations.euler_matrix), float32."""
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


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
                 amass_root: str | None = None, cache: bool = True,
                 device: torch.device | str = "cuda"):
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

        if split == "anim":
            self._setup_anim(amass_root or os.path.join(root, ".."))
        else:
            tr, va, te = get_data_splits(n)
            self.indices = {"train": tr, "val": va, "test": te}[split]
        self.cached_data = ([self.get_single_item(i)
                             for i in range(len(self))] if cache else None)

    # ------------------------------------------------------------- anim

    def _setup_anim(self, amass_root: str):
        rel, s0, s1, skip = MOCAP_PATHS[self.seq]
        motions = np.load(os.path.join(amass_root, rel))
        poses = motions["poses"][s0:s1:skip][:, AMASS_SMPLH_TO_SMPL_JOINTS]
        transl = motions["trans"][s0:s1:skip]
        nf = poses.shape[0]
        betas = self.smpl_params["betas"][0]
        self.smpl_params = {
            "global_orient": poses[:, :3].astype(np.float32),
            "body_pose": poses[:, 3:].astype(np.float32),
            "transl": transl.astype(np.float32),
            "scale": np.ones(nf, np.float32),
            "betas": np.tile(betas[None], (nf, 1)),
        }
        tr, rot_deg, sc = ALIGNMENTS[self.seq]
        self.manual_trans = np.asarray(tr, np.float32)
        self.manual_rotmat = euler_matrix(*(np.asarray(rot_deg) / 180 * np.pi))
        self.manual_scale = np.float32(sc)
        self.anim_frames = nf
        base_idx, kind, prm = ANIM_CAMS[self.seq]
        self.anim_caps = self._make_anim_caps(base_idx, kind, prm, nf)
        self.indices = list(range(nf))

    def _make_anim_caps(self, base_idx, kind, prm, nf):
        """nf cameras with capture base_idx's rotation (the last capture
        where the sequence has fewer), moved along an ellipse in its
        right / up plane or slid along its right axis."""
        base_idx = min(base_idx, len(self.colmap.images) - 1)
        base = self.colmap.images[base_idx]
        c2w_R = base.R.T
        right, up, forward = c2w_R[:, 0], c2w_R[:, 1], c2w_R[:, 2]
        pos0 = -base.R.T @ base.t
        caps = []
        for i in range(nf):
            pos = pos0.copy()
            if kind == "ellipse":
                ang = prm["laps"] * i / nf * 2 * np.pi
                pos = pos + right * (prm["a"] * np.cos(ang) + prm["x0"]) \
                    + up * (prm["b"] * np.sin(ang)) + forward * prm["fwd"]
            else:  # slide
                pos = pos + right * prm["interval"] * i
            t = -base.R @ pos
            caps.append((base.R, t.astype(np.float32), base.camera_id))
        return caps

    # ------------------------------------------------------------ items

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
        if self.split == "anim":
            R, t, cam_id = self.anim_caps[idx]
            datum = {"manual_rotmat": self.manual_rotmat,
                     "manual_trans": self.manual_trans,
                     "manual_scale": self.manual_scale}
        else:
            im = self.colmap.images[idx]
            R, t, cam_id = im.R, im.t, im.camera_id
            datum = self._capture(idx)
        cam, w, h, fovx, fovy = self._camera_of(R, t, cam_id)
        datum.update({
            "camera": cam, "width": w, "height": h,
            "fovx": fovx, "fovy": fovy, "near": 0.01, "far": 100.0,
            "betas": self.smpl_params["betas"][idx],
            "global_orient": self.smpl_params["global_orient"][idx],
            "body_pose": self.smpl_params["body_pose"][idx],
            "transl": self.smpl_params["transl"][idx],
            "smpl_scale": self.smpl_params["scale"][idx],
        })
        return datum

    def _capture(self, idx: int) -> dict[str, Any]:
        """Capture idx's image, human mask and the mask's box."""
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
        return {
            "rgb": torch.as_tensor(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                                   device=self.device),
            "mask": torch.as_tensor(msk, device=self.device),
            "bbox": np.array([xmin, ymin, xmax, ymax], np.float32),
        }

    def __getitem__(self, i):
        if self.cached_data is not None:
            return self.cached_data[i]
        return self.get_single_item(i)
