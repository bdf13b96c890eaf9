"""Visualization exports (reference hugs/utils/vis.py).

save_human_ply: the canonical human Gaussians as a 3DGS PLY (reference
save_ply, vis.py:41-60: linear scales to log, opacity to its logit).
The skeleton and the ellipsoids as plain OBJ files (the reference drew
them with open3d and trimesh).
"""
from __future__ import annotations

import os

import numpy as np

from hugs_tpu_torch.utils.ply import save_gaussian_ply


def save_human_ply(human_gs_out: dict, path: str) -> None:
    """The live canonical Gaussians of a human_forward dict given as
    numpy arrays (xyz_canon, shs, opacity, scales_canon, rotq_canon and
    optionally alive)."""
    xyz_all = np.asarray(human_gs_out["xyz_canon"])
    alive = np.asarray(human_gs_out.get(
        "alive", np.ones(xyz_all.shape[0], bool)))
    xyz = xyz_all[alive]
    shs = np.asarray(human_gs_out["shs"])[alive]            # (N, 16, 3)
    opacity = np.asarray(human_gs_out["opacity"]).reshape(-1, 1)[alive]
    scales = np.asarray(human_gs_out["scales_canon"])[alive]
    rotq = np.asarray(human_gs_out["rotq_canon"])[alive]

    def logit(p):
        p = np.clip(p, 1e-6, 1 - 1e-6)
        return np.log(p / (1 - p))

    save_gaussian_ply(
        path, xyz, features_dc=shs[:, :1, :], features_rest=shs[:, 1:, :],
        opacity=logit(opacity), scaling=np.log(np.clip(scales, 1e-9, None)),
        rotation=rotq)


def save_skeleton_obj(joints: np.ndarray, parents, path: str) -> None:
    """The joints as OBJ vertices and each bone as a line (reference
    draw_skeleton, vis.py:233-285)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for j in np.asarray(joints):
            f.write(f"v {j[0]} {j[1]} {j[2]}\n")
        for i, p in enumerate(parents):
            if p >= 0:
                f.write(f"l {p + 1} {i + 1}\n")


def save_ellipsoids_obj(xyz, scales, rotmats, path: str, n_seg: int = 6,
                        max_points: int = 2000) -> None:
    """The first `max_points` Gaussians as n_seg x n_seg point ellipsoids
    in an OBJ (reference get_ellips_meshes, vis.py:122-163)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xyz = np.asarray(xyz)[:max_points]
    scales = np.asarray(scales)[:max_points]
    rotmats = np.asarray(rotmats)[:max_points]
    us = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    vs = np.linspace(0, np.pi, n_seg)
    sphere = np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2)
    unit = np.stack([np.cos(sphere[:, 0]) * np.sin(sphere[:, 1]),
                     np.sin(sphere[:, 0]) * np.sin(sphere[:, 1]),
                     np.cos(sphere[:, 1])], axis=1)
    with open(path, "w") as f:
        for c, s, R in zip(xyz, scales, rotmats):
            for p in (unit * s) @ R.T + c:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
