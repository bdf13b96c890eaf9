"""3DGS-format PLY import/export (binary little-endian), no plyfile dep.

Matches the attribute layout the reference writes/reads
(hugs/models/scene.py:229-308, hugs/utils/vis.py:41-60): x y z, nx ny nz,
f_dc_0..2, f_rest_0..44, opacity, scale_0..2, rot_0..3 — the
interoperability format of the 3DGS ecosystem (viewers, editors).
"""
from __future__ import annotations

import os


import numpy as np


def save_gaussian_ply(path: str, xyz: np.ndarray, features_dc: np.ndarray,
                      features_rest: np.ndarray, opacity: np.ndarray,
                      scaling: np.ndarray, rotation: np.ndarray):
    """Write raw (pre-activation) Gaussian params.

    xyz (N,3); features_dc (N,1,3); features_rest (N,K-1,3);
    opacity (N,1) logits; scaling (N,3) log; rotation (N,4).
    Feature columns are stored channel-major (N, 3*(K-1)) matching the
    reference's transpose(1,2).flatten (scene.py:248-249).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    f_dc = np.ascontiguousarray(
        np.transpose(features_dc, (0, 2, 1)).reshape(n, -1), np.float32)
    f_rest = np.ascontiguousarray(
        np.transpose(features_rest, (0, 2, 1)).reshape(n, -1), np.float32)
    normals = np.zeros_like(xyz)
    attrs = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity.reshape(n, -1),
         scaling, rotation], axis=1).astype(np.float32)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(attrs.tobytes())


def load_gaussian_ply(path: str, max_sh_degree: int = 3):
    """Read a 3DGS PLY -> dict of raw param arrays (reference load_ply,
    scene.py:267-308). Supports binary LE and ascii."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = [h for h in header if h.startswith("format")][0].split()[1]
        n = int([h for h in header if h.startswith("element vertex")][0]
                .split()[-1])
        names = [h.split()[-1] for h in header if h.startswith("property")]
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n * len(names) * 4), np.float32)
            data = data.reshape(n, len(names))
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, len(names))

    col = {nm: data[:, i] for i, nm in enumerate(names)}
    xyz = np.stack([col["x"], col["y"], col["z"]], axis=1)
    f_dc = np.stack([col[f"f_dc_{i}"] for i in range(3)],
                    axis=1).reshape(n, 3, 1).transpose(0, 2, 1)
    rest_names = sorted((nm for nm in names if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k1 = (max_sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * k1:
        raise ValueError(f"{path}: {len(rest_names)} f_rest columns, "
                         f"SH degree {max_sh_degree} needs {3 * k1}")
    f_rest = np.stack([col[nm] for nm in rest_names], axis=1)
    f_rest = f_rest.reshape(n, 3, k1).transpose(0, 2, 1)
    scaling = np.stack(
        [col[f"scale_{i}"] for i in range(3)], axis=1)
    rot_names = sorted((nm for nm in names if nm.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([col[nm] for nm in rot_names], axis=1)
    return {
        "xyz": xyz, "features_dc": np.ascontiguousarray(f_dc),
        "features_rest": np.ascontiguousarray(f_rest),
        "opacity": col["opacity"].reshape(n, 1),
        "scaling": scaling, "rotation": rotation,
    }
