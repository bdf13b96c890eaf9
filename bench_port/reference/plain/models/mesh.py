"""Mesh utilities: unique edges, vertex normals, midpoint subdivision,
Laplacian smoothing — numpy (host-side, init-time only). A copy of the
JAX package's numpy module, so that both build the same mesh.

Replaces the reference's trimesh dependencies: edges_unique
(hugs_trimlp.py:116-120), vertex_normals (hugs_trimlp.py:630-632), the
loop-style midpoint `subdivide` with attribute averaging
(hugs/utils/subdivide_smpl.py:16-71), and the smoothing filter
(subdivide_smpl.py:99-108 — approximated here by volume-preserving
Humphrey-Taubin smoothing; affects only the init mesh slightly).
"""
from __future__ import annotations

import numpy as np


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """(F, 3) faces -> (E, 2) sorted unique undirected edges."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)        # area-weighted face normals
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.clip(norm, 1e-12, None)


def subdivide(vertices: np.ndarray, faces: np.ndarray,
              vertex_attributes: dict | None = None):
    """One round of midpoint (loop-topology) subdivision; midpoint
    attributes are edge-endpoint averages (reference subdivide,
    subdivide_smpl.py:16-71)."""
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0),
        axis=1)
    uniq, inverse = np.unique(edges, axis=0, return_inverse=True)
    mid = vertices[uniq].mean(axis=1)
    mid_idx = inverse.reshape(3, -1).T + len(vertices)  # (F, 3): e01,e12,e20
    f = np.column_stack([
        faces[:, 0], mid_idx[:, 0], mid_idx[:, 2],
        mid_idx[:, 0], faces[:, 1], mid_idx[:, 1],
        mid_idx[:, 2], mid_idx[:, 1], faces[:, 2],
        mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2],
    ]).reshape(-1, 3)
    new_vertices = np.vstack([vertices, mid])
    new_attrs = None
    if vertex_attributes is not None:
        new_attrs = {}
        for key, values in vertex_attributes.items():
            attr_mid = values[uniq].mean(axis=1)
            new_attrs[key] = np.vstack([values, attr_mid])
    return new_vertices, f, new_attrs


def smooth_humphrey(verts: np.ndarray, faces: np.ndarray, alpha: float = 0.1,
                    beta: float = 0.5, iterations: int = 5) -> np.ndarray:
    """Volume-preserving HC (Humphrey's classes) Laplacian smoothing."""
    edges = unique_edges(faces)
    n = len(verts)
    deg = np.zeros(n)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    deg = np.clip(deg, 1, None)[:, None]

    orig = verts.copy()
    p = verts.copy()
    for _ in range(iterations):
        nb = np.zeros_like(p)
        np.add.at(nb, edges[:, 0], p[edges[:, 1]])
        np.add.at(nb, edges[:, 1], p[edges[:, 0]])
        q = p
        p = nb / deg
        b = p - (alpha * orig + (1 - alpha) * q)
        nb_b = np.zeros_like(b)
        np.add.at(nb_b, edges[:, 0], b[edges[:, 1]])
        np.add.at(nb_b, edges[:, 1], b[edges[:, 0]])
        p = p - (beta * b + (1 - beta) * nb_b / deg)
    return p
