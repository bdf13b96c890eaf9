"""SMPL template subdivision (reference hugs/utils/subdivide_smpl.py), in
numpy on the host, as the JAX package does it.

Each round: midpoint-subdivide the template mesh, averaging lbs_weights /
shapedirs at new vertices; posedirs are zeroed for the subdivided model
and J_regressor keeps only the original-vertex columns (exactly the
reference's choices, subdivide_smpl.py:112-120). Optional smoothing of
the subdivided template. n_subdivision=2 takes SMPL 6890 -> 110,210
verts. The result lives on the input model's device.
"""
from __future__ import annotations

import numpy as np

from bench_port.reference.plain.models.mesh import smooth_humphrey, subdivide
from bench_port.reference.plain.models.smpl import (
    NUM_POSE_FEATURES, SMPLModel, make_smpl_model,
)


def subdivide_smpl_model(smpl: SMPLModel, smoothing: bool = False,
                         n_iter: int = 1) -> SMPLModel:
    def host(x):
        return x.detach().cpu().numpy()

    verts = host(smpl.v_template)
    faces = np.asarray(smpl.faces)
    lbs_w = host(smpl.lbs_weights)
    shapedirs = host(smpl.shapedirs)
    n0 = verts.shape[0]
    jreg0 = host(smpl.J_regressor)

    for _ in range(n_iter):
        n_prev = verts.shape[0]
        verts, faces, attrs = subdivide(
            verts, faces,
            {"lbs_weights": lbs_w,
             "shapedirs": shapedirs.reshape(n_prev, -1)})
        lbs_w = attrs["lbs_weights"]
        shapedirs = attrs["shapedirs"].reshape(verts.shape[0], 3, -1)
        if smoothing:
            verts = smooth_humphrey(verts, faces)

    jreg = np.zeros((jreg0.shape[0], verts.shape[0]), np.float32)
    jreg[:, :n0] = jreg0
    return make_smpl_model(
        verts, shapedirs,
        np.zeros((NUM_POSE_FEATURES, verts.shape[0] * 3), np.float32),
        jreg, lbs_w / lbs_w.sum(-1, keepdims=True), smpl.parents, faces,
        device=smpl.v_template.device)
