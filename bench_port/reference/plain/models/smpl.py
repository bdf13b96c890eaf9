"""SMPL body model, plain PyTorch.

Shape blend-shapes -> joint regression -> pose blend-shapes ->
kinematic chain -> linear blend skinning, with the extra outputs HUGS
needs (per-joint transforms A, per-vertex transforms T, shape and pose
offsets, the full axis-angle pose).

SMPLModel is a NamedTuple of tensors plus the kinematic tree `parents`
(a tuple, and as `parent_index` a device tensor for the chain's gather)
and the triangles `faces` (a numpy array). It loads from:
  - the standard SMPL_NEUTRAL.pkl (chumpy arrays through a shim),
  - an .npz with the same field names,
  - or `synthetic_smpl()`: a deterministic articulated body with the real
    SMPL kinematic tree, for tests and demos where the license-gated SMPL
    files are absent. Its numpy construction is the JAX package's, draw
    for draw, so both packages build the same body.

Contractions run in float32; on the GPU they need TF32 off (PyTorch's
default for matmuls), since skinned positions feed pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench_port.reference.plain.ops.rotations import axis_angle_to_matrix

NUM_JOINTS = 24          # incl. root
NUM_BODY_JOINTS = 23
NUM_POSE_FEATURES = 207  # 23 * 9

# SMPL kinematic tree (standard, public): parent of each of the 24 joints.
SMPL_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 20, 21])

# Approximate T-pose joint positions (meters) for the synthetic model.
_SYNTH_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.07, -0.08, 0.00],   # 1 L hip
    [-0.07, -0.08, 0.00],  # 2 R hip
    [0.00, 0.10, 0.00],    # 3 spine1
    [0.10, -0.48, 0.00],   # 4 L knee
    [-0.10, -0.48, 0.00],  # 5 R knee
    [0.00, 0.23, 0.00],    # 6 spine2
    [0.09, -0.88, -0.02],  # 7 L ankle
    [-0.09, -0.88, -0.02], # 8 R ankle
    [0.00, 0.30, 0.00],    # 9 spine3
    [0.11, -0.94, 0.10],   # 10 L foot
    [-0.11, -0.94, 0.10],  # 11 R foot
    [0.00, 0.45, 0.00],    # 12 neck
    [0.08, 0.38, 0.00],    # 13 L collar
    [-0.08, 0.38, 0.00],   # 14 R collar
    [0.00, 0.55, 0.03],    # 15 head
    [0.18, 0.40, 0.00],    # 16 L shoulder
    [-0.18, 0.40, 0.00],   # 17 R shoulder
    [0.42, 0.38, 0.00],    # 18 L elbow
    [-0.42, 0.38, 0.00],   # 19 R elbow
    [0.65, 0.37, 0.00],    # 20 L wrist
    [-0.65, 0.37, 0.00],   # 21 R wrist
    [0.72, 0.36, 0.00],    # 22 L hand
    [-0.72, 0.36, 0.00],   # 23 R hand
], np.float32)


class SMPLModel(NamedTuple):
    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, B)
    posedirs: torch.Tensor     # (P, V*3)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: tuple             # (J,) parent joint of each joint, root -1
    faces: np.ndarray          # (F, 3) int64
    parent_index: torch.Tensor  # (J-1,) int64, parents[1:] on the device

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]


def make_smpl_model(v_template, shapedirs, posedirs, J_regressor,
                    lbs_weights, parents, faces,
                    device: torch.device | str = "cuda") -> SMPLModel:
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    parents = tuple(int(p) for p in np.asarray(parents).ravel())
    return SMPLModel(
        v_template=t(v_template), shapedirs=t(shapedirs),
        posedirs=t(posedirs), J_regressor=t(J_regressor),
        lbs_weights=t(lbs_weights), parents=parents,
        faces=np.asarray(faces, np.int64).reshape(-1, 3),
        parent_index=torch.tensor(parents[1:], dtype=torch.int64,
                                  device=device))


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor       # (V, 3)
    joints: torch.Tensor         # (J, 3)
    A: torch.Tensor              # (J, 4, 4) per-joint transforms (rel. T-pose)
    T: torch.Tensor              # (V, 4, 4) per-vertex skinning transforms
    v_posed: torch.Tensor        # (V, 3) shaped + pose-corrected rest verts
    v_shaped: torch.Tensor       # (V, 3)
    shape_offsets: torch.Tensor  # (V, 3)
    pose_offsets: torch.Tensor   # (V, 3)
    full_pose: torch.Tensor      # (J*3,) axis-angle incl. global orient


# ---------------------------------------------------------------- loading


def synthetic_smpl(verts_per_bone: int = 32, seed: int = 0,
                   device: torch.device | str = "cuda") -> SMPLModel:
    """Deterministic articulated test body: vertices ring-sampled around
    each bone of the real SMPL skeleton, skinning weights split between
    the bone's endpoint joints. Produces a valid SMPLModel with V =
    24*verts_per_bone vertices and zero pose blendshapes."""
    rng = np.random.RandomState(seed)
    joints = _SYNTH_JOINTS
    V = NUM_JOINTS * verts_per_bone
    verts = np.zeros((V, 3), np.float32)
    weights = np.zeros((V, NUM_JOINTS), np.float32)
    for j in range(NUM_JOINTS):
        parent = SMPL_PARENTS[j]
        a = joints[parent] if parent >= 0 else joints[j] + [0, 0.05, 0]
        b = joints[j]
        ts = np.linspace(0.05, 0.95, verts_per_bone)
        axis = b - a
        ortho = rng.randn(verts_per_bone, 3).astype(np.float32)
        axis_n = axis / (np.linalg.norm(axis) + 1e-8)
        ortho -= ortho @ axis_n[:, None] * axis_n[None]
        ortho /= np.linalg.norm(ortho, axis=-1, keepdims=True) + 1e-8
        radius = 0.04
        pts = a[None] + ts[:, None] * axis[None] + radius * ortho
        sl = slice(j * verts_per_bone, (j + 1) * verts_per_bone)
        verts[sl] = pts
        weights[sl, j] = ts
        weights[sl, parent if parent >= 0 else j] += 1.0 - ts

    # J_regressor: joints as weighted averages of the nearest vertices
    jreg = np.zeros((NUM_JOINTS, V), np.float32)
    d = np.linalg.norm(verts[None] - joints[:, None], axis=-1)
    near = np.argsort(d, axis=1)[:, :8]
    for j in range(NUM_JOINTS):
        jreg[j, near[j]] = 1.0 / 8.0

    shapedirs = rng.randn(V, 3, 10).astype(np.float32) * 0.01
    posedirs = np.zeros((NUM_POSE_FEATURES, V * 3), np.float32)
    # a fake triangulation: consecutive triplets along each bone ring
    faces = np.stack([np.arange(V - 2), np.arange(1, V - 1),
                      np.arange(2, V)], axis=1)
    return make_smpl_model(verts, shapedirs, posedirs, jreg,
                           weights / weights.sum(-1, keepdims=True),
                           SMPL_PARENTS, faces, device=device)


# ---------------------------------------------------------------- LBS math

def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: tuple, parent_index: torch.Tensor):
    """Kinematic chain composition (smplx semantics).

    rot_mats: (J, 3, 3) local joint rotations; joints: (J, 3) rest joint
    positions; parent_index: parents[1:] as a tensor on joints' device.
    Returns (posed_joints (J, 3), A (J, 4, 4)) where A are the
    relative-to-rest skinning transforms. The chain runs as one 4x4
    product per joint, in the tree's order.
    """
    J = joints.shape[0]
    rel_joints = torch.cat([joints[:1], joints[1:] - joints[parent_index]],
                           dim=0)

    # the local transforms [R t; 0 0 0 1] of every joint at once, the
    # last row made on the device (no host copy per frame)
    local = torch.cat([rot_mats, rel_joints[:, :, None]], dim=2)
    local = torch.cat([local, torch.zeros_like(local[:, :1])], dim=1)
    local[:, 3, 3] = 1.0                                       # (J, 4, 4)
    chains = [local[0]]
    for j in range(1, J):
        chains.append(torch.matmul(chains[parents[j]], local[j]))
    transforms = torch.stack(chains)                           # (J, 4, 4)

    posed_joints = transforms[:, :3, 3]
    # subtract rest-joint contribution: A = G - pack(G @ [j, 0])
    joints_hom = torch.cat([joints, torch.zeros_like(joints[:, :1])], dim=1)
    correction = torch.einsum("jab,jb->ja", transforms, joints_hom)  # (J, 4)
    A = torch.cat([transforms[:, :, :3],
                   (transforms[:, :, 3] - correction)[:, :, None]], dim=2)
    return posed_joints, A


def smpl_forward(model: SMPLModel, betas: torch.Tensor,
                 body_pose: torch.Tensor, global_orient: torch.Tensor,
                 transl: torch.Tensor | None = None,
                 disable_posedirs: bool = False,
                 vert_offsets: torch.Tensor | None = None) -> SMPLOutput:
    """Single-sample SMPL forward.

    betas (B,), body_pose (69,) axis-angle, global_orient (3,).
    """
    full_pose = torch.cat([global_orient.reshape(3),
                           body_pose.reshape(NUM_BODY_JOINTS * 3)])
    shape_offsets = torch.einsum("vcb,b->vc", model.shapedirs, betas)
    v_shaped = model.v_template + shape_offsets
    joints = torch.matmul(model.J_regressor, v_shaped)        # (J, 3)

    rot_mats = axis_angle_to_matrix(full_pose.reshape(NUM_JOINTS, 3))
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[1:] - ident).reshape(-1)         # (207,)
    if disable_posedirs or model.posedirs.shape[0] == 0:
        pose_offsets = torch.zeros_like(v_shaped)
    else:
        pose_offsets = torch.matmul(pose_feature,
                                    model.posedirs).reshape(-1, 3)
    v_posed = v_shaped + pose_offsets
    if vert_offsets is not None:
        v_posed = v_posed + vert_offsets

    posed_joints, A = batch_rigid_transform(rot_mats, joints, model.parents,
                                            model.parent_index)

    T = torch.einsum("vj,jab->vab", model.lbs_weights, A)     # (V, 4, 4)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[:, :1])], dim=-1)
    verts = torch.einsum("vab,vb->va", T, v_hom)[:, :3]
    if transl is not None:
        verts = verts + transl[None]
        posed_joints = posed_joints + transl[None]
    return SMPLOutput(vertices=verts, joints=posed_joints, A=A, T=T,
                      v_posed=v_posed, v_shaped=v_shaped,
                      shape_offsets=shape_offsets, pose_offsets=pose_offsets,
                      full_pose=full_pose)


def lbs_extra(A: torch.Tensor, points: torch.Tensor,
              posedirs: torch.Tensor | None, lbs_weights: torch.Tensor,
              full_pose: torch.Tensor, disable_posedirs: bool = False):
    """Skin an arbitrary point set with per-joint transforms A and
    per-point predicted weights (reference lbs_extra, lbs.py:19-73).

    A (J, 4, 4); points (N, 3); posedirs (207, N*3) or None;
    lbs_weights (N, J); full_pose (J*3,) axis-angle.
    Returns (deformed points (N, 3), T (N, 4, 4), v_posed (N, 3)).
    """
    if disable_posedirs or posedirs is None:
        v_posed = points
    else:
        rot_mats = axis_angle_to_matrix(full_pose.reshape(NUM_JOINTS, 3))
        ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[1:] - ident).reshape(-1)
        pose_offsets = torch.matmul(pose_feature, posedirs).reshape(-1, 3)
        v_posed = points + pose_offsets

    T = torch.einsum("nj,jab->nab", lbs_weights, A)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[:, :1])], dim=-1)
    deformed = torch.einsum("nab,nb->na", T, v_hom)[:, :3]
    return deformed, T, v_posed


def vitruvian_pose(device: torch.device | str = "cuda") -> torch.Tensor:
    """The HUGS canonical 'vitruvian' body pose: legs spread by +-1 rad
    about z at the hips."""
    pose = torch.zeros(NUM_BODY_JOINTS * 3, device=device)
    pose[2] = 1.0    # left hip z
    pose[5] = -1.0   # right hip z
    return pose
