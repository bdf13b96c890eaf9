"""The per-Gaussian-parameter human avatar, the no-triplane ablation (the
counterpart of hugs_tpu/models/human_gs_pergs.py; reference
HUGS_WO_TRIMLP, hugs/models/hugs_wo_trimlp.py:122-785).

The human is a plain 3DGS parameter set (xyz, SH features, log-scales,
quaternions, opacity logits) on the vitruvian canonical body, posed per
frame by kNN-transferred SMPL vertex transforms: no triplane, no
decoders, no learned skinning. The per-Gaussian block is a SceneGS, with
the same fields, activations and storage, so the scene's densify
(scene_gs.densify_and_prune, train/scene_step.py::scene_densify_step)
and its optimizer groups apply to it as they are; only the posing
forward differs. No trainer path selects it, in hugs_tpu or here; its
frames render through render() (K1 on the card).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.models.human_gs import (
    HumanGSFixed, compute_vitruvian, resolve_pose, smpl_lbsmap_top_k,
)
from hugs_tpu_torch.models.mesh import unique_edges, vertex_normals
from hugs_tpu_torch.models.smpl import SMPLModel, smpl_forward, vitruvian_pose
from hugs_tpu_torch.ops.rotations import (
    axis_angle_to_rotation_6d, matrix_to_quat, quat_multiply, quat_to_matrix,
    rotation_matrix_from_vectors,
)

SCALE_Z = 1e-5


class HumanPerGS(NamedTuple):
    gs: sgs.SceneGS                 # canonical Gaussians + densify stats
    global_orient: torch.Tensor     # (F, 6)
    body_pose: torch.Tensor         # (F, 23 * 6)
    transl: torch.Tensor            # (F, 3)
    betas: torch.Tensor             # (10,)


def init_human_pergs(
    smpl: SMPLModel,
    smpl_template: SMPLModel,
    betas,
    n_frames: int,
    capacity: int | None = None,
    init_scale_multiplier: float = 1.0,
    use_surface: bool = False,
    init_2d: bool = False,
    max_sh_degree: int = 3,
    init_body_pose=None, init_global_orient=None, init_transl=None,
) -> tuple[HumanPerGS, HumanGSFixed]:
    """Gaussians at the template's vitruvian vertices (reference
    initialize(), hugs_wo_trimlp.py:432-491), on the bodies' device:
    log-scales from the longest incident edge, rotations taking +z to
    the vertex normals, opacity 0.1, grey DC; the per-frame poses from
    the init_* axis-angle tables (identity where absent)."""
    dev = smpl.v_template.device
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    fixed = compute_vitruvian(smpl, betas)
    t_out = smpl_forward(smpl_template, betas, vitruvian_pose(dev),
                         torch.zeros(3, device=dev))
    t_verts = t_out.vertices.detach().cpu().numpy()
    n = t_verts.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} template vertices")
    K = (max_sh_degree + 1) ** 2

    edges = unique_edges(smpl_template.faces)
    elen = np.linalg.norm(t_verts[edges[:, 0]] - t_verts[edges[:, 1]],
                          axis=-1) * init_scale_multiplier
    max_len = np.zeros(n, np.float32)
    np.maximum.at(max_len, edges[:, 0], elen)
    np.maximum.at(max_len, edges[:, 1], elen)
    scales = np.log(np.repeat(max_len[:, None], 3, axis=1))
    if use_surface or init_2d:
        scales[:, 2] = np.log(SCALE_Z)

    normals = vertex_normals(t_verts, smpl_template.faces)
    z = np.zeros_like(normals)
    z[:, 2] = 1.0
    rotq = matrix_to_quat(rotation_matrix_from_vectors(
        torch.as_tensor(z, device=dev), torch.as_tensor(normals, device=dev)))

    def pad(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    rotation = pad(rotq)
    rotation[n:, 0] = 1.0
    gs = sgs.SceneGS(
        xyz=pad(t_verts),
        features_dc=pad(0.5 * torch.ones((n, 1, 3))),
        features_rest=torch.zeros((capacity, K - 1, 3), device=dev),
        scaling=pad(scales, fill=-10.0),
        rotation=rotation,
        opacity=pad(sgs.inverse_sigmoid(0.1 * torch.ones((n, 1)))),
        alive=torch.arange(capacity, device=dev) < n,
        max_radii2d=torch.zeros(capacity, device=dev),
        xyz_gradient_accum=torch.zeros(capacity, device=dev),
        denom=torch.zeros(capacity, device=dev),
        active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev))

    def pose6d(aa, per):
        if aa is None:
            ident = torch.tensor([1.0, 0, 0, 0, 1, 0], device=dev)
            return ident.repeat(n_frames, per)
        return axis_angle_to_rotation_6d(torch.as_tensor(
            aa, dtype=torch.float32, device=dev).reshape(-1, 3)).reshape(
                n_frames, per * 6)

    params = HumanPerGS(
        gs=gs, global_orient=pose6d(init_global_orient, 1),
        body_pose=pose6d(init_body_pose, 23),
        transl=(torch.as_tensor(init_transl, dtype=torch.float32, device=dev)
                if init_transl is not None
                else torch.zeros((n_frames, 3), device=dev)),
        betas=betas.clone())
    return params, fixed


def compact_for_inference(params: HumanPerGS,
                          bucket: int | None = None) -> HumanPerGS:
    """Serving-time right-sizing (scene_gs.compact): the forward derives
    everything row by row from the SceneGS block, so compacting it
    compacts the model."""
    return params._replace(gs=sgs.compact(params.gs, bucket))


def human_pergs_forward(
    params: HumanPerGS,
    fixed: HumanGSFixed,
    global_orient=None, body_pose=None, betas=None, transl=None,
    smpl_scale=None, dataset_idx: int | torch.Tensor = 0, ext_tfs=None,
    isotropic: bool = False,
) -> dict[str, Any]:
    """Activate and pose (reference forward, hugs_wo_trimlp.py:290-396):
    the renderer's attribute dict, as human_forward gives it."""
    out = sgs.scene_forward(params.gs)
    gs_xyz, gs_scales, gs_rotq = out["xyz"], out["scales"], out["rotq"]
    if isotropic:
        gs_scales = torch.ones_like(gs_scales) * torch.mean(
            gs_scales, dim=-1, keepdim=True)
    gs_scales_canon = gs_scales
    gs_rotmat = quat_to_matrix(gs_rotq)

    global_orient, body_pose, betas, transl = resolve_pose(
        params, dataset_idx, global_orient, body_pose, betas, transl)
    s_out = smpl_forward(fixed.smpl, betas, body_pose, global_orient)

    curr_offsets = s_out.shape_offsets + s_out.pose_offsets
    T_v2t = fixed.inv_T_t2vitruvian.clone()
    T_v2t[..., :3, 3] += fixed.canonical_offsets - curr_offsets
    T_vitruvian2pose = torch.matmul(s_out.T, T_v2t)
    _, lbs_T = smpl_lbsmap_top_k(fixed.smpl.lbs_weights, T_vitruvian2pose,
                                 gs_xyz, fixed.vitruvian_verts, K=6)
    hom = torch.cat([gs_xyz, torch.ones_like(gs_xyz[:, :1])], dim=-1)
    deformed_xyz = torch.einsum("nab,nb->na", lbs_T, hom)[:, :3]

    if smpl_scale is not None:
        deformed_xyz = deformed_xyz * smpl_scale
        gs_scales = gs_scales * smpl_scale
    if transl is not None:
        deformed_xyz = deformed_xyz + transl[None]

    deformed_rotmat = torch.matmul(lbs_T[:, :3, :3], gs_rotmat)
    deformed_rotq = matrix_to_quat(deformed_rotmat)

    if ext_tfs is not None:
        tr, rotmat, sc = ext_tfs
        deformed_xyz = tr[None] + sc * torch.einsum("ab,nb->na", rotmat,
                                                    deformed_xyz)
        gs_scales = sc * gs_scales
        deformed_rotq = quat_multiply(matrix_to_quat(rotmat)[None],
                                      deformed_rotq)
        deformed_rotmat = torch.einsum("ab,nbc->nac", rotmat,
                                       deformed_rotmat)

    # the rotated +z axis: column 2 of each rotation
    return {
        "xyz": deformed_xyz,
        "xyz_canon": gs_xyz,
        "xyz_offsets": torch.zeros_like(gs_xyz),
        "scales": gs_scales,
        "scales_canon": gs_scales_canon,
        "rotq": deformed_rotq,
        "rotq_canon": gs_rotq,
        "rotmat": deformed_rotmat,
        "rotmat_canon": gs_rotmat,
        "shs": out["shs"],
        "opacity": out["opacity"],
        "normals": deformed_rotmat[:, :, 2],
        "normals_canon": gs_rotmat[:, :, 2],
        "active_sh_degree": params.gs.active_sh_degree,
        "lbs_weights": None,
        "posedirs": None,
        "gt_lbs_weights": None,
        "alive": params.gs.alive,
    }
