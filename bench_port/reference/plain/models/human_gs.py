"""HUGS human avatar model (triplane + MLP decoders + LBS): serving and
training.

The counterpart of the JAX package's human model, split as it is:

  HumanGS       nn.Module of the optimizable parameters: canonical points,
                triplane, decoders, per-frame learned pose and translation
                in 6D, betas
  HumanGSState  NamedTuple: capacity mask, densification statistics, SH
                degree
  HumanGSFixed  NamedTuple: the SMPL body and the vitruvian
                canonicalisation transforms

Forward pipeline: triplane(xyz) -> appearance / geometry [/ deformation]
decode -> SMPL(betas, pose) joint transforms -> skin the canonical
Gaussians (predicted weights through lbs_extra, or per-vertex transforms
transferred by kNN) -> smpl_scale / transl / ext_tfs -> the flat
attribute dict the renderer takes. A server decodes once (canon_forward),
compacts (compact_for_inference) and then runs only the skinning per
frame (human_forward with canon_out).

Training (train/human_step.py) reads the parameter groups (`params_of`),
accumulates the densification statistics (`add_densification_stats`),
raises the SH degree (`one_up_sh_degree`) and densifies at fixed
capacity (`densify_and_prune`), each in place.

Human Gaussian scales are LINEAR (gelu output x scaling_multiplier), not
log-space, as in the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from bench_port.reference.plain.models.mesh import unique_edges, vertex_normals
from bench_port.reference.plain.models.nets import (
    appearance_decoder_apply, appearance_decoder_init,
    deformation_decoder_apply, deformation_decoder_init,
    geometry_decoder_apply, geometry_decoder_init, triplane_apply,
    triplane_init,
)
from bench_port.reference.plain.models.smpl import (
    SMPLModel, lbs_extra, smpl_forward, vitruvian_pose,
)
from bench_port.reference.plain.ops.knn import knn
from bench_port.reference.plain.ops.rotations import (
    axis_angle_to_rotation_6d, matrix_to_quat, matrix_to_rotation_6d,
    quat_multiply, rotation_6d_to_axis_angle, rotation_6d_to_matrix,
    rotation_matrix_from_vectors,
)

SCALE_Z = 1e-5


class HumanGSConfig(NamedTuple):
    """Static architecture and behaviour flags, each read by this module.
    The SH degree's ceiling is the trainer's argument to
    one_up_sh_degree."""
    n_features: int = 32
    triplane_res: int = 256
    use_deformer: bool = True
    disable_posedirs: bool = True
    use_surface: bool = False
    init_2d: bool = False
    isotropic: bool = False
    init_scale_multiplier: float = 0.5


class HumanGS(nn.Module):
    """Leading dim of xyz = capacity C; F learned frames.

    xyz (C, 3) canonical (vitruvian) positions; triplane, appearance_dec,
    geometry_dec, deformation_dec (nets.py modules); global_orient (F, 6)
    and body_pose (F, 23*6) in 6D, transl (F, 3), betas (10,).
    """

    def __init__(self, xyz, triplane, appearance_dec, geometry_dec,
                 deformation_dec, global_orient, body_pose, transl, betas):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.triplane = triplane
        self.appearance_dec = appearance_dec
        self.geometry_dec = geometry_dec
        self.deformation_dec = deformation_dec
        self.global_orient = nn.Parameter(global_orient)
        self.body_pose = nn.Parameter(body_pose)
        self.transl = nn.Parameter(transl)
        self.betas = nn.Parameter(betas)


class HumanGSState(NamedTuple):
    scaling_multiplier: torch.Tensor  # (C, 1)
    alive: torch.Tensor               # (C,) bool
    max_radii2d: torch.Tensor         # (C,)
    xyz_gradient_accum: torch.Tensor  # (C,)
    denom: torch.Tensor               # (C,)
    active_sh_degree: torch.Tensor    # () int32


class HumanGSFixed(NamedTuple):
    """Constants of the body, computed once when the model is built."""
    smpl: SMPLModel                   # the posing body (not subdivided)
    vitruvian_verts: torch.Tensor     # (Vs, 3) posed smpl verts, vitruvian
    inv_A_t2vitruvian: torch.Tensor   # (J, 4, 4)
    inv_T_t2vitruvian: torch.Tensor   # (Vs, 4, 4)
    canonical_offsets: torch.Tensor   # (Vs, 3) shape + pose offsets there


NET_FIELDS = ("triplane", "appearance_dec", "geometry_dec",
              "deformation_dec")
PARAM_GROUPS = ("xyz",) + NET_FIELDS + ("global_orient", "body_pose",
                                        "transl", "betas")


def params_of(params: HumanGS) -> dict:
    """The optimizer's groups by name, in the JAX package's field order:
    tensors for xyz and the pose tables, modules for the nets."""
    return {f: getattr(params, f) for f in PARAM_GROUPS}


def compute_vitruvian(smpl: SMPLModel, betas: torch.Tensor) -> HumanGSFixed:
    dev = smpl.v_template.device
    out = smpl_forward(smpl, betas, vitruvian_pose(dev),
                       torch.zeros(3, device=dev))
    return HumanGSFixed(
        smpl=smpl,
        vitruvian_verts=out.vertices.detach(),
        inv_A_t2vitruvian=torch.linalg.inv(out.A),
        inv_T_t2vitruvian=torch.linalg.inv(out.T),
        canonical_offsets=out.shape_offsets + out.pose_offsets,
    )


def init_human_gs(
    generator: torch.Generator,
    cfg: HumanGSConfig,
    smpl: SMPLModel,
    smpl_template: SMPLModel,
    betas,
    n_frames: int,
    capacity: int | None = None,
    init_body_pose: torch.Tensor | None = None,       # (F, 69) axis-angle
    init_global_orient: torch.Tensor | None = None,   # (F, 3)
    init_transl: torch.Tensor | None = None,          # (F, 3)
):
    """Build (params, state, fixed, init_values) on the bodies' device:
    the canonical Gaussians at the template's vitruvian vertices, the
    nets drawn from `generator`, and the mesh-derived targets of the
    distillation pre-fit (reference initialize(), hugs_trimlp.py:594-665).

    smpl_template may be a subdivided copy (Gaussian placement); smpl is
    the original body used for posing and kNN weight transfer.
    """
    dev = smpl.v_template.device
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    fixed = compute_vitruvian(smpl, betas)

    # template vitruvian verts = initial canonical Gaussian positions
    t_out = smpl_forward(smpl_template, betas, vitruvian_pose(dev),
                         torch.zeros(3, device=dev))
    t_verts = t_out.vertices.detach().cpu().numpy()
    n = t_verts.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} template vertices")

    # per-vertex max incident edge length -> init scale (linear space)
    edges = unique_edges(smpl_template.faces)
    elen = np.linalg.norm(t_verts[edges[:, 0]] - t_verts[edges[:, 1]],
                          axis=-1) * cfg.init_scale_multiplier
    max_len = np.zeros(n, np.float32)
    np.maximum.at(max_len, edges[:, 0], elen)
    np.maximum.at(max_len, edges[:, 1], elen)
    scales = np.repeat(max_len[:, None], 3, axis=1)
    if cfg.use_surface or cfg.init_2d:
        scales[:, 2] = SCALE_Z

    # rotations aligning gaussian +z to mesh vertex normals
    normals = vertex_normals(t_verts, smpl_template.faces)
    z = np.zeros_like(normals)
    z[:, 2] = 1.0
    rotmat = rotation_matrix_from_vectors(torch.as_tensor(z, device=dev),
                                          torch.as_tensor(normals,
                                                          device=dev))
    rot6d = matrix_to_rotation_6d(rotmat)

    def pad(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        out = torch.zeros((capacity,) + tuple(x.shape[1:]),
                          dtype=torch.float32, device=dev)
        out[:x.shape[0]] = x
        return out

    shs = torch.zeros((n, 16, 3), device=dev)
    shs[:, 0, :] = 0.5
    init_values = {
        "xyz_offsets": torch.zeros((capacity, 3), device=dev),
        "scales": pad(scales),
        "rot6d_canon": pad(rot6d),
        "shs": pad(shs),
        "opacity": pad(0.1 * torch.ones((n, 1), device=dev)),
        "lbs_weights": pad(smpl_template.lbs_weights),
        "posedirs": smpl_template.posedirs,
        "edges": edges,
    }

    nf3 = cfg.n_features * 3
    ident6 = torch.tensor([1.0, 0, 0, 0, 1, 0], device=dev)
    if init_global_orient is not None:
        global_orient = axis_angle_to_rotation_6d(torch.as_tensor(
            init_global_orient, dtype=torch.float32,
            device=dev).reshape(-1, 3)).reshape(n_frames, 6)
    else:
        global_orient = ident6.repeat(n_frames, 1)
    if init_body_pose is not None:
        body_pose = axis_angle_to_rotation_6d(torch.as_tensor(
            init_body_pose, dtype=torch.float32,
            device=dev).reshape(-1, 3)).reshape(n_frames, 23 * 6)
    else:
        body_pose = ident6.repeat(n_frames, 23)
    transl = (torch.as_tensor(init_transl, dtype=torch.float32, device=dev)
              if init_transl is not None
              else torch.zeros((n_frames, 3), device=dev))
    params = HumanGS(
        xyz=pad(t_verts),
        triplane=triplane_init(generator, cfg.n_features, cfg.triplane_res,
                               device=dev),
        appearance_dec=appearance_decoder_init(generator, nf3, device=dev),
        geometry_dec=geometry_decoder_init(generator, nf3,
                                           use_surface=cfg.use_surface,
                                           device=dev),
        deformation_dec=deformation_decoder_init(
            generator, nf3, disable_posedirs=cfg.disable_posedirs,
            device=dev),
        global_orient=global_orient, body_pose=body_pose, transl=transl,
        betas=betas.clone())
    state = HumanGSState(
        scaling_multiplier=torch.ones((capacity, 1), device=dev),
        alive=torch.arange(capacity, device=dev) < n,
        max_radii2d=torch.zeros(capacity, device=dev),
        xyz_gradient_accum=torch.zeros(capacity, device=dev),
        denom=torch.zeros(capacity, device=dev),
        active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    return params, state, fixed, init_values


# ------------------------------------------------------- kNN LBS transfer

def _knn_confidence_weights(lbs_weights, dists, idxs, weight_std: float = 0.1):
    """Shared confidence-gated distance weighting (reference
    smpl_lbsweight_top_k / smpl_lbsmap_top_k, hugs_wo_trimlp.py:47-119)."""
    w_nb = lbs_weights[idxs]                          # (N, K, J)
    conf = torch.exp(-torch.sum(torch.abs(w_nb - w_nb[:, 0:1, :]), dim=-1)
                     / (2.0 * weight_std ** 2))
    conf = (conf > 0.9).to(dists.dtype)
    w = torch.exp(-dists) * conf
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return w, w_nb


def smpl_lbsweight_top_k(lbs_weights, points, template_points, K: int = 6):
    """kNN-transferred skinning weights (N, J)."""
    dists, idxs = knn(points, template_points, K)
    w, w_nb = _knn_confidence_weights(lbs_weights, dists, idxs)
    out = torch.sum(w[..., None] * w_nb, dim=1)
    dist = torch.sum(w * dists, dim=-1, keepdim=True)
    return dist, out


def smpl_lbsmap_top_k(lbs_weights, verts_transform, points, template_points,
                      K: int = 6):
    """kNN-transferred per-point 4x4 transforms."""
    dists, idxs = knn(points, template_points, K)
    w, _ = _knn_confidence_weights(lbs_weights, dists, idxs)
    tf_nb = verts_transform[idxs]                      # (N, K, 4, 4)
    tf = torch.sum(w[..., None, None] * tf_nb, dim=1)
    dist = torch.sum(w * dists, dim=-1, keepdim=True)
    return dist, tf


# ------------------------------------------------------------ forward

def canon_forward(params: HumanGS, state: HumanGSState,
                  cfg: HumanGSConfig) -> dict:
    """Triplane decode of the canonical Gaussian attributes (reference
    canon_forward, hugs_trimlp.py:205-238)."""
    feats = triplane_apply(params.triplane, params.xyz)
    app = appearance_decoder_apply(params.appearance_dec, feats)
    geo = geometry_decoder_apply(params.geometry_dec, feats)

    out = {
        "xyz_offsets": geo["xyz"],
        "scales": geo["scales"] * state.scaling_multiplier,
        "rot6d_canon": geo["rotations"],
        "shs": app["shs"].reshape(-1, 16, 3),
        "opacity": app["opacity"],
        "lbs_weights": None,
        "posedirs": None,
    }
    if cfg.use_deformer:
        dfm = deformation_decoder_apply(params.deformation_dec, feats)
        # skinning logits at temperature 0.1
        out["lbs_weights"] = torch.softmax(dfm["lbs_weights"] / 0.1, dim=-1)
        out["posedirs"] = dfm["posedirs"]
    return out


def resolve_pose(params: HumanGS, dataset_idx, global_orient=None,
                 body_pose=None, betas=None, transl=None):
    """Use caller-provided SMPL params, else the learned per-frame ones
    (reference hugs_trimlp.py:442-454)."""
    if global_orient is None:
        global_orient = rotation_6d_to_axis_angle(
            params.global_orient[dataset_idx].reshape(1, 6)).reshape(3)
    if body_pose is None:
        body_pose = rotation_6d_to_axis_angle(
            params.body_pose[dataset_idx].reshape(23, 6)).reshape(69)
    if betas is None:
        betas = params.betas
    if transl is None:
        transl = params.transl[dataset_idx]
    return global_orient, body_pose, betas, transl


def human_forward(
    params: HumanGS,
    state: HumanGSState,
    fixed: HumanGSFixed,
    cfg: HumanGSConfig,
    global_orient: torch.Tensor | None = None,
    body_pose: torch.Tensor | None = None,
    betas: torch.Tensor | None = None,
    transl: torch.Tensor | None = None,
    smpl_scale: torch.Tensor | float | None = None,
    dataset_idx: torch.Tensor | int = 0,
    ext_tfs: tuple | None = None,
    canon_out: dict | None = None,
    compute_gt_lbs: bool = True,
) -> dict[str, Any]:
    """Full posed forward -> renderer attribute dict. Pass `canon_out`
    (from canon_forward) to reuse a cached canonical decode (the
    reference's forward_test fast path, hugs_trimlp.py:240-394).

    compute_gt_lbs: the kNN-transferred skinning weights exist only for
    the LBS training loss; serving and animation pass False and skip the
    kNN."""
    if canon_out is None:
        canon_out = canon_forward(params, state, cfg)

    gs_xyz = params.xyz + canon_out["xyz_offsets"]
    gs_scales = canon_out["scales"]
    gs_rotmat = rotation_6d_to_matrix(canon_out["rot6d_canon"])
    gs_rotq = matrix_to_quat(gs_rotmat)
    gs_opacity = canon_out["opacity"][:, 0]
    gs_shs = canon_out["shs"]

    if cfg.isotropic:
        gs_scales = torch.ones_like(gs_scales) * torch.mean(
            gs_scales, dim=-1, keepdim=True)
    gs_scales_canon = gs_scales

    global_orient, body_pose, betas, transl = resolve_pose(
        params, dataset_idx, global_orient, body_pose, betas, transl)

    s_out = smpl_forward(fixed.smpl, betas, body_pose, global_orient)

    gt_lbs_weights = None
    if cfg.use_deformer:
        # vitruvian -> t-pose -> posed via per-joint transforms
        A_vitruvian2pose = torch.matmul(s_out.A, fixed.inv_A_t2vitruvian)
        deformed_xyz, lbs_T, _ = lbs_extra(
            A_vitruvian2pose, gs_xyz, canon_out["posedirs"],
            canon_out["lbs_weights"], s_out.full_pose,
            disable_posedirs=cfg.disable_posedirs)
        if compute_gt_lbs:
            _, gt_lbs_weights = smpl_lbsweight_top_k(
                fixed.smpl.lbs_weights, gs_xyz.detach(),
                fixed.vitruvian_verts)
            gt_lbs_weights = gt_lbs_weights.detach()
    else:
        curr_offsets = s_out.shape_offsets + s_out.pose_offsets
        T_v2t = fixed.inv_T_t2vitruvian.clone()
        T_v2t[..., :3, 3] += fixed.canonical_offsets - curr_offsets
        T_vitruvian2pose = torch.matmul(s_out.T, T_v2t)
        _, lbs_T = smpl_lbsmap_top_k(
            fixed.smpl.lbs_weights, T_vitruvian2pose, gs_xyz,
            fixed.vitruvian_verts, K=6)
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
        rotq = matrix_to_quat(rotmat)
        deformed_rotq = quat_multiply(rotq[None], deformed_rotq)
        deformed_rotmat = torch.einsum("ab,nbc->nac", rotmat,
                                       deformed_rotmat)

    # the rotated +z axis: column 2 of each rotation
    return {
        "xyz": deformed_xyz,
        "xyz_canon": gs_xyz,
        "xyz_offsets": canon_out["xyz_offsets"],
        "scales": gs_scales,
        "scales_canon": gs_scales_canon,
        "rotq": deformed_rotq,
        "rotq_canon": gs_rotq,
        "rotmat": deformed_rotmat,
        "rotmat_canon": gs_rotmat,
        "shs": gs_shs,
        "opacity": gs_opacity,
        "normals": deformed_rotmat[:, :, 2],
        "normals_canon": gs_rotmat[:, :, 2],
        "active_sh_degree": state.active_sh_degree,
        "rot6d_canon": canon_out["rot6d_canon"],
        "lbs_weights": canon_out["lbs_weights"],
        "posedirs": canon_out["posedirs"],
        "gt_lbs_weights": gt_lbs_weights,
        "alive": state.alive,
    }


# ---------------------------------------------------- densification

@torch.no_grad()
def add_densification_stats(state: HumanGSState, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor,
                            visibility: torch.Tensor) -> HumanGSState:
    """Accumulate screen-space gradient norms and max radii of the
    visible, alive Gaussians, in place."""
    gnorm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    vis = visibility & state.alive
    state.xyz_gradient_accum.add_(torch.where(vis, gnorm, 0.0))
    state.denom.add_(vis.to(state.denom.dtype))
    state.max_radii2d.copy_(torch.where(
        vis, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
    return state


@torch.no_grad()
def one_up_sh_degree(state: HumanGSState,
                     max_sh_degree: int) -> HumanGSState:
    state.active_sh_degree.copy_(torch.clamp(state.active_sh_degree + 1,
                                             max=max_sh_degree))
    return state
