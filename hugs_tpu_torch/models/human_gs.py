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

import copy
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from hugs_tpu_torch.models.mesh import unique_edges, vertex_normals
from hugs_tpu_torch.models.nets import (
    appearance_decoder_apply, appearance_decoder_init,
    deformation_decoder_apply, deformation_decoder_init,
    geometry_decoder_apply, geometry_decoder_init, triplane_apply,
    triplane_init,
)
from hugs_tpu_torch.models.smpl import (
    SMPLModel, lbs_extra, smpl_forward, vitruvian_pose,
)
from hugs_tpu_torch.ops.knn import knn
from hugs_tpu_torch.ops.rotations import (
    axis_angle_to_rotation_6d, matrix_to_quat, matrix_to_rotation_6d,
    quat_multiply, rotation_6d_to_axis_angle, rotation_6d_to_matrix,
    rotation_matrix_from_vectors,
)
from hugs_tpu_torch.utils import profiling

SCALE_Z = 1e-5
STATE_ROW_FIELDS = ("scaling_multiplier", "max_radii2d",
                    "xyz_gradient_accum", "denom")


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


def to_device(x, device):
    """A copy on `device` of an avatar's parts: a module, a NamedTuple
    (HumanGSState, HumanGSFixed, SMPLModel) or dict of tensors, or a
    tensor; other leaves (parents, faces, None) as they are."""
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


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


@torch.no_grad()
def compact_for_inference(
    params: HumanGS, state: HumanGSState, canon_out: dict,
    bucket: int | None = None,
) -> tuple[HumanGS, HumanGSState, dict]:
    """Serving-time capacity right-sizing (counterpart of
    scene_gs.compact): gather the alive rows of the per-Gaussian arrays
    (params.xyz, the state's rows and the cached canonical decode) into a
    bucket sized to the live population (default: the next power of two,
    at least 128), so that skinning and rendering stop paying for the
    training capacity's rows. Run canon_forward first and compact its
    output. Pad rows repeat row 0 with alive False, so they render
    nothing. The nets and per-frame pose tables are shared with `params`,
    not copied."""
    idx = torch.nonzero(state.alive).flatten()
    n = max(int(idx.numel()), 1)
    cap = int(bucket) if bucket else max(128, 1 << int(np.ceil(np.log2(n))))
    if cap < n:
        raise ValueError(f"bucket {cap} < {n} alive gaussians")
    gather = torch.zeros(cap, dtype=torch.int64, device=idx.device)
    gather[:idx.numel()] = idx

    new_params = HumanGS(
        xyz=params.xyz.detach()[gather], triplane=params.triplane,
        appearance_dec=params.appearance_dec,
        geometry_dec=params.geometry_dec,
        deformation_dec=params.deformation_dec,
        global_orient=params.global_orient, body_pose=params.body_pose,
        transl=params.transl, betas=params.betas)
    state = state._replace(
        alive=torch.arange(cap, device=idx.device) < idx.numel(),
        **{f: getattr(state, f)[gather] for f in STATE_ROW_FIELDS})

    def canon_field(k, v):
        if v is None:
            return None
        if k == "posedirs":   # (207, 3N) reference layout, not row-major
            return v.reshape(207, -1, 3)[:, gather, :].reshape(207, -1)
        return v[gather]

    canon_out = {k: canon_field(k, v) for k, v in canon_out.items()}
    return new_params, state, canon_out


def _pose_row(table: torch.Tensor, dataset_idx) -> torch.Tensor:
    """Row dataset_idx of a per-frame table: an int, or a 0-d int64
    tensor on the table's device, read there (a captured step's index,
    train/graph_step.py), by index_select, whose backward adds into
    zeros: the same gradient as the int's."""
    if isinstance(dataset_idx, torch.Tensor):
        return torch.index_select(table, 0, dataset_idx.reshape(1))[0]
    return table[dataset_idx]


def resolve_pose(params: HumanGS, dataset_idx, global_orient=None,
                 body_pose=None, betas=None, transl=None):
    """Use caller-provided SMPL params, else the learned per-frame ones
    (reference hugs_trimlp.py:442-454)."""
    if global_orient is None:
        global_orient = rotation_6d_to_axis_angle(
            _pose_row(params.global_orient, dataset_idx).reshape(1, 6)) \
            .reshape(3)
    if body_pose is None:
        body_pose = rotation_6d_to_axis_angle(
            _pose_row(params.body_pose, dataset_idx).reshape(23, 6)) \
            .reshape(69)
    if betas is None:
        betas = params.betas
    if transl is None:
        transl = _pose_row(params.transl, dataset_idx)
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
            with profiling.span("human.knn_targets", device=True):
                _, gt_lbs_weights = smpl_lbsweight_top_k(
                    fixed.smpl.lbs_weights, gs_xyz.detach(),
                    fixed.vitruvian_verts)
            gt_lbs_weights = gt_lbs_weights.detach()
    else:
        curr_offsets = s_out.shape_offsets + s_out.pose_offsets
        T_v2t = fixed.inv_T_t2vitruvian.clone()
        T_v2t[..., :3, 3] += fixed.canonical_offsets - curr_offsets
        T_vitruvian2pose = torch.matmul(s_out.T, T_v2t)
        with profiling.span("human.knn_targets", device=True):
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


@torch.no_grad()
def densify_and_prune(
    params: HumanGS,
    state: HumanGSState,
    xyz_moments: list,
    human_gs_out: dict,
    noise: torch.Tensor,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    max_n_gaussians: int | None = None,
) -> dict:
    """Densify / clone / split / prune of the human Gaussians at fixed
    capacity (reference hugs_trimlp.py:794-878), in place on params.xyz,
    the state and the xyz Adam moments `xyz_moments` ([mu, nu]).

    Only the canonical xyz and the per-row scaling_multiplier densify;
    the criteria read the attributes the current forward decoded
    (human_gs_out's opacity, scales_canon and rotmat_canon):
      clone: grad >= threshold and max scale <= percent_dense * extent;
      split: grad >= threshold, max scale > percent_dense * extent and
             elongated (a scale at least twice the median); split_n
             samples, multiplier / (0.8 split_n); the original is pruned;
      prune: opacity < min_opacity, and with max_screen_size also
             radius2d > max_screen_size or max scale > 0.1 * extent.
    noise: (split_n, C, 3) standard normal draws for the split samples,
    drawn by the caller. New rows go into dead rows in index order
    (candidates past the free rows are dropped) with their xyz moments
    zeroed; the statistics reset. Returns the counts n_cloned, n_split,
    n_pruned, n_dropped and n_alive."""
    cap = params.xyz.shape[0]
    split_n = noise.shape[0]
    grads = torch.where(state.denom > 0,
                        state.xyz_gradient_accum / state.denom, 0.0)
    opac = human_gs_out["opacity"].reshape(-1)
    scales = human_gs_out["scales_canon"]
    rotmat = human_gs_out["rotmat_canon"]
    max_scale = torch.max(scales, dim=-1).values

    hot = (grads >= grad_threshold) & state.alive
    if max_n_gaussians is not None:
        hot = hot & (torch.sum(state.alive) <= max_n_gaussians)
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)
    # the elongated-Gaussian filter (hugs_trimlp.py:820-823); the median
    # of 3 is the middle value in both packages
    med = torch.median(scales, dim=-1, keepdim=True).values
    elongated = torch.any((scales - med) / torch.clamp(med, min=1e-12)
                          >= 1.0, dim=-1)
    split_sel = split_sel & elongated

    prune = opac < min_opacity
    if max_screen_size is not None:
        prune = prune | (state.max_radii2d > max_screen_size) \
            | (max_scale > 0.1 * extent)
    prune = (prune | split_sel) & state.alive
    alive = state.alive & ~prune

    # candidates: every row as a clone, then split_n samples of every row
    samples = torch.einsum("cij,scj->sci", rotmat,
                           noise * torch.relu(scales)[None])
    split_xyz = (params.xyz[None] + samples).reshape(split_n * cap, 3)
    cand_xyz = torch.cat([params.xyz, split_xyz])
    mult = state.scaling_multiplier
    cand_mult = torch.cat([mult, (mult / (0.8 * split_n)).repeat(split_n,
                                                                  1)])
    cand_valid = torch.cat([clone_sel, split_sel.repeat(split_n)])

    cand_rank = torch.cumsum(cand_valid.to(torch.int64), 0) - 1
    # free rows in index order: a stable sort puts alive=False first
    free_rows = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = cap - torch.sum(alive)
    can_place = cand_valid & (cand_rank < n_free)
    dest = free_rows[torch.clamp(cand_rank, 0, cap - 1)][can_place]

    params.xyz[dest] = cand_xyz[can_place]
    mult[dest] = cand_mult[can_place]
    alive[dest] = True
    newly_used = torch.zeros(cap, dtype=torch.bool, device=alive.device)
    newly_used[dest] = True
    for m in xyz_moments:
        m[newly_used] = 0.0

    info = {
        "n_cloned": torch.sum(clone_sel),
        "n_split": torch.sum(split_sel),
        "n_pruned": torch.sum(prune & ~split_sel),
        "n_dropped": torch.sum(cand_valid & ~can_place),
        "n_alive": torch.sum(alive),
    }
    state.alive.copy_(alive)
    state.xyz_gradient_accum.zero_()
    state.denom.zero_()
    state.max_radii2d.zero_()
    return info
