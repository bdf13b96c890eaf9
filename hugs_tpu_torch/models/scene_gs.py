"""Scene Gaussian model (vanilla 3DGS): serving and training.

A fixed-capacity set of Gaussians with an `alive` mask, row for row like
the JAX package's SceneGS, so the two can be compared directly. The six
optimizable fields are nn.Parameters; the mask, the densification
statistics and the active SH degree are buffers. Densification writes
new Gaussians into dead rows and prunes by clearing `alive`, so shapes
never change. The training functions update the model and the optimizer
moments in place, under torch.no_grad(). Storage conventions follow
3DGS:
  scaling   : log-scale         (activation exp)
  opacity   : logit             (activation sigmoid)
  rotation  : unnormalized quat (activation normalize)
  features  : SH coeffs (N, K, 3), dc = coeff 0, rest = coeffs 1..K-1
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from hugs_tpu_torch.ops.covariance import build_rotation
from hugs_tpu_torch.ops.knn import mean_sq_dist_to_knn
from hugs_tpu_torch.ops.sh import rgb_to_sh
from hugs_tpu_torch.utils.ply import load_gaussian_ply

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")
BUFFER_FIELDS = ("alive", "max_radii2d", "xyz_gradient_accum", "denom",
                 "active_sh_degree")


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


class SceneGS(nn.Module):
    """All leading dims = capacity.

    xyz (C, 3), features_dc (C, 1, 3), features_rest (C, K-1, 3),
    scaling (C, 3) log, rotation (C, 4), opacity (C, 1) logit;
    alive (C,) bool, max_radii2d / xyz_gradient_accum / denom (C,),
    active_sh_degree () int32.
    """

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        missing = set(PARAM_FIELDS + BUFFER_FIELDS) - set(fields)
        if missing:
            raise ValueError(f"SceneGS needs {sorted(missing)}")
        for f in PARAM_FIELDS:
            setattr(self, f, nn.Parameter(fields[f]))
        for f in BUFFER_FIELDS:
            self.register_buffer(f, fields[f])

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    def forward(self, only_rgb: bool = False) -> dict:
        return scene_forward(self, only_rgb)


def _with_capacity(n: int, cap: int, device, xyz, features_dc,
                   features_rest, scaling, rotation, opacity,
                   opacity_fill: float, active_sh_degree: int) -> SceneGS:
    """SceneGS from n live rows, padded to cap rows with zeros, except
    log-scale -10, identity rotation and opacity logit `opacity_fill`."""
    def pad(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=device)
        out[:n] = x
        return out

    rotation = pad(rotation)
    rotation[n:, 0] = 1.0
    return SceneGS(
        xyz=pad(xyz), features_dc=pad(features_dc),
        features_rest=pad(features_rest), scaling=pad(scaling, fill=-10.0),
        rotation=rotation, opacity=pad(opacity, fill=opacity_fill),
        alive=torch.arange(cap, device=device) < n,
        max_radii2d=torch.zeros(cap, device=device),
        xyz_gradient_accum=torch.zeros(cap, device=device),
        denom=torch.zeros(cap, device=device),
        active_sh_degree=torch.tensor(active_sh_degree, dtype=torch.int32,
                                      device=device))


def create_from_pcd(points, colors, capacity: int, max_sh_degree: int = 3,
                    only_rgb: bool = False,
                    device: torch.device | str = "cuda") -> SceneGS:
    """Initialize from a point cloud (3DGS create_from_pcd): DC SH from
    RGB, log-scale from kNN density, identity rotations, opacity 0.1.
    only_rgb stores raw colours in the DC slot instead of RGB2SH."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"pcd has {n} points > capacity {capacity}")
    K = (max_sh_degree + 1) ** 2
    dist2 = torch.clamp(mean_sq_dist_to_knn(points, k=3), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), device=device)
    rots[:, 0] = 1.0
    dc = colors if only_rgb else rgb_to_sh(colors)
    return _with_capacity(
        n, capacity, device, points, dc[:, None, :],
        torch.zeros((n, K - 1, 3), device=device), scales, rots,
        inverse_sigmoid(0.1 * torch.ones((n, 1), device=device)), 0.0,
        active_sh_degree=0)


def create_from_ply(path: str, capacity: int | None = None,
                    max_sh_degree: int = 3,
                    device: torch.device | str = "cuda") -> SceneGS:
    """Load a trained 3DGS-format PLY (raw parameters: log scales, logit
    opacities, unnormalized quats). The SH degree starts at the maximum;
    capacity defaults to the next power of two >= N (at least 128)."""
    # copies: some arrays are views of the file's read-only buffer
    raw = {k: np.array(v) for k, v in
           load_gaussian_ply(path, max_sh_degree=max_sh_degree).items()}
    n = raw["xyz"].shape[0]
    cap = int(capacity) if capacity else max(
        128, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if n > cap:
        raise ValueError(f"PLY has {n} gaussians > capacity {cap}")
    return _with_capacity(
        n, cap, device, raw["xyz"], raw["features_dc"],
        raw["features_rest"], raw["scaling"], raw["rotation"],
        raw["opacity"], -10.0, active_sh_degree=max_sh_degree)


def scene_forward(gs: SceneGS, only_rgb: bool = False) -> dict:
    """Activate parameters into the flat attribute dict the renderer
    takes, plus the alive capacity mask. only_rgb=True treats
    features_dc as a raw RGB colour: 'shs' becomes (N, 3), which the
    projection takes as a precomputed colour."""
    rot = gs.rotation / torch.clamp(
        torch.linalg.norm(gs.rotation, dim=-1, keepdim=True), min=1e-8)
    shs = (gs.features_dc[:, 0, :] if only_rgb
           else torch.cat([gs.features_dc, gs.features_rest], dim=1))
    return {
        "xyz": gs.xyz,
        "scales": torch.exp(gs.scaling),
        "rotq": rot,
        "shs": shs,
        "opacity": torch.sigmoid(gs.opacity[:, 0]),
        "active_sh_degree": gs.active_sh_degree,
        "alive": gs.alive,
    }


@torch.no_grad()
def compact(gs: SceneGS, bucket: int | None = None) -> SceneGS:
    """Serving-time capacity right-sizing: gather the alive rows into a
    power-of-two bucket sized to the live population, so a frame does
    not pay for padding rows. Dead tail rows duplicate row 0 with
    alive=False (projection culls them)."""
    idx = torch.nonzero(gs.alive).flatten()
    n = max(int(idx.numel()), 1)
    cap = int(bucket) if bucket else max(128, 1 << int(np.ceil(np.log2(n))))
    if cap < n:
        raise ValueError(f"bucket {cap} < {n} alive gaussians")
    gather = torch.zeros(cap, dtype=torch.int64, device=idx.device)
    gather[:idx.numel()] = idx
    fields = {f: getattr(gs, f)[gather] for f in PARAM_FIELDS
              + ("max_radii2d", "xyz_gradient_accum", "denom")}
    fields["alive"] = torch.arange(cap, device=idx.device) < idx.numel()
    fields["active_sh_degree"] = gs.active_sh_degree.clone()
    return SceneGS(**fields)


def params_of(gs: SceneGS) -> dict[str, nn.Parameter]:
    """The six optimizable fields by name (views, not copies)."""
    return {f: getattr(gs, f) for f in PARAM_FIELDS}


@torch.no_grad()
def one_up_sh_degree(gs: SceneGS, max_sh_degree: int = 3) -> SceneGS:
    gs.active_sh_degree.copy_(torch.clamp(gs.active_sh_degree + 1,
                                          max=max_sh_degree))
    return gs


@torch.no_grad()
def add_densification_stats(gs: SceneGS, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor,
                            visibility: torch.Tensor) -> SceneGS:
    """Accumulate screen-space gradient norms and max radii for the
    visible, alive Gaussians."""
    gnorm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    vis = visibility & gs.alive
    gs.xyz_gradient_accum.add_(torch.where(vis, gnorm, 0.0))
    gs.denom.add_(vis.to(gs.denom.dtype))
    gs.max_radii2d.copy_(torch.where(
        vis, torch.maximum(gs.max_radii2d, radii), gs.max_radii2d))
    return gs


@torch.no_grad()
def densify_and_prune(
    gs: SceneGS,
    opt_moments: list[dict],
    noise: torch.Tensor,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    max_n_gaussians: int | None = None,
) -> dict:
    """The densify / clone / split / prune step of 3DGS at fixed
    capacity, in place on gs and on the moment dicts of opt_moments.

      clone: grad >= threshold and max scale <= percent_dense * extent:
             a copy;
      split: grad >= threshold and max scale > percent_dense * extent:
             split_n samples from the Gaussian, scales / (0.8 split_n);
             the original is pruned;
      prune: opacity < min_opacity, and with max_screen_size also
             radius2d > max_screen_size or max scale > 0.1 * extent.

    noise: (split_n, C, 3) standard normal draws for the split samples,
    drawn by the caller. New Gaussians go into dead rows in index order
    (candidates past the free rows are dropped), their Adam moments are
    zeroed, and the densification statistics reset. Returns the info
    counts n_cloned, n_split, n_pruned, n_dropped and n_alive."""
    cap = gs.capacity
    split_n = noise.shape[0]
    grads = torch.where(gs.denom > 0, gs.xyz_gradient_accum / gs.denom, 0.0)
    scales = torch.exp(gs.scaling)
    max_scale = torch.max(scales, dim=-1).values

    hot = (grads >= grad_threshold) & gs.alive
    if max_n_gaussians is not None:
        hot = hot & (torch.sum(gs.alive) <= max_n_gaussians)
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)

    # prune first, so the rows it frees are reusable
    prune = torch.sigmoid(gs.opacity[:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (gs.max_radii2d > max_screen_size) \
            | (max_scale > 0.1 * extent)
    prune = (prune | split_sel) & gs.alive     # split originals die too
    alive = gs.alive & ~prune

    # candidates: every row as a clone, then split_n samples of every row
    params = params_of(gs)
    R = build_rotation(gs.rotation)                          # (C, 3, 3)
    samples = torch.einsum("cij,scj->sci", R, noise * scales[None])
    split_xyz = gs.xyz[None] + samples                       # (S, C, 3)
    split_scaling = torch.log(scales / (0.8 * split_n))      # (C, 3)

    def candidates(field):
        p = params[field]
        if field == "xyz":
            rep = split_xyz.reshape(split_n * cap, 3)
        elif field == "scaling":
            rep = split_scaling.repeat(split_n, 1)
        else:
            rep = p.repeat((split_n,) + (1,) * (p.ndim - 1))
        return torch.cat([p, rep], dim=0)

    cand_valid = torch.cat([clone_sel, split_sel.repeat(split_n)])
    # free rows in index order: a stable sort puts alive=False first
    cand_rank = torch.cumsum(cand_valid.to(torch.int64), 0) - 1
    free_rows = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = cap - torch.sum(alive)
    can_place = cand_valid & (cand_rank < n_free)
    dest = free_rows[torch.clamp(cand_rank, 0, cap - 1)][can_place]

    new_rows = {f: candidates(f)[can_place] for f in PARAM_FIELDS}
    for f in PARAM_FIELDS:
        params[f][dest] = new_rows[f]
    alive[dest] = True
    newly_used = torch.zeros(cap, dtype=torch.bool, device=alive.device)
    newly_used[dest] = True
    for moments in opt_moments:
        for f in PARAM_FIELDS:
            moments[f][newly_used] = 0.0

    info = {
        "n_cloned": torch.sum(clone_sel),
        "n_split": torch.sum(split_sel),
        "n_pruned": torch.sum(prune & ~split_sel),
        "n_dropped": torch.sum(cand_valid & ~can_place),
        "n_alive": torch.sum(alive),
    }
    gs.alive.copy_(alive)
    gs.xyz_gradient_accum.zero_()
    gs.denom.zero_()
    gs.max_radii2d.zero_()
    return info


@torch.no_grad()
def reset_opacity(gs: SceneGS, opt_moments: list[dict],
                  value: float = 0.01) -> SceneGS:
    """Clamp every opacity to <= value and zero its Adam moments, in
    place."""
    gs.opacity.copy_(inverse_sigmoid(torch.clamp(torch.sigmoid(gs.opacity),
                                                 max=value)))
    for moments in opt_moments:
        moments["opacity"].zero_()
    return gs
