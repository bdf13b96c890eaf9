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

import torch
from torch import nn

from bench_port.reference.plain.ops.knn import mean_sq_dist_to_knn
from bench_port.reference.plain.ops.sh import rgb_to_sh

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
