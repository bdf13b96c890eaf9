"""Band- and frame-parallel rendering over a Mesh (the counterpart of
hugs_tpu/parallel/shard.py).

A band is the single-device pipeline unchanged: the whole Gaussian set
projected at the frame's size, its means shifted by -y0 into the band's
frame, binned against the band's 16x16 tile grid and blended by K1 (its
plain version on the CPU; K2 differentiates it). Bands are
band_height(H, n) rows, a multiple of 16, so the last one may run past
H: render_tile_sharded crops those rows after the gather, and their
gradient is zero. Band-local pixel centres round differently from the
frame's ((py - y0) - (my - y0) against py - my): a stitched frame equals
the one-band frame to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from hugs_tpu_torch.parallel.collectives import all_gather
from hugs_tpu_torch.parallel.mesh import Mesh
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.project import (
    ProjectedGaussians, project_gaussians, update_mean2d,
)
from hugs_tpu_torch.render.tiles import TILE, TileBins, bin_gaussians


def band_height(height: int, n_bands: int) -> int:
    """Rows per band: ceil(H / n_bands) rounded up to whole 16-row tiles."""
    per = -(-height // n_bands)
    return -(-per // TILE) * TILE


def band_budget(n: int, n_bands: int) -> int:
    """The default slot budget of one band of n Gaussians (the JAX
    package's max(4N / n_bands, 2^14))."""
    return max(4 * n // n_bands, 1 << 14)


def blend_band(pg: ProjectedGaussians, width: int, height: int, band: int,
               n_bands: int, budget: int, bg: torch.Tensor,
               ) -> tuple[torch.Tensor, TileBins]:
    """Band `band` of n_bands of a frame already projected at width x
    height, its means already in the frame's pixels: shifted by -y0,
    binned at the band's height and blended. Returns ((3, band_h, W) in
    [0, 1], its bins)."""
    band_h = band_height(height, n_bands)
    y0 = float(band * band_h)
    pg = update_mean2d(pg, pg.mean2d.new_tensor([0.0, -y0]))
    bins = bin_gaussians(pg, width, band_h, budget, TILE)
    return cuda_blend.blend_tiles(pg, bins, width, band_h, bg), bins


def render_band(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotq: torch.Tensor,
    opacity: torch.Tensor,
    shs: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    band: int,
    n_bands: int,
    bg: torch.Tensor | None = None,
    active_sh_degree: torch.Tensor | int = 0,
    scaling_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
    mean2d_grad_hook: torch.Tensor | None = None,
    instance_budget: int | None = None,
) -> dict:
    """One rank's body of render_tile_sharded as a plain function:
    project at width x height, mean2d += hook - [0, y0], bin at the
    band's height, K1. Returns render's dict for the band: 'render'
    (3, band_h, W), 'radii', 'visibility_filter' and the binning's
    'overflowed', 'n_instances', 'n_slots'; the budget defaults to
    band_budget(N, n_bands)."""
    n = means3d.shape[0]
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=means3d.device)
    pg = project_gaussians(means3d, scales, rotq, opacity, shs, camera,
                           width, height, active_sh_degree, scaling_modifier,
                           alive=alive)
    band_h = band_height(height, n_bands)
    shift = pg.mean2d.new_tensor([0.0, -float(band * band_h)])
    pg = update_mean2d(pg, shift if mean2d_grad_hook is None
                       else mean2d_grad_hook + shift)
    bins = bin_gaussians(pg, width, band_h,
                         instance_budget or band_budget(n, n_bands), TILE)
    return {"render": cuda_blend.blend_tiles(pg, bins, width, band_h, bg),
            "radii": pg.radius,
            "visibility_filter": pg.mask & (pg.radius > 0),
            "overflowed": bins.overflowed, "n_instances": bins.n_instances,
            "n_slots": bins.n_slots}


def render_tile_sharded(means3d, scales, rotq, opacity, shs, camera: Camera,
                        width: int, height: int, mesh: Mesh, bg=None,
                        active_sh_degree=0, scaling_modifier: float = 1.0,
                        alive=None, mean2d_grad_hook=None,
                        instance_budget: int | None = None) -> torch.Tensor:
    """Differentiable tile-sharded render -> (3, H, W): render_band at
    this rank's tile coordinate, the bands gathered over 'tile' and
    cropped to H. The budget is per band."""
    out = render_band(means3d, scales, rotq, opacity, shs, camera, width,
                      height, mesh.coords["tile"], mesh.shape["tile"], bg,
                      active_sh_degree, scaling_modifier, alive,
                      mean2d_grad_hook, instance_budget)
    return all_gather(out["render"], mesh, "tile", dim=1)[:, :height]


def batch_render_sharded(render_one, frames: list, mesh: Mesh,
                         axis: str = "data") -> torch.Tensor:
    """Renders a batch of frames split over `axis`: each rank maps
    render_one (frame -> (3, H, W)) over its share, in order, and the
    shares are gathered. len(frames) is a multiple of the axis size.
    Returns (B, 3, H, W) on every rank."""
    n = mesh.axis_size(axis)
    if len(frames) % n:
        raise ValueError(f"{len(frames)} frames do not split over {n} "
                         f"'{axis}' ranks")
    per = len(frames) // n
    c = mesh.coords[axis]
    local = torch.stack([render_one(f) for f in frames[c * per:(c + 1) * per]])
    return all_gather(local, mesh, axis, dim=0)
