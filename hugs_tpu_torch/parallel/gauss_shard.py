"""Gaussian-sharded rendering: the primitives sharded over ranks, one
fragment exchange per frame (the counterpart of hugs_tpu/parallel/
gauss_shard.py).

Rank d of a ('gauss',) mesh of D ranks owns the rows [d N/D, (d+1) N/D)
of the Gaussian set and band d of the frame, band_height(H, D) rows of
16x16 tiles. Each rank

  1. projects its rows (with the mean2d hook) and bins them against the
     whole padded grid, W x D band_h, with the unchanged bin_gaussians;
  2. builds one fragment per kept instance: its Gaussian's row of
     gauss_features (colour, opacity masked where culled, mean, conic,
     radius), its tile local to the destination band, and a key that
     orders (depth, global id);
  3. packs D packets of frag_cap rows, one per band: the instances of a
     band are one contiguous slice of the tile-sorted list, so a packet
     is a slice; rows past a band's instances are empty, and a band with
     more than frag_cap instances sets `overflowed`;
  4. exchanges the packets with one all_to_all (collectives.all_to_all,
     whose backward is the same exchange of the gradient);
  5. sorts the D x frag_cap received rows by (band-local tile, depth,
     global id) -- the single-device blend order, ties included, since
     render/tiles.py sorts each tile's list by a stable argsort of depth
     -- and rebuilds the per-tile segments with searchsorted;
  6. shifts the means by -y0 into the band's frame and blends the band
     with cuda_blend.blend_feat: K1 forward and K2 backward on the card,
     the plain blend on the CPU. The fragments' gauss_id is arange, so
     K2's atomics land on fragment rows, and the gradient reaches each
     Gaussian's owner through the packet gather and the exchange's
     transpose;
  7. gathers the bands (collectives.all_gather) and crops the frame to H.

The pack, the sort and the exchange are plain torch ops, as they are XLA
ops in hugs_tpu. K1 and K2 take 16x16 tiles and truncate nothing, so
hugs_tpu's `tile_cap`, `tile` and `backend` have no counterpart.
Band-local pixel centres round differently from the frame's
(parallel/shard.py), so the frame equals the single-device render to
float32 rounding, not bit for bit.

A loss computed identically on every rank from the gathered frame hands
the gather's reduce-scatter D equal cotangents: divide it by D before
differentiating (gauss_train.py does).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.parallel.collectives import all_gather, all_to_all, pany
from hugs_tpu_torch.parallel.mesh import GAUSS, Mesh
from hugs_tpu_torch.parallel.shard import band_height
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.blend import N_FEAT, gauss_features
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.project import (
    ProjectedGaussians, project_gaussians, update_mean2d,
)
from hugs_tpu_torch.render.tiles import (
    TILE, TileBins, bin_gaussians, tile_grid,
)

MY = 5                  # the mean's y column of gauss_features
_EMPTY_KEY = (1 << 63) - 1


class Fragments(NamedTuple):
    feat: torch.Tensor      # (D, cap, 10) gauss_features rows, 0 if empty
    meta: torch.Tensor      # (D, cap, 2) int64: band-local tile (tpd where
    #                         empty), the (depth, global id) key
    counts: torch.Tensor    # (D,) int64 rows sent to each band
    overflowed: torch.Tensor  # () bool: the budget or a packet overflowed


def depth_key(depth: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(N,) int64 keys that order (depth, global id): depth's float32 bits
    made order-preserving (hugs_tpu's pltpu_bits, shifted to unsigned) in
    the high 32 bits, the global id (< 2^31) in the low 31."""
    b = depth.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(b < 0, -(1 << 31) - b - 1, b) + (1 << 31)
    return (ordered << 31) | gid


def pack_fragments(pg: ProjectedGaussians, bins: TileBins, n_bands: int,
                   tiles_per_band: int, cap: int, gid0: int) -> Fragments:
    """Steps 2-3: the packets of this rank's instances (bins over the
    whole padded grid, align 1), band e's in packet e; gid0 is the global
    id of this rank's first row."""
    dev = pg.mean2d.device
    n_local = pg.mean2d.shape[0]
    num_tiles = n_bands * tiles_per_band
    starts_ext = torch.cat([bins.starts.to(torch.int64),
                            bins.aligned_total.reshape(1).to(torch.int64)])
    band = torch.arange(n_bands, device=dev)
    base = starts_ext[band * tiles_per_band]
    stop = starts_ext[(band + 1) * tiles_per_band]
    slot = base[:, None] + torch.arange(cap, device=dev)[None, :]
    in_seg = slot < stop[:, None]                              # (D, cap)
    slot = slot.clamp(max=bins.gauss_id.shape[0] - 1)
    tile = (torch.searchsorted(starts_ext, slot, right=True) - 1).clamp(
        0, num_tiles - 1)
    # empty rows point at distinct rows, so that their zero gradient adds
    # without contention
    spread = torch.arange(n_bands * cap, device=dev).reshape(n_bands, cap)
    gi = torch.where(in_seg, bins.gauss_id[slot].to(torch.int64),
                     spread % max(n_local, 1))
    rows = gauss_features(pg).index_select(0, gi.reshape(-1))
    feat = torch.where(in_seg[..., None],
                       rows.reshape(n_bands, cap, N_FEAT), 0.0)
    t_loc = torch.where(in_seg, tile - band[:, None] * tiles_per_band,
                        tiles_per_band)
    key = torch.where(in_seg, depth_key(pg.depth[gi], gi + gid0),
                      _EMPTY_KEY)
    return Fragments(feat=feat, meta=torch.stack([t_loc, key], dim=-1),
                     counts=in_seg.sum(1),
                     overflowed=bins.overflowed | (stop - base > cap).any())


def sort_fragments(feat: torch.Tensor, meta: torch.Tensor,
                   tiles_per_band: int):
    """Step 5: the received rows (D, cap, 10) and (D, cap, 2) in the
    band's blend order. Returns (feat (D cap, 10), per-tile starts and
    ends (tpd,) int32)."""
    t_loc = meta[..., 0].reshape(-1)
    order = torch.argsort(meta[..., 1].reshape(-1))
    # stable: within a tile the (depth, global id) order stays
    order = order[torch.argsort(t_loc[order], stable=True)]
    t_sorted = t_loc[order]
    tids = torch.arange(tiles_per_band, device=t_loc.device)
    starts = torch.searchsorted(t_sorted, tids, side="left").to(torch.int32)
    ends = torch.searchsorted(t_sorted, tids, side="right").to(torch.int32)
    return feat.reshape(-1, N_FEAT).index_select(0, order), starts, ends


def blend_fragments(feat: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, bg: torch.Tensor, width: int,
                    band_h: int, y0: float) -> torch.Tensor:
    """Step 6: the band (3, band_h, W) of the sorted fragments, the means
    shifted by -y0."""
    shift = feat.new_zeros(N_FEAT)
    shift[MY] = y0
    gauss_id = torch.arange(feat.shape[0], dtype=torch.int32,
                            device=feat.device)
    return cuda_blend.blend_feat(feat - shift, gauss_id, starts, ends, bg,
                                 width, band_h)


def render_gauss_local(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotq: torch.Tensor,
    opacity: torch.Tensor,
    shs: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    mesh: Mesh,
    bg: torch.Tensor | None = None,
    active_sh_degree: torch.Tensor | int = 0,
    scaling_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
    local_budget: int | None = None,
    frag_cap: int | None = None,
    mean2d_grad_hook: torch.Tensor | None = None,
    axis: str = GAUSS,
) -> dict:
    """One rank's part of render_gauss_sharded, given this rank's rows
    (N/D of them; the hook too). Returns 'render' (3, H, W), the same on
    every rank, 'overflowed' (any rank), 'frag_counts' (D, D) (row d: the
    rows rank d sent to each band), and this rank's 'radii' and
    'visibility_filter'."""
    dev = means3d.device
    n_local = means3d.shape[0]
    D, d = mesh.axis_size(axis), mesh.coords[axis]
    band_h = band_height(height, D)
    nx, ny = tile_grid(width, band_h)
    tpd = nx * ny
    budget = local_budget or max(4 * n_local, 1 << 14)
    cap = frag_cap or budget
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    pg = project_gaussians(means3d, scales, rotq, opacity, shs, camera,
                           width, height, active_sh_degree, scaling_modifier,
                           alive=alive)
    if mean2d_grad_hook is not None:
        pg = update_mean2d(pg, mean2d_grad_hook)
    bins = bin_gaussians(pg, width, D * band_h, budget, TILE)
    frags = pack_fragments(pg, bins, D, tpd, cap, d * n_local)
    feat = all_to_all(frags.feat, mesh, axis)
    meta = all_to_all(frags.meta, mesh, axis)
    f_sorted, starts, ends = sort_fragments(feat, meta, tpd)
    img = blend_fragments(f_sorted, starts, ends, bg, width, band_h,
                          float(d * band_h))
    return {"render": all_gather(img, mesh, axis, dim=1)[:, :height],
            "overflowed": pany(frags.overflowed, mesh, axis),
            "frag_counts": all_gather(frags.counts[None], mesh, axis),
            "radii": pg.radius,
            "visibility_filter": pg.mask & (pg.radius > 0)}


def local_rows(n: int, mesh: Mesh, axis: str = GAUSS) -> slice:
    """This rank's rows of n (a multiple of the axis size)."""
    D = mesh.axis_size(axis)
    if n % D:
        raise ValueError(f"N={n} must be divisible by the '{axis}' axis's "
                         f"{D} ranks")
    per = n // D
    d = mesh.coords[axis]
    return slice(d * per, (d + 1) * per)


def render_gauss_sharded(
    means3d, scales, rotq, opacity, shs,
    camera: Camera,
    width: int,
    height: int,
    mesh: Mesh,
    bg=None,
    active_sh_degree=0,
    scaling_modifier: float = 1.0,
    alive=None,
    local_budget: int | None = None,
    frag_cap: int | None = None,
    axis: str = GAUSS,
    mean2d_grad_hook=None,
) -> dict:
    """Differentiable Gaussian-sharded render of the whole set (N
    divisible by the axis's D ranks), called on every rank of the mesh
    with the same arguments: each renders its rows [d N/D, (d+1) N/D).

    local_budget: each rank's slot budget (default max(4 N/D, 2^14));
    frag_cap: the rows of one (sender, band) packet (default the local
    budget, which always fits; smaller cuts the exchange, and a band that
    does not fit sets 'overflowed'); mean2d_grad_hook: (N, 2) zeros whose
    gradient is the pixel-space mean2d gradient.

    Returns 'render' (3, H, W), 'overflowed' (the local budget or a
    packet on any rank), 'frag_counts' (D, D) int64, and 'radii' and
    'visibility_filter' (N,) (each rank's rows computed by their owner,
    gathered)."""
    rows = local_rows(means3d.shape[0], mesh, axis)
    hook = None if mean2d_grad_hook is None else mean2d_grad_hook[rows]
    out = render_gauss_local(
        means3d[rows], scales[rows], rotq[rows], opacity.reshape(-1)[rows],
        shs[rows], camera, width, height, mesh, bg, active_sh_degree,
        scaling_modifier, None if alive is None else alive[rows],
        local_budget, frag_cap, hook, axis)
    out["radii"] = all_gather(out["radii"].detach(), mesh, axis)
    out["visibility_filter"] = all_gather(
        out["visibility_filter"].to(torch.uint8), mesh, axis).bool()
    return out
