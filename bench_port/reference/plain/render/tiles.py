"""Tile binning for the splatting rasterizer, plain PyTorch.

Each Gaussian covers a rectangle of tiles; every (Gaussian, tile) pair is
an instance. Instances are enumerated in Gaussian order up to a fixed
budget (later ones are dropped and `overflowed` is set), culled where
they provably contribute nothing to the tile, and sorted once on a packed
(tile, depth-rank) key, so each tile owns a contiguous, front-to-back
segment of `gauss_id`. Shapes depend only on the budget, so binning needs
no synchronisation with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference.plain.render.oracle import MIN_ALPHA

TILE = 16


class TileBins(NamedTuple):
    # Tile t owns slots [starts[t], starts[t] + roundup(count_t, align));
    # the first count_t = ends[t] - starts[t] are valid, the rest padding
    # (gauss_id 0).
    gauss_id: torch.Tensor       # (I_align,) int32 index into the Gaussians
    starts: torch.Tensor         # (T,) int32 segment start
    ends: torch.Tensor           # (T,) int32 starts + valid count
    n_instances: torch.Tensor    # () int64 instance demand before culling
    #                              (may exceed the budget if overflowed)
    aligned_total: torch.Tensor  # () int64 end of the last written segment
    overflowed: torch.Tensor     # () bool: instance budget exceeded
    n_slots: torch.Tensor        # () int64 slot demand: instances plus
    #                              per-tile alignment padding; a budget
    #                              must cover this


def tile_wh(tile) -> tuple[int, int]:
    """Normalize a tile spec to (tile_w, tile_h): an int means square."""
    if isinstance(tile, int):
        return tile, tile
    tw, th = tile
    return int(tw), int(th)


def tile_grid(width: int, height: int, tile=TILE) -> tuple[int, int]:
    tw, th = tile_wh(tile)
    return (-(-width // tw), -(-height // th))


def _floor_index(x: torch.Tensor, hi: int, add: int = 0) -> torch.Tensor:
    """floor(x) + add as int32, clipped to [0, hi]; clamped in float first
    so that off-screen coordinates convert without overflow. The end of
    a span adds 1 before the clip, so that a span wholly left of or above
    the image is empty."""
    return (torch.clamp(torch.floor(x), -1.0, hi + 1.0).to(torch.int32)
            + add).clamp(0, hi)


def tile_spans(pg, width: int, height: int, tile=TILE):
    """Per-Gaussian covered tile rectangle [tx0, tx0 + w) x [ty0, ty0 + h).

    Spans use per-axis ellipse extents instead of the bounding square of
    the radius: the blend keeps a pixel only while
    alpha = op*exp(-q) >= 1/255, and the level set {q <= L},
    L = log(op*255), has |dx| <= sqrt(2 L cov_xx) with cov = conic^-1.
    Every pixel outside the min(ellipse extent, radius) box is zeroed by
    the blend's own cutoffs, so the image is unchanged while the instance
    count drops. Gaussians with op < 1/255 get a zero span.
    """
    nx, ny = tile_grid(width, height, tile)
    tw, th = tile_wh(tile)
    mxr, myr = pg.mean2d[:, 0], pg.mean2d[:, 1]
    ca, cb, cc = pg.conic[:, 0], pg.conic[:, 1], pg.conic[:, 2]
    opr, r = pg.opacity, pg.radius
    det = ca * cc - cb * cb
    pd = (ca > 0.0) & (cc > 0.0) & (det > 0.0)
    safe_det = torch.where(pd, det, 1.0)
    L = torch.log(torch.clamp(opr, min=1e-12) * 255.0)

    # 1.0001 + 1e-3: a float-safety margin far below a tile's width
    def ext(cov_ii):
        return torch.sqrt(torch.clamp(2.0 * L, min=0.0) * cov_ii) \
            * 1.0001 + 1e-3
    rx = torch.minimum(torch.where(pd, ext(cc / safe_det), r), r)
    ry = torch.minimum(torch.where(pd, ext(ca / safe_det), r), r)
    mask = pg.mask & (opr >= MIN_ALPHA)
    tx0 = _floor_index((mxr - rx) / tw, nx)
    ty0 = _floor_index((myr - ry) / th, ny)
    tx1 = _floor_index((mxr + rx) / tw, nx, add=1)
    ty1 = _floor_index((myr + ry) / th, ny, add=1)
    w = torch.where(mask, tx1 - tx0, 0)
    h = torch.where(mask, ty1 - ty0, 0)
    return tx0, ty0, w, h, nx, ny


def _tight_cull_keep(mx, my, ca, cb, cc, op, rad, tx, ty, tile):
    """Per-instance culling: drop (Gaussian, tile) pairs whose alpha is
    zero at every pixel centre of the tile. Two conservative tests:

      disk    the closest point of the tile's pixel-centre rectangle to
              the mean lies beyond `radius`;
      ellipse max alpha over the rectangle, op * exp(-min_q), with min_q
              the rectangle-constrained minimum of
              q = .5(a dx^2 + c dy^2) + b dx dy, is below 1/255 (applied
              only where the conic is positive-definite).

    All arguments are per-instance (I,) tensors. Returns an (I,) bool
    keep mask.
    """
    tw, th = tile_wh(tile)
    x0 = (tx * tw).to(torch.float32)
    y0 = (ty * th).to(torch.float32)
    x1 = x0 + (tw - 1)                       # pixel centres are integers
    y1 = y0 + (th - 1)

    ddx = torch.minimum(torch.maximum(mx, x0), x1) - mx
    ddy = torch.minimum(torch.maximum(my, y0), y1) - my
    disk_ok = ddx * ddx + ddy * ddy <= rad * rad

    lx, hx = x0 - mx, x1 - mx
    ly, hy = y0 - my, y1 - my
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    safe_ca = torch.where(ca > 0, ca, 1.0)
    safe_cc = torch.where(cc > 0, cc, 1.0)

    def edge_v(dx):                          # vertical edge, fixed dx
        dy = torch.minimum(torch.maximum(-cb * dx / safe_cc, ly), hy)
        return q(dx, dy)

    def edge_h(dy):                          # horizontal edge, fixed dy
        dx = torch.minimum(torch.maximum(-cb * dy / safe_ca, lx), hx)
        return q(dx, dy)

    min_q = torch.minimum(torch.minimum(edge_v(lx), edge_v(hx)),
                          torch.minimum(edge_h(ly), edge_h(hy)))
    min_q = torch.where(inside, 0.0, torch.clamp(min_q, min=0.0))
    pd = (ca > 0) & (cc > 0) & (ca * cc - cb * cb >= 0)
    # margin 0.999: never cull a borderline-visible instance to fp noise
    ellipse_dead = pd & (op * torch.exp(-min_q) < MIN_ALPHA * 0.999)
    return disk_ok & ~ellipse_dead


def bin_gaussians(pg, width: int, height: int, budget: int, tile=TILE,
                  align: int = 1) -> TileBins:
    """Build the depth-sorted per-tile instance lists, over tight ellipse
    spans with per-instance culling.

    budget: total slot capacity (instances plus per-tile alignment
    padding). Past it, later instances (by Gaussian index) are dropped
    and `overflowed` is set; `n_slots` reports the demand, so a caller
    can size the budget from a first pass.
    align: per-tile segment alignment. The CUDA blend reads any offset,
    so the default is 1: the budget carries no padding.
    """
    n = pg.mean2d.shape[0]
    dev = pg.mean2d.device
    tx0, ty0, w, h, nx, ny = tile_spans(pg, width, height, tile)
    num_tiles = nx * ny
    counts = (w * h).to(torch.int64)
    ends_g = torch.cumsum(counts, 0)
    offsets = ends_g - counts
    total = ends_g[-1] if n else torch.zeros((), dtype=torch.int64,
                                             device=dev)

    # instance s belongs to the Gaussian whose run [offset, end) holds s.
    # Slots past the demand hold nothing: on the CPU, where reading the
    # demand costs no synchronisation, only those up to it are made; on
    # the card the whole budget, so that no shape waits for the host
    n_slot = budget if dev.type != "cpu" else min(budget, int(total))
    slot = torch.arange(n_slot, dtype=torch.int64, device=dev)
    gid = torch.searchsorted(ends_g, slot, right=True).clamp(max=max(n - 1, 0))
    keep = slot < total
    rank = slot - offsets[gid]
    gw = torch.clamp(w[gid], min=1).to(torch.int64)
    tx = tx0[gid].to(torch.int64) + rank % gw
    ty = ty0[gid].to(torch.int64) + rank // gw
    keep &= _tight_cull_keep(
        pg.mean2d[gid, 0], pg.mean2d[gid, 1], pg.conic[gid, 0],
        pg.conic[gid, 1], pg.conic[gid, 2], pg.opacity[gid],
        pg.radius[gid], tx, ty, tile)
    tile_ids = torch.where(keep, ty * nx + tx, num_tiles)

    order = torch.argsort(pg.depth, stable=True)
    depth_rank = torch.empty(n, dtype=torch.int64, device=dev)
    depth_rank[order] = torch.arange(n, dtype=torch.int64, device=dev)

    # one sort on the packed (tile, depth-rank) key; dropped instances
    # carry tile id num_tiles and sort to the end
    key = tile_ids * n + depth_rank[gid]
    key_sorted, perm = torch.sort(key, stable=True)
    gid_sorted = gid[perm]
    tile_sorted = torch.div(key_sorted, max(n, 1), rounding_mode="floor")

    tids = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    raw_starts = torch.searchsorted(tile_sorted, tids, side="left")
    raw_ends = torch.searchsorted(tile_sorted, tids, side="right")

    # re-layout into `align`-aligned per-tile segments; the alignment
    # padding lives inside the budget
    tcounts = raw_ends - raw_starts
    seg = (tcounts + align - 1) // align * align
    astarts = torch.cumsum(seg, 0) - seg
    i_align = -(-budget // align) * align
    aligned_need = seg.sum()
    live = tile_sorted < num_tiles
    tcl = torch.clamp(tile_sorted, max=num_tiles - 1)
    newpos = astarts[tcl] + (slot - raw_starts[tcl])
    newpos = torch.where(live & (newpos < i_align), newpos, i_align)
    gauss_al = torch.zeros(i_align + 1, dtype=torch.int32, device=dev)
    gauss_al[newpos] = gid_sorted.to(torch.int32)

    n_slots = total + (aligned_need - tcounts.sum())
    return TileBins(
        gauss_id=gauss_al[:i_align],
        starts=torch.clamp(astarts, max=i_align).to(torch.int32),
        ends=torch.clamp(astarts + tcounts, max=i_align).to(torch.int32),
        n_instances=total,
        aligned_total=torch.clamp(aligned_need, max=i_align),
        overflowed=(total > budget) | (aligned_need > i_align),
        n_slots=n_slots)
