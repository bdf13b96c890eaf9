"""What K1 (the blend forward) and K2 (its backward) must do for one
render, counted from the inputs by the frozen plain renderer, whatever
implements it: nothing of the port's culls or counters is read.

The pairs: per pixel, the (pixel, instance) pairs that the plain blend
walks before the pixel's transmittance falls below its cutoff (tested)
and those of them with alpha > 0 (blended). Operations: 22 a tested pair
(the Gaussian's alpha: the offset, the conic's quadratic form, the
exponential, the radius and 1/255 tests), 12 more a blended pair in the
forward (the transmittance and the colour's sum), 47 more in the
backward (the pair's gradient, 38, and the sum of its nine values into
its Gaussian's, 9). Bytes, each counted once: the feature rows the lists
reference (10 float32 a row), the lists, the tiles' starts and ends and
the background; K1's image and final transmittance; K2's incoming image
gradient and the transmittance, and the referenced rows' gradients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference.plain.render.blend import (
    N_FEAT, gauss_features, plain_blend,
)
from bench_port.reference.plain.render.project import project_gaussians
from bench_port.reference.plain.render.tiles import TILE, bin_gaussians

OPS_TESTED = 22
OPS_BLENDED_FWD = 12
OPS_BLENDED_BWD = 38 + 9


class BlendWork(NamedTuple):
    tested: int
    blended: int
    rows: int          # feature rows the lists reference
    instances: int     # (tile, Gaussian) instances in the lists
    tiles: int
    pixels: int

    def k1(self):
        """(float32 operations, bytes) of the forward."""
        ops = OPS_TESTED * self.tested + OPS_BLENDED_FWD * self.blended
        nbytes = (self.rows * N_FEAT * 4 + self.instances * 4
                  + self.tiles * 8 + 12 + self.pixels * 4 * 4)
        return ops, nbytes

    def k2(self):
        """(float32 operations, bytes) of the backward."""
        ops = OPS_TESTED * self.tested + OPS_BLENDED_BWD * self.blended
        nbytes = (2 * self.rows * N_FEAT * 4 + self.instances * 4
                  + self.tiles * 8 + 24 + self.pixels * 4 * 4)
        return ops, nbytes


@torch.no_grad()
def blend_work(xyz, scales, rotq, opacity, shs, alive, camera, width: int,
               height: int, bg, sh_degree) -> BlendWork:
    """The work of one render of these Gaussians (the attributes a
    render takes, `alive` a (N,) mask or None) from `camera`."""
    pg = project_gaussians(xyz, scales, rotq, opacity, shs, camera, width,
                           height, sh_degree, 1.0, alive=alive)
    bins = bin_gaussians(pg, width, height, max(4 * xyz.shape[0], 1 << 16),
                         TILE)
    if bool(bins.overflowed):
        raise RuntimeError("the work count's binning overflowed")
    pairs = plain_blend(gauss_features(pg), bins.gauss_id, bins.starts,
                        bins.ends, bg, width, height)[2]
    tested, blended = (int(x) for x in pairs.sum(dim=(1, 2)))
    counts = (bins.ends - bins.starts).long()
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    slot = torch.repeat_interleave(bins.starts.long(), counts) + (
        torch.arange(first.numel(), device=first.device) - first)
    rows = int(torch.unique(bins.gauss_id[slot].long()).numel())
    return BlendWork(tested, blended, rows, int(counts.sum()),
                     bins.starts.shape[0], width * height)
