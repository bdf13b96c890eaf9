"""Mask-biased patch sampling, plain PyTorch.

With probability ratio_mask the patches' top-left corners are drawn so
that each patch's centre lies inside the (human) mask, without
replacement; otherwise uniformly over the image. Sampling without
replacement is Gumbel top-k over the valid centres, with static shapes.

The random draws come from the caller (`PatchDraws`, made from a
torch.Generator by `draw_patch_randoms`), so that a test can hand the
same draws to the JAX package's sampler and to this one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class PatchDraws(NamedTuple):
    coin: torch.Tensor     # () uniform [0, 1): the mask-or-uniform mode
    gumbel: torch.Tensor   # (H * W,) standard Gumbel noise
    ux: torch.Tensor       # (num_patches,) int64 uniform rows in [0, max(H - p, 1))
    uy: torch.Tensor       # (num_patches,) int64 uniform columns in [0, max(W - p, 1))


def draw_patch_randoms(generator: torch.Generator, h: int, w: int,
                       num_patches: int, patch_size: int,
                       device: torch.device | str = "cuda") -> PatchDraws:
    """The draws of one sample_patches call, from `generator` on its own
    device, moved to `device`."""
    gd = generator.device
    coin = torch.rand((), generator=generator, device=gd)
    # a standard Gumbel is -log of a standard exponential
    expo = torch.empty(h * w, device=gd).exponential_(generator=generator)
    ux = torch.randint(0, max(h - patch_size, 1), (num_patches,),
                       generator=generator, device=gd)
    uy = torch.randint(0, max(w - patch_size, 1), (num_patches,),
                       generator=generator, device=gd)
    return PatchDraws(coin.to(device), (-torch.log(expo)).to(device),
                      ux.to(device), uy.to(device))


def sample_patches(draws: PatchDraws, mask: torch.Tensor, images: list,
                   num_patches: int = 4, patch_size: int = 128,
                   ratio_mask: float = 0.9, dilate: int = 0) -> list:
    """Aligned patches of several (C, H, W) images.

    mask: (H, W) or (1, H, W) float or bool human mask. dilate: a box
    dilation (pixels) of the mask before the centres are picked, with
    the asymmetric window of cv2.dilate (dilate // 2 before, the rest
    after). Returns a list of (num_patches, C, patch_size, patch_size)
    crops in the order of `images` (the mask's own patches are not
    returned; put the mask among `images` for them)."""
    if mask.dim() == 3:
        mask = mask[0]
    h, w = mask.shape
    o = patch_size // 2
    if dilate > 0:
        lo = dilate // 2
        hi = dilate - 1 - lo
        padded = F.pad(mask.to(torch.float32)[None, None], (lo, hi, lo, hi),
                       value=-torch.inf)
        mask = F.max_pool2d(padded, dilate, stride=1)[0, 0]

    # valid centres: inside the mask and o pixels away from the borders
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[o:h - o, o:w - o] = True
    valid = (mask > 0) & border

    logits = torch.where(valid.reshape(-1), 0.0, -torch.inf)
    flat_idx = torch.topk(logits + draws.gumbel, num_patches).indices
    mx = flat_idx // w
    my = flat_idx % w
    # uniform corners where the mask has too few valid centres
    enough = torch.sum(valid) >= num_patches
    use_mask = (draws.coin < ratio_mask) & enough
    xs = torch.where(use_mask, torch.clamp(mx - o, 0, h - patch_size),
                     draws.ux)
    ys = torch.where(use_mask, torch.clamp(my - o, 0, w - patch_size),
                     draws.uy)

    ar = torch.arange(patch_size, device=mask.device)
    rows = (xs[:, None] + ar)[:, :, None]       # (n, p, 1)
    cols = (ys[:, None] + ar)[:, None, :]       # (n, 1, p)
    # img[:, rows, cols] is (C, n, p, p)
    return [img[:, rows, cols].permute(1, 0, 2, 3) for img in images]
