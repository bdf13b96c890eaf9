"""What one training step must do, counted from the recipe and the
inputs: the step's least time on the chip, whatever implements it.

Operations on the tensor cores' bf16 peak (a lower bound for any
precision): the avatar's decoders over its live rows and LPIPS's
convolutions over its patches. Operations at the float32 peak: the
triplane's bilinear gathers, the kNN distances of the live rows to the
body's vertices, SSIM and the blend's pairs (work/blend.py). Forward and
backward are summed: a matrix product's backward is twice its forward
(input and weight gradients), LPIPS's once (the input's gradient alone,
for the prediction). Bytes: the blend's, and Adam's over the live rows
and the nets (read the parameter, gradient and both moments, write the
parameter and both moments: 7 float32 an element).
"""
from __future__ import annotations

import torch

from bench_port.reference.plain.losses.lpips import VGG_BLOCKS
from bench_port.reference.plain.models import nets
from bench_port.work.peaks import least_s

SSIM_FLOPS_PX = 3 * (5 * 2 * 11 * 2 + 30)   # 5 separable blurs, 3 colours
SCENE_ROW_FLOATS = 3 + 3 + 45 + 1 + 3 + 4   # xyz, SH 3, opacity, scale, rot


def decoder_flops_per_row(n_features: int = 32) -> tuple[int, int]:
    """(matrix-product flops, triplane gather flops) of one row's
    canonical decode, forward: 2 in x out for each weight matrix of the
    three decoders (the frozen copy's shapes); 3 planes x 4 taps x the
    features x 2 for the gathers."""
    gen = torch.Generator().manual_seed(0)
    nf3 = 3 * n_features
    mods = (nets.appearance_decoder_init(gen, nf3, device="cpu"),
            nets.geometry_decoder_init(gen, nf3, device="cpu"),
            nets.deformation_decoder_init(gen, nf3, disable_posedirs=True,
                                          device="cpu"))
    mm = sum(2 * p.numel() for m in mods for p in m.parameters()
             if p.dim() == 2)
    return mm, 3 * 4 * n_features * 2


def lpips_flops(n_patches: int, patch: int) -> int:
    """VGG16's 13 3x3 convolutions over n_patches patches of patch^2,
    forward, one image."""
    flops, cin, side = 0, 3, patch
    for b, (cout, n) in enumerate(VGG_BLOCKS):
        if b:
            side //= 2
        for _ in range(n):
            flops += 2 * side * side * cin * cout * 9
            cin = cout
    return flops * n_patches


def step_least(recipe: dict, renders: list, human_rows: int,
               body_verts: int, scene_rows: int, net_elems: int,
               pixels: int) -> dict:
    """The step's least time from its renders' BlendWork (the merged
    render, then the human's alone where the loss has one), the live rows
    of each set, the body's vertex count, the nets' elements and the
    frame's pixels. Returns {'least_s', 'bound_by', 'tc_flops',
    'fp32_flops', 'bytes'}."""
    mode = recipe["mode"]
    tc = fp32 = nbytes = 0.0
    for w in renders:
        (o1, b1), (o2, b2) = w.k1(), w.k2()
        fp32 += o1 + o2
        nbytes += b1 + b2
    fp32 += 3 * SSIM_FLOPS_PX * pixels * len(renders)
    if mode != "scene":
        h = recipe["human"]
        mm, gather = decoder_flops_per_row()
        tc += 3 * mm * human_rows
        fp32 += 3 * gather * human_rows
        fp32 += human_rows * body_verts * 3 * 3
        loss = h["loss"]
        if loss["lpips_w"] > 0:
            one = lpips_flops(loss["num_patches"], loss["patch_size"])
            tc += 3 * one * len(renders)
        nbytes += 7 * 4 * (human_rows * 3 + net_elems)
    nbytes += 7 * 4 * scene_rows * SCENE_ROW_FLOATS
    least, by = least_s(tc, fp32, nbytes)
    return {"least_s": least, "bound_by": by, "tc_flops": tc,
            "fp32_flops": fp32, "bytes": nbytes}
