"""Wrappers of the CUDA tile blend: K1, the forward (csrc/blend_fwd.cu),
and K2, its backward (csrc/blend_bwd.cu).

The counterparts of hugs_tpu/render/pallas_blend.py's forward and
backward kernels. `blend_feat` (on a feature table: the Gaussians' own,
or the received fragments of parallel/gauss_shard.py) and `blend_tiles`
(on projected Gaussians) launch K1 for CUDA tensors through a
torch.autograd.Function whose backward launches K2, and run the plain
PyTorch blend (render/blend.py) under autograd for CPU tensors; there is
no other path and no fallback when a build or a launch fails.

K2 also does what the XLA code around the TPU kernel does: it adds each
instance's gradient onto its Gaussian's row of grad_feat (N, 10) with
atomics (in hugs_tpu, the AD transpose of `_pack_aligned`'s gather) and
computes the background's gradient, sum_p g T_fin [T_fin >= T_EPS]
(pallas_blend.py:872-876). Both kernels skip, per warp, the instances
that the warp cull (`warp_cull`, a 16x2 rectangle of pixel centres per
warp) shows to have alpha 0 at all of the warp's pixels.

`blend_bwd_skeleton` launches S3, K2's skeleton variants (the
counterpart of scripts/micro_bwd.py's `_skel_kernel`): K2's own tile
loop with its gradient math replaced by one multiply per sum, with or
without the warp cull and the sum across pixels, or its staging alone
(csrc/blend_bwd.cu says what each keeps), each at K2's resident blocks
per SM (`skeleton_residency`). CUDA tensors only; their plain versions
are in hugs_tpu_torch/micro/micro_bwd.py.

The TPU kernels' POWER_MXU mode (pallas_blend.py:63-188: the Gaussian
exponent as one matrix product of a recentred pixel basis and per-
instance coefficients, off by default) is the kernels' second mode here,
`power_mxu=True`: K1 and K2 evaluate the exponent on the tensor cores
(mma.sync, blend_common.cuh::mxu_product, one routine for both, on each
warp's groups of 8 kept instances; a pair's power does not depend on its
group, so the two agree on every alpha), the rest of each kernel the
exact mode's math; the plain version is render/blend.py's mode. The
mode's launches count apart (MXU_LAUNCHES, K2_MXU_LAUNCHES). POWER_MXU,
read from HUGS_POWER_MXU as pallas_blend.py:106 reads it, is render()'s
default (renderer.py).
"""
from __future__ import annotations

import ctypes
import os

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.render.blend import N_FEAT, gauss_features, plain_blend
from hugs_tpu_torch.render.oracle import clip01
from hugs_tpu_torch.render.project import ProjectedGaussians
from hugs_tpu_torch.render.tiles import (
    TILE, TileBins, _tight_cull_keep, tile_grid,
)

SOURCE = "blend_fwd"
BWD_SOURCE = "blend_bwd"
LAUNCHES = 0      # K1 launches since the count was last set to 0
K2_LAUNCHES = 0   # K2 launches since the count was last set to 0
MXU_LAUNCHES = 0      # K1 launches in the POWER_MXU mode, likewise
K2_MXU_LAUNCHES = 0   # K2 launches in the POWER_MXU mode, likewise
# render()'s default mode: HUGS_POWER_MXU set and not "0" turns it on
POWER_MXU = os.environ.get("HUGS_POWER_MXU", "0") != "0"
WARP_RECT = (TILE, 2)   # the pixel rectangle of one warp of a tile
# S3's variants, in the order of their numbers in blend_bwd.cu
SKELETON_MODES = ("skeleton", "skeleton_no_cull", "skeleton_no_shuffle",
                  "staging_only")
# S3 launches per variant since the counts were last set to 0
SKELETON_LAUNCHES = dict.fromkeys(SKELETON_MODES, 0)


def _library(source: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = build.load(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_PTR] * 5 + [_I32] * 4 + [_PTR] * 5
_BWD_ARGS = [_PTR] * 7 + [_I32] * 4 + [_PTR] * 3
_CULL_ARGS = [_PTR] * 4 + [_I32] + [_PTR] * 2
_SKEL_ARGS = [_I32] + [_PTR] * 7 + [_I32] * 4 + [_PTR] * 3


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_bins(feat, gauss_id, starts, ends, bg, width, height, kernel):
    if feat.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors; feat is on "
                         f"{feat.device}")
    dev = feat.device
    nx, ny = tile_grid(width, height, TILE)
    _check("feat", feat, torch.float32, (feat.shape[0], N_FEAT), dev)
    _check("gauss_id", gauss_id, torch.int32, (gauss_id.shape[0],), dev)
    _check("starts", starts, torch.int32, (nx * ny,), dev)
    _check("ends", ends, torch.int32, (nx * ny,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    return dev, nx, nx * ny


def blend_fwd(feat: torch.Tensor, gauss_id: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
              width: int, height: int, power_mxu: bool = False):
    """Launch K1 on the current stream (in the POWER_MXU mode with
    power_mxu). CUDA tensors only.

    feat: (N, 10) float32 (blend.gauss_features); gauss_id: (I,) int32;
    starts/ends: (T,) int32 over 16x16 tiles; bg: (3,) float32.
    Returns img (3, H, W) raw colour (not clipped), log_t (H, W) final log
    transmittance (stopped where the pixel saturated), n_walked (H, W)
    int32, the instances each pixel walked up to and including the one
    that saturated it, and walked (T,) int32, the instances each tile
    walked before all its pixels saturated, in whole batches of 256.
    """
    global LAUNCHES, MXU_LAUNCHES
    dev, nx, T = _check_bins(feat, gauss_id, starts, ends, bg, width,
                             height, "K1")
    img = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    log_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_walked = torch.empty((height, width), dtype=torch.int32, device=dev)
    walked = torch.empty((T,), dtype=torch.int32, device=dev)
    entry = "hugs_blend_fwd_mxu" if power_mxu else "hugs_blend_fwd"
    fn = getattr(_library(SOURCE, entry, _FWD_ARGS), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), gauss_id.data_ptr(), starts.data_ptr(),
                 ends.data_ptr(), bg.data_ptr(), width, height, nx, T,
                 img.data_ptr(), log_t.data_ptr(), n_walked.data_ptr(),
                 walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    if power_mxu:
        MXU_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return img, log_t, n_walked, walked


def blend_bwd(feat: torch.Tensor, gauss_id: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
              width: int, height: int, grad_raw: torch.Tensor,
              log_t: torch.Tensor, n_walked: torch.Tensor,
              power_mxu: bool = False):
    """Launch K2 on the current stream (in the POWER_MXU mode with
    power_mxu, on the mode's K1's log_t and n_walked). CUDA tensors only.

    The forward's inputs, grad_raw (3, H, W) = d(loss)/d(raw colour), and
    K1's log_t and n_walked. Returns grad_feat (N, 10), the gradient of
    each Gaussian (columns r g b op mx my ca cb cc; the radius column is
    zero), and grad_bg (3,), as blend.plain_blend_bwd does. K2 adds both
    with atomics, so the sums run in an order that is not fixed."""
    global K2_LAUNCHES, K2_MXU_LAUNCHES
    dev, nx, T = _check_bins(feat, gauss_id, starts, ends, bg, width,
                             height, "K2")
    _check("grad_raw", grad_raw, torch.float32, (3, height, width), dev)
    _check("log_t", log_t, torch.float32, (height, width), dev)
    _check("n_walked", n_walked, torch.int32, (height, width), dev)
    grad_feat = torch.zeros_like(feat)
    grad_bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    entry = "hugs_blend_bwd_mxu" if power_mxu else "hugs_blend_bwd"
    fn = getattr(_library(BWD_SOURCE, entry, _BWD_ARGS), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), gauss_id.data_ptr(), starts.data_ptr(),
                 bg.data_ptr(), log_t.data_ptr(), n_walked.data_ptr(),
                 grad_raw.data_ptr(), width, height, nx, T,
                 grad_feat.data_ptr(), grad_bg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    if power_mxu:
        K2_MXU_LAUNCHES += 1
    else:
        K2_LAUNCHES += 1
    return grad_feat, grad_bg


def blend_bwd_skeleton(mode: str, feat: torch.Tensor,
                       gauss_id: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor, bg: torch.Tensor, width: int,
                       height: int, grad_raw: torch.Tensor,
                       log_t: torch.Tensor, n_walked: torch.Tensor):
    """Launch S3, K2's skeleton variant `mode` (one of SKELETON_MODES), on
    the current stream, with blend_bwd's arguments. CUDA tensors only.

    Returns (out, grad_bg): grad_bg (3,) as K2's, and out the variant's
    own output, grad_feat (N, 10) for "skeleton" and "skeleton_no_cull",
    a (H, W) per-pixel plane for "skeleton_no_shuffle", a (T,) per-tile
    checksum for "staging_only" (micro/micro_bwd.py's plain versions say
    what each holds)."""
    if mode not in SKELETON_MODES:
        raise ValueError(f"unknown skeleton mode {mode!r}; expected one of "
                         f"{SKELETON_MODES}")
    dev, nx, T = _check_bins(feat, gauss_id, starts, ends, bg, width,
                             height, "S3")
    _check("grad_raw", grad_raw, torch.float32, (3, height, width), dev)
    _check("log_t", log_t, torch.float32, (height, width), dev)
    _check("n_walked", n_walked, torch.int32, (height, width), dev)
    shape = {"skeleton_no_shuffle": (height, width),
             "staging_only": (T,)}.get(mode, tuple(feat.shape))
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    grad_bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    lib = _library(BWD_SOURCE, "hugs_blend_bwd_skeleton", _SKEL_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hugs_blend_bwd_skeleton(
            SKELETON_MODES.index(mode) + 1, feat.data_ptr(),
            gauss_id.data_ptr(), starts.data_ptr(), bg.data_ptr(),
            log_t.data_ptr(), n_walked.data_ptr(), grad_raw.data_ptr(),
            width, height, nx, T, out.data_ptr(), grad_bg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"S3 {mode} launch failed: cudaError {err}")
    SKELETON_LAUNCHES[mode] += 1
    return out, grad_bg


def warp_cull(feat: torch.Tensor, gauss_id: torch.Tensor, tx: torch.Tensor,
              ty: torch.Tensor) -> torch.Tensor:
    """The warp cull of K1 and K2: (I,) bool, False where Gaussian
    gauss_id[i] has alpha 0 at every pixel centre of the 16x2 rectangle
    (tx[i], ty[i]) of the grid of WARP_RECT rectangles (warp ty % 8 of
    tile (tx, ty // 8)). CUDA tensors run the kernels' own device
    function, CPU tensors tiles._tight_cull_keep at that rectangle."""
    if feat.device.type == "cpu":
        f = feat[gauss_id.long()]
        return _tight_cull_keep(f[:, 4], f[:, 5], f[:, 6], f[:, 7], f[:, 8],
                                f[:, 3], f[:, 9], tx, ty, WARP_RECT)
    dev = feat.device
    n = gauss_id.shape[0]
    _check("feat", feat, torch.float32, (feat.shape[0], N_FEAT), dev)
    for name, x in (("gauss_id", gauss_id), ("tx", tx), ("ty", ty)):
        _check(name, x, torch.int32, (n,), dev)
    keep = torch.empty((n,), dtype=torch.uint8, device=dev)
    lib = _library(SOURCE, "hugs_warp_cull", _CULL_ARGS)
    with torch.cuda.device(dev):
        err = lib.hugs_warp_cull(
            feat.data_ptr(), gauss_id.data_ptr(), tx.data_ptr(),
            ty.data_ptr(), n, keep.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp cull launch failed: cudaError {err}")
    return keep.bool()


def blocks_per_sm() -> dict[str, int]:
    """K1's and K2's resident blocks per SM on the current card, from the
    CUDA occupancy calculator."""
    out = {}
    for name, source, fn in (("K1", SOURCE, "hugs_blend_fwd_blocks_per_sm"),
                             ("K2", BWD_SOURCE,
                              "hugs_blend_bwd_blocks_per_sm")):
        out[name] = int(getattr(_library(source, fn, []), fn)())
    return out


def mxu_blocks_per_sm() -> dict[str, dict[str, int]]:
    """The POWER_MXU mode's K1 and K2: resident blocks per SM on the
    current card (occupancy calculator) and the dynamic shared memory
    (bytes: coefficient records and powers) each launch requests."""
    out = {}
    for name, source, fn in (("K1", SOURCE,
                              "hugs_blend_fwd_mxu_blocks_per_sm"),
                             ("K2", BWD_SOURCE,
                              "hugs_blend_bwd_mxu_blocks_per_sm")):
        dynamic = _I32(-1)
        lib = _library(source, fn, [ctypes.POINTER(_I32)])
        n = int(getattr(lib, fn)(ctypes.byref(dynamic)))
        if n < 0:
            raise RuntimeError(f"{name} in the POWER_MXU mode: occupancy "
                               f"query failed")
        out[name] = {"blocks_per_sm": n, "dynamic_smem_bytes": dynamic.value}
    return out


def skeleton_residency() -> dict[str, dict[str, int]]:
    """Each S3 variant's resident blocks per SM as it is launched, and the
    unused dynamic shared memory (bytes) that pins it to K2's count
    (csrc/blend_bwd.cu, residency_pad). Raises where it cannot be pinned."""
    fn = "hugs_blend_bwd_skeleton_blocks_per_sm"
    lib = _library(BWD_SOURCE, fn, [_I32, ctypes.POINTER(_I32)])
    out = {}
    for i, mode in enumerate(SKELETON_MODES, 1):
        pad = _I32(-1)
        n = int(getattr(lib, fn)(i, ctypes.byref(pad)))
        if n < 0 or pad.value < 0:
            raise RuntimeError(f"S3 {mode}: its residency cannot be pinned "
                               f"to K2's")
        out[mode] = {"blocks_per_sm": n, "pad_bytes": pad.value}
    return out


class _BlendFwd(torch.autograd.Function):
    """K1 forward, K2 backward, both in the mode power_mxu selects;
    differentiable in feat and bg."""

    @staticmethod
    def forward(ctx, feat, gauss_id, starts, ends, bg, width, height,
                power_mxu=False):
        img, log_t, n_walked, _ = blend_fwd(feat, gauss_id, starts, ends, bg,
                                            width, height, power_mxu)
        ctx.save_for_backward(feat, gauss_id, starts, ends, bg, log_t,
                              n_walked)
        ctx.size = (width, height)
        ctx.power_mxu = power_mxu
        return img

    @staticmethod
    def backward(ctx, grad_img):
        feat, gauss_id, starts, ends, bg, log_t, n_walked = ctx.saved_tensors
        grad_feat, grad_bg = blend_bwd(
            feat, gauss_id, starts, ends, bg, *ctx.size,
            grad_img.to(torch.float32).contiguous(), log_t, n_walked,
            ctx.power_mxu)
        return grad_feat, None, None, None, grad_bg, None, None, None


def blend_feat(feat: torch.Tensor, gauss_id: torch.Tensor,
               starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
               width: int, height: int,
               power_mxu: bool = False) -> torch.Tensor:
    """Composite all tiles of a feature table (N, 10) in gauss_features'
    layout. Returns (3, H, W) in [0, 1], differentiable in feat and bg.

    CUDA tensors go through K1 (and K2 for the gradient), on 16x16 tiles;
    CPU tensors through the plain blend, with no tile cap; each in the
    POWER_MXU mode with power_mxu."""
    if feat.device.type == "cpu":
        return clip01(plain_blend(feat, gauss_id, starts, ends, bg, width,
                                  height, power_mxu=power_mxu)[0])
    raw = _BlendFwd.apply(feat.contiguous(), gauss_id, starts, ends,
                          bg.to(torch.float32).contiguous(), width, height,
                          power_mxu)
    return clip01(raw)


def blend_tiles(pg: ProjectedGaussians, bins: TileBins, width: int,
                height: int, bg: torch.Tensor,
                power_mxu: bool = False) -> torch.Tensor:
    """Composite all tiles of the projected set pg over its bins. Returns
    (3, H, W) in [0, 1] (blend_feat)."""
    return blend_feat(gauss_features(pg), bins.gauss_id, bins.starts,
                      bins.ends, bg, width, height, power_mxu)
