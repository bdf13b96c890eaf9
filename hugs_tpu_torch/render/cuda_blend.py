"""Wrapper of K1, the CUDA forward tile blend (csrc/blend_fwd.cu).

The counterpart of hugs_tpu/render/pallas_blend.py's forward kernel.
`blend_tiles` launches K1 for CUDA tensors and runs the plain PyTorch
blend (render/blend.py) for CPU tensors; there is no other path and no
fallback when a build or a launch fails. The launch goes through a
torch.autograd.Function whose backward raises until the backward kernel
(K2) is ported, so a CUDA render cannot quietly take gradients through
another path.

The TPU kernel's POWER_MXU mode (a matmul evaluation of the Gaussian
exponent on the TPU's MXU, off by default) has no output of its own: it
computes the same exponent, which K1 computes directly. It has no
counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.render.blend import (
    N_FEAT, blend_tiles_plain, gauss_features,
)
from hugs_tpu_torch.render.project import ProjectedGaussians
from hugs_tpu_torch.render.tiles import TILE, TileBins, tile_grid

SOURCE = "blend_fwd"
LAUNCHES = 0   # K1 launches since the count was last set to 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.hugs_blend_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr] * 4
        fn.restype = i32
    return lib


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


def blend_fwd(feat: torch.Tensor, gauss_id: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, bg: torch.Tensor,
              width: int, height: int):
    """Launch K1 on the current stream. CUDA tensors only.

    feat: (N, 10) float32 (blend.gauss_features); gauss_id: (I,) int32;
    starts/ends: (T,) int32 over 16x16 tiles; bg: (3,) float32.
    Returns img (3, H, W) in [0, 1], log_t (H, W) final log
    transmittance (stopped where the pixel saturated) and walked (T,)
    int32, the instances each tile walked before all its pixels
    saturated, in whole batches of 256.
    """
    global LAUNCHES
    if feat.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; feat is on {feat.device}")
    dev = feat.device
    nx, ny = tile_grid(width, height, TILE)
    T = nx * ny
    _check("feat", feat, torch.float32, (feat.shape[0], N_FEAT), dev)
    _check("gauss_id", gauss_id, torch.int32, (gauss_id.shape[0],), dev)
    _check("starts", starts, torch.int32, (T,), dev)
    _check("ends", ends, torch.int32, (T,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    img = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    log_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    walked = torch.empty((T,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hugs_blend_fwd(
            feat.data_ptr(), gauss_id.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), bg.data_ptr(), width, height, nx, T,
            img.data_ptr(), log_t.data_ptr(), walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return img, log_t, walked


class _BlendFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, gauss_id, starts, ends, bg, width, height):
        return blend_fwd(feat, gauss_id, starts, ends, bg, width, height)[0]

    @staticmethod
    def backward(ctx, grad_img):
        raise NotImplementedError(
            "K2 (_bwd_kernel) is ported with scene training")


def blend_tiles(pg: ProjectedGaussians, bins: TileBins, width: int,
                height: int, bg: torch.Tensor, tile=TILE) -> torch.Tensor:
    """Composite all tiles. Returns (3, H, W) in [0, 1].

    CUDA tensors go through K1, which takes 16x16 tiles only; CPU
    tensors through blend_tiles_plain, with no tile cap."""
    if pg.mean2d.device.type == "cpu":
        return blend_tiles_plain(pg, bins, width, height, bg, None, tile)
    if tile != TILE:
        raise ValueError(f"the CUDA blend takes {TILE}x{TILE} tiles, "
                         f"not {tile}")
    return _BlendFwd.apply(gauss_features(pg), bins.gauss_id, bins.starts,
                           bins.ends, bg.to(torch.float32).contiguous(),
                           width, height)
