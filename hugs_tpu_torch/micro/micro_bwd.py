"""S3: K2's time split into its fixed cost and its gradient arithmetic.

The counterpart of scripts/micro_bwd.py, on K2's Hopper design. On
bench.py's scene (50,000 Gaussians, 960x540, the camera at the origin
looking down +z, d(loss)/d(image) = ones) it times
  staging_only         K2's per-pixel setup, batch loop, loads and syncs
                       (the TPU's dma_only);
  skeleton_no_cull     the skeleton with every walked instance kept;
  skeleton_no_shuffle  the skeleton without the sum across pixels (the
                       TPU's no_k8);
  skeleton             all of K2 but its gradient math, which becomes one
                       multiply per sum;
  full                 K2 (cuda_blend.blend_bwd);
  fwd_bwd              K1 then K2, as the script's full_grad.
The variants are instantiations of K2's own tile loop in
csrc/blend_bwd.cu, launched by cuda_blend.blend_bwd_skeleton (CUDA
tensors); `plain_variant` is each one's plain PyTorch version (CPU
tensors, and the reference on the card). Each variant runs at K2's
resident blocks per SM (cuda_blend.skeleton_residency). Device ms per
variant is the median of 20 spans of 20 back-to-back launches.

Run: `python -m hugs_tpu_torch.micro.micro_bwd [--device cpu] [--seed S]
[--out F]`; on the CPU, at SMOKE's size.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch.micro import card, device_ms, emit, parse_args
from hugs_tpu_torch.render import cuda_blend, make_camera
from hugs_tpu_torch.render.blend import (
    _assemble, _disassemble, _tile_batches, gauss_features, plain_blend,
    plain_blend_bwd,
)
from hugs_tpu_torch.render.oracle import LOG_TEPS
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import (
    TILE, _tight_cull_keep, bin_gaussians, tile_grid,
)

W, H = 960, 540
N = 50_000
SMOKE = {"n": 300, "width": 64, "height": 48}   # a --device cpu run's size
VARIANTS = cuda_blend.SKELETON_MODES + ("full",)
TIMED = ("staging_only", "skeleton_no_cull", "skeleton_no_shuffle",
         "skeleton", "full", "fwd_bwd")
_WARPS = TILE // cuda_blend.WARP_RECT[1]   # warps per tile


def bench_scene(n: int = N, seed: int = 0, device="cuda") -> dict:
    """bench.py's scene, drawn with numpy from `seed` (raw draws in
    chip_smoke.py's order), activated: uniform means in [-2, 2]^3 with
    z * 1.5 + 5, scales exp(N(0, 0.3^2) - 4), normalised normal
    quaternions, opacity sigmoid(N(0, 1)), SH degree 3 N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 1.5 + 5.0
    log_scales = (rng.normal(size=(n, 3)) * 0.3 - 4.0).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    opacity_logit = rng.normal(size=(n,)).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    q = torch.as_tensor(rotq, device=device)
    return dict(
        xyz=torch.as_tensor(means, device=device),
        scales=torch.exp(torch.as_tensor(log_scales, device=device)),
        rotq=q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                             min=1e-8),
        opacity=torch.sigmoid(torch.as_tensor(opacity_logit, device=device)),
        shs=torch.as_tensor(shs, device=device))


def slot_budget(demand: int) -> int:
    """A budget 15 % over a slot demand, in whole 8192-slot pages."""
    return -(-(demand * 23 // 20) // 8192) * 8192


def frame(device="cuda", n: int = N, width: int = W, height: int = H,
          seed: int = 0) -> dict:
    """The frame K2 is timed on: bins at 15 % over the slot demand, the
    forward's final log T and per-pixel walk (K1 on the card, the plain
    blend on the CPU), bg 0 and d(loss)/d(raw colour) = ones. Returns
    feat, bins, bg, grad, log_t, n_walked, width, height."""
    a = bench_scene(n, seed, device)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.55, device=device)
    pg = project_gaussians(a["xyz"], a["scales"], a["rotq"], a["opacity"],
                           a["shs"], cam, width, height, 3)
    demand = int(bin_gaussians(pg, width, height, 4 * n).n_slots)
    bins = bin_gaussians(pg, width, height, slot_budget(demand))
    if bool(bins.overflowed):
        raise AssertionError("the frame overflowed its budget")
    return _with_walk(gauss_features(pg), bins, width, height)


def _with_walk(feat, bins, width: int, height: int) -> dict:
    """A frame's dict: feat and bins with bg 0, the forward's final log T
    and per-pixel walk (K1 on the card, the plain blend on the CPU) and
    d(loss)/d(raw colour) = ones."""
    device = feat.device
    bg = torch.zeros(3, device=device)
    fwd = (feat, bins.gauss_id, bins.starts, bins.ends, bg, width, height)
    if feat.device.type == "cuda":
        _, log_t, n_walked, _ = cuda_blend.blend_fwd(*fwd)
    else:
        _, log_t, pairs = plain_blend(*fwd)
        n_walked = pairs[0].to(torch.int32)
    return dict(feat=feat, bins=bins, bg=bg, log_t=log_t, n_walked=n_walked,
                grad=torch.ones((3, height, width), device=device),
                width=width, height=height)


def training_frame(device="cuda", n: int = N, width: int = W,
                   height: int = H, seed: int = 0,
                   capacity: int = 65_536, noise: float = 0.02) -> dict:
    """chip_smoke.py's training frame (phase 3b's step 0, the one phase 3k
    holds the POWER_MXU kernels on): bench_scene's means moved by
    N(0, noise^2) (seed + 3) as a point cloud, create_from_pcd with grey
    colours at `capacity` (kNN scales, opacity 0.1), the camera at the
    origin; bins at 15 % over the slot demand. Returns frame()'s keys
    (bg 0, d(loss)/d(raw colour) = ones)."""
    from hugs_tpu_torch.models.scene_gs import create_from_pcd, scene_forward
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 1.5 + 5.0
    pcd = means + np.random.default_rng(seed + 3).normal(
        scale=noise, size=means.shape).astype(np.float32)
    gs = create_from_pcd(pcd, np.full((n, 3), 0.5, np.float32), capacity,
                         device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.55, device=device)
    with torch.no_grad():
        a = scene_forward(gs)
        pg = project_gaussians(a["xyz"], a["scales"], a["rotq"],
                               a["opacity"], a["shs"], cam, width, height,
                               a["active_sh_degree"], alive=a["alive"])
        demand = int(bin_gaussians(pg, width, height, 4 * capacity).n_slots)
        bins = bin_gaussians(pg, width, height, slot_budget(demand))
        feat = gauss_features(pg)
    return _with_walk(feat, bins, width, height)


def plain_variant(mode: str, feat, gauss_id, starts, ends, bg, width,
                  height, grad_raw, log_t, n_walked):
    """The variant's function in plain PyTorch, with blend_bwd's
    arguments. Returns (out, grad_bg): grad_bg = sum_p g T_fin
    [log T_fin >= log 1e-4], as K2's; out is, for
      full                 plain_blend_bwd's grad_feat;
      skeleton             grad_feat (N, 10): column k < 9 of Gaussian i
                           is f_ik times the sum of g_r over the (pixel,
                           instance of i) pairs within the pixel's walk
                           whose warp's cull keeps the instance;
      skeleton_no_cull     the same without the cull;
      skeleton_no_shuffle  (H, W): per pixel, g_r times the sum of f_ik,
                           k < 9, over the instances of those pairs;
      staging_only         (T,): per tile, the sum of the feature rows of
                           the first `walk` instances of its list, walk
                           the most any of its pixels walked."""
    if mode == "full":
        return plain_blend_bwd(feat, gauss_id, starts, ends, bg, width,
                               height, grad_raw)
    if mode not in cuda_blend.SKELETON_MODES:
        raise ValueError(f"unknown variant {mode!r}")
    dev = feat.device
    nx, _ = tile_grid(width, height, TILE)
    t_fin = torch.where(log_t >= LOG_TEPS, torch.exp(log_t), 0.0)
    grad_bg = (grad_raw * t_fin).sum(dim=(1, 2))
    nw = _disassemble(n_walked[None], TILE)[:, 0]        # (T, P)
    g_r = _disassemble(grad_raw[:1], TILE)[:, 0]         # (T, P)
    walk = nw.amax(1)
    warp_of = torch.arange(nw.shape[1], device=dev) // 32
    sums = torch.zeros((feat.shape[0], 9), dtype=feat.dtype, device=dev)
    # per tile: a checksum (staging_only) or its pixels (no_shuffle)
    tiles = torch.zeros(nw.shape if mode == "skeleton_no_shuffle" else
                        nw.shape[:1], dtype=feat.dtype, device=dev)
    for t, g, live, _, _ in _tile_batches(gauss_id, starts, ends, width,
                                          height, None, TILE):
        f = feat[g]                                          # (B, K, 10)
        k = torch.arange(g.shape[1], device=dev)
        if mode == "staging_only":
            staged = live & (k[None] < walk[t, None])
            tiles[t] = (f.sum(-1) * staged).sum(-1)
            continue
        pair = live[:, :, None] & (k[None, :, None] < nw[t][:, None, :])
        if mode != "skeleton_no_cull":
            w = torch.arange(_WARPS, device=dev)
            tx = (t % nx)[:, None, None].expand(-1, _WARPS, 1)
            ty = ((t // nx) * _WARPS)[:, None, None] + w[None, :, None]
            keep = _tight_cull_keep(*(f[:, None, :, c] for c in
                                      (4, 5, 6, 7, 8, 3, 9)),
                                    tx, ty, cuda_blend.WARP_RECT)  # (B, 8, K)
            pair &= keep[:, warp_of, :].transpose(1, 2)
        weight = pair.to(feat.dtype) * g_r[t][:, None, :]    # (B, K, P)
        if mode == "skeleton_no_shuffle":
            tiles[t] = torch.einsum("bkp,bkc->bp", weight, f[..., :9])
        else:
            sums.index_add_(0, g.reshape(-1),
                            (f[..., :9] * weight.sum(-1)[..., None])
                            .reshape(-1, 9))
    if mode == "staging_only":
        return tiles, grad_bg
    if mode == "skeleton_no_shuffle":
        return _assemble(tiles[:, None], width, height, TILE)[0], grad_bg
    return torch.cat([sums, torch.zeros_like(feat[:, 9:])], dim=1), grad_bg


def variant(mode: str, fr: dict):
    """One launch of the variant on frame `fr` (the kernel for CUDA
    tensors, the plain version for CPU ones): (out, grad_bg)."""
    b = fr["bins"]
    args = (fr["feat"], b.gauss_id, b.starts, b.ends, fr["bg"], fr["width"],
            fr["height"], fr["grad"], fr["log_t"], fr["n_walked"])
    if fr["feat"].device.type == "cpu":
        return plain_variant(mode, *args)
    if mode == "full":
        return cuda_blend.blend_bwd(*args)
    return cuda_blend.blend_bwd_skeleton(mode, *args)


def fwd_bwd(fr: dict):
    """K1 then K2 on the frame's bins, as the script's full_grad."""
    b = fr["bins"]
    fwd = (fr["feat"], b.gauss_id, b.starts, b.ends, fr["bg"], fr["width"],
           fr["height"])
    _, log_t, n_walked, _ = cuda_blend.blend_fwd(*fwd)
    return cuda_blend.blend_bwd(*fwd, fr["grad"], log_t, n_walked)


def measure(fr: dict, reps: int = 20, inner: int = 20) -> dict:
    """Each variant's output checksum and, on the card, its device ms
    (median of `reps` spans of `inner` back-to-back launches), share of
    K2's (full) time and resident blocks per SM (K2's for full and
    fwd_bwd's K2)."""
    on_card = fr["feat"].is_cuda
    b = fr["bins"]
    out = {"width": fr["width"], "height": fr["height"],
           "gaussians": fr["feat"].shape[0],
           "instances": int((b.ends - b.starts).sum()),
           "slots": b.gauss_id.shape[0],
           "pairs_walked": int(fr["n_walked"].long().sum()),
           "device": card() if on_card else "cpu", "variants": {}}
    for mode in TIMED:
        if mode == "fwd_bwd":
            if not on_card:
                continue
            fn = lambda: fwd_bwd(fr)     # noqa: E731
        else:
            fn = lambda m=mode: variant(m, fr)     # noqa: E731
        res, grad_bg = fn()
        entry = {"checksum": float(res.double().sum()),
                 "grad_bg": grad_bg.tolist()}
        if on_card:
            entry["ms"] = device_ms(fn, reps=reps, inner=inner)
        out["variants"][mode] = entry
    if on_card:
        full = out["variants"]["full"]["ms"]
        residency = cuda_blend.skeleton_residency()
        k2 = cuda_blend.blocks_per_sm()["K2"]
        for mode, entry in out["variants"].items():
            entry["share_of_full"] = entry["ms"] / full
            entry.update(residency.get(mode, {"blocks_per_sm": k2}))
    return out


def main(argv=None) -> None:
    args = parse_args(__doc__.splitlines()[0], argv,
                      seed=(int, 0, "the scene's numpy seed"))
    size = SMOKE if args.device == "cpu" else {}
    fr = frame(args.device, seed=args.seed, **size)
    emit(measure(fr), args.out)


if __name__ == "__main__":
    main()
