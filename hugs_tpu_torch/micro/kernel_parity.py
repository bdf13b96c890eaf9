"""The blend kernels on scenes that drive their edge paths, each held to
its plain version: the counterpart of scripts/kernel_parity_tpu.py.

Four scenes, the script's, drawn with numpy from each case's seed:
  multichunk_empty  3,000 Gaussians in a tight cluster (spread 0.25) at
                    128x96: the densest tiles hold several of K1's
                    256-instance batches, and the image's edges are empty;
  saturating        2,000 near-opaque Gaussians (opacity sigmoid(x + 2.5))
                    at 128x96: the early exit where every pixel of a tile
                    saturates;
  tile16            1,500 Gaussians at 96x64 (the script's tile-16 scene;
                    the port's tile is always 16);
  tight_budget      800 Gaussians at 96x64 with the slot budget equal to
                    the exact demand of render/tiles.py's binning (16-px
                    tiles; every (Gaussian, tile) span slot before the
                    tight cull): one slot less overflows.
The script's tile-32 cases keep only their scene, width, height and
budget here. Each case renders the scene through the port's tiled path
(K1 forward, K2 backward for CUDA tensors) and through the plain blend
(render/blend.py's plain_blend under autograd), and compares the images
(max |d|) and the gradients of an L1 loss against a seeded target with
respect to the five Gaussian inputs (max |d| / max |g| per input), at the
script's bars: image < 5e-5, gradients < 5e-4. On the card it also holds
K1's raw image to plain_blend and K2's per-Gaussian gradient to
plain_blend_bwd at the kernels' own bars (PERF.md section 2): K1 equal on
at least 99.99 % of pixels to 2e-5 and on all to 1e-3; K2 per column on at
least 99.9 % of entries to 1e-5 + 1e-3 |g| with ||d|| / ||g|| <= 1e-4.
On CPU tensors both sides are the plain blend (the tests hold that path
to hugs_tpu's tiled backend instead).

A fifth scene, `gather` (gather_inputs: a feature table and lists built
by hand, not projected), drives the POWER_MXU kernels' gathered groups:
sparse warp masks, groups across 32-slot windows and batches, groups
over all four grid points, means outside the tile, saturation part-way
through a group; its gradients are with respect to the feature table.

The script's second half (kernel_parity_tpu.py:114-131) runs the
cases again in the POWER_MXU mode (render/cuda_blend.py: K1's and K2's
exponent on the tensor cores; the plain mode on CPU tensors), each held
at the same bars against the exact path: the mode's image and gradients
against the exact plain blend's. On the card K1 and K2 in the mode are
held to the plain mode at the kernels' bars.

Run: `python -m hugs_tpu_torch.micro.kernel_parity [--device cpu]
[--out F]` (default F: runs/kernel_parity.json). Prints one JSON
line per case, in the script's keys (`power_mxu` false for the first
five, true for the second five), then PASS or FAIL; exits 1 on FAIL and
2 without a card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from hugs_tpu_torch.render import cuda_blend, make_camera
from hugs_tpu_torch.render.blend import (
    gauss_features, plain_blend, plain_blend_bwd,
)
from hugs_tpu_torch.render.oracle import clip01
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import TILE, TileBins, bin_gaussians

# the script's cases (kernel_parity_tpu.py:113-140), tile dropped
CASES = {
    "multichunk_empty": dict(n=3000, seed=0, W=128, H=96, budget=65536,
                             spread=0.25),
    "saturating": dict(n=2000, seed=1, W=128, H=96, budget=65536,
                       op_hi=True, spread=0.3),
    "tile16": dict(n=1500, seed=2, W=96, H=64, budget=65536, spread=0.4),
    "tight_budget": dict(n=800, seed=3, W=96, H=64, budget=65536,
                         spread=0.6, tight=True),
}
# the scene that stresses the POWER_MXU kernels' gathered groups (a
# feature table and lists built by hand; gather_inputs)
GATHER = "gather"
GATHER_W, GATHER_H, GATHER_SEED = 32, 16, 5
GATHER_LIST = 640       # instances in each tile's list
PARAMS = ("means", "scales", "rotq", "opacity", "shs")
BG = (0.2, 0.3, 0.4)
TARGET_SEED = 7
K1_BATCH = 256          # the instances K1 stages per batch of a tile
# the script's bars (kernel_parity_tpu.py:141-142)
IMG_BAR, GRAD_BAR = 5e-5, 5e-4
# the kernels' bars on the card (PERF.md section 2, chip_smoke.py)
PIXEL_ATOL, MIN_SHARE, MAX_ABS = 2e-5, 0.9999, 1e-3
GRAD_ATOL, GRAD_RTOL, GRAD_SHARE, GRAD_REL_NORM = 1e-5, 1e-3, 0.999, 1e-4
DEFAULT_OUT = os.path.join("runs", "kernel_parity.json")


def make_scene(n: int, seed: int, spread: float = 1.0, z_span: float = 2.0,
               op_hi: bool = False) -> dict:
    """The script's scene (make_scene, kernel_parity_tpu.py:35-46) drawn
    with numpy: means uniform in [-spread, spread]^3 with z scaled to
    z_span and moved to 4; scales exp(N(0, 0.3^2) - 2.5); normalised
    normal quaternions; opacity sigmoid(N(0, 1) (+ 2.5 with op_hi)); SH
    degree 3 N(0, 0.3^2). float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * np.float32(z_span / spread) + np.float32(4.0)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.5).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    rotq /= np.linalg.norm(rotq, axis=-1, keepdims=True)
    op = rng.normal(size=n) + (2.5 if op_hi else 0.0)
    opacity = (1.0 / (1.0 + np.exp(-op))).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return dict(means=means, scales=scales, rotq=rotq, opacity=opacity,
                shs=shs)


def case_inputs(name: str) -> dict:
    """A case's numpy inputs: the scene, the camera (identity, fov 0.9 x
    0.7), the background and the loss's target (uniform, seed 7)."""
    c = CASES[name]
    scene = make_scene(c["n"], c["seed"], spread=c["spread"],
                       op_hi=c.get("op_hi", False))
    target = np.random.default_rng(TARGET_SEED).uniform(
        size=(3, c["H"], c["W"])).astype(np.float32)
    return dict(scene=scene, target=target, bg=np.asarray(BG, np.float32),
                R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
                fovx=0.9, fovy=0.7, W=c["W"], H=c["H"])


def exact_budget(pg, width: int, height: int, probe: int) -> int:
    """The exact slot demand of render/tiles.py's binning of pg (16-px
    tiles, no alignment), from a probe budget that must hold it."""
    bins = bin_gaussians(pg, width, height, probe, TILE)
    if bool(bins.overflowed):
        raise ValueError(f"the probe budget {probe} overflowed: demand "
                         f"{int(bins.n_slots)}")
    return int(bins.n_slots)


def _splats(rng, n, tx0, mx, my, sigma, op):
    """n isotropic splats of the tile at tx0 as feature rows (N, 10) in
    gauss_features' layout: colours uniform, opacity op, mean (tx0 + mx,
    my), conic 1 / sigma^2 with a small random shear, radius ceil(3
    sigma)."""
    f = np.zeros((n, 10), np.float32)
    f[:, 0:3] = rng.uniform(size=(n, 3))
    f[:, 3] = op
    f[:, 4] = tx0 + mx
    f[:, 5] = my
    c = 1.0 / np.square(sigma) * np.ones(n)
    f[:, 6] = c
    f[:, 7] = rng.uniform(-0.2, 0.2, n) * c
    f[:, 8] = c
    f[:, 9] = np.ceil(3.0 * sigma)
    return f


def gather_inputs() -> dict:
    """The scene that drives the POWER_MXU kernels' gathered groups (the
    next 8 instances a warp's cull keeps, blend_common.cuh), drawn with
    numpy from GATHER_SEED: a feature table (N, 10) in gauss_features'
    layout and a list of GATHER_LIST instances for each of the two 16x16
    tiles of a 32x16 image (tile 1's splats are tile 0's kind, moved by 16
    pixels), in list order:
      0-383    small splats (sigma 0.6) on pixel rows 0.5, 6.5 and 12.5 in
               turn: warps 0, 3 and 6 each keep every third slot, so
               their groups straddle the 32-slot windows and K1's
               256-instance batch (and K2's batches of 128);
      384-415  large faint splats (sigma 5) centred on the tile's four
               grid points in turn: every group of 8 kept instances there
               spans all four, both k steps;
      416-479  medium splats (sigma 2.5) with their means 1-5 pixels
               outside the tile on each side in turn (the grid point
               clipped to the tile, the residual beyond 4 pixels);
      480-639  near-opaque splats (opacity 0.995, sigma 1.2) at (5.5, 9.5)
               in every other slot, small splats between: the pixels
               there saturate part-way through a group.
    Also the background and the L1 loss's target (uniform, TARGET_SEED)."""
    rng = np.random.default_rng(GATHER_SEED)
    n = GATHER_LIST
    tiles = []
    for tx0 in (0.0, 16.0):
        band = np.arange(384) % 3
        a = _splats(rng, 384, tx0, rng.uniform(0, 16, 384),
                    np.array([0.5, 6.5, 12.5])[band]
                    + rng.uniform(-0.3, 0.3, 384), 0.6,
                    rng.uniform(0.2, 0.45, 384))
        q = np.arange(32) % 4
        b = _splats(rng, 32, tx0, 4.0 + 8.0 * (q % 2) + rng.uniform(-1, 1, 32),
                    4.0 + 8.0 * (q // 2) + rng.uniform(-1, 1, 32), 5.0, 0.05)
        side = np.arange(64) % 4
        off = rng.uniform(1, 5, 64)
        along = rng.uniform(0, 16, 64)
        c = _splats(rng, 64, tx0,
                    np.select([side == 0, side == 1], [-off, 16.0 + off],
                              along),
                    np.select([side == 2, side == 3], [-off, 16.0 + off],
                              along), 2.5, rng.uniform(0.2, 0.6, 64))
        opaque = np.arange(160) % 2 == 0
        d = _splats(rng, 160, tx0,
                    np.where(opaque, 5.5 + rng.uniform(-0.2, 0.2, 160),
                             rng.uniform(0, 16, 160)),
                    np.where(opaque, 9.5 + rng.uniform(-0.2, 0.2, 160),
                             rng.uniform(0, 16, 160)),
                    np.where(opaque, 1.2, 0.6),
                    np.where(opaque, 0.995, rng.uniform(0.2, 0.45, 160)))
        tiles.append(np.concatenate([a, b, c, d]))
    feat = np.concatenate(tiles).astype(np.float32)
    target = np.random.default_rng(TARGET_SEED).uniform(
        size=(3, GATHER_H, GATHER_W)).astype(np.float32)
    return dict(feat=feat, gauss_id=np.arange(2 * n, dtype=np.int32),
                starts=np.array([0, n], np.int32),
                ends=np.array([n, 2 * n], np.int32), target=target,
                bg=np.asarray(BG, np.float32), W=GATHER_W, H=GATHER_H)


def gather_bins(inp: dict, device) -> TileBins:
    """gather_inputs' lists as TileBins on `device`."""
    n = int(inp["gauss_id"].shape[0])
    total = torch.tensor(n, dtype=torch.int64, device=device)
    return TileBins(torch.as_tensor(inp["gauss_id"], device=device),
                    torch.as_tensor(inp["starts"], device=device),
                    torch.as_tensor(inp["ends"], device=device), total,
                    total, torch.tensor(False, device=device), total)


def case_bins(name: str, device) -> tuple:
    """(inputs as leaf tensors on `device`, camera, projected set, bins,
    budget) of a case; tight_budget's budget is its exact demand. Raises
    where the bins overflow."""
    inp = case_inputs(name)
    c = CASES[name]
    W, H = inp["W"], inp["H"]
    leaves = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in inp["scene"].items()}
    cam = make_camera(inp["R"], inp["t"], inp["fovx"], inp["fovy"],
                      device=device)
    pg = project_gaussians(*(leaves[k] for k in PARAMS), cam, W, H, 3)
    budget = c["budget"]
    if c.get("tight"):
        budget = exact_budget(pg, W, H, budget)
    bins = bin_gaussians(pg, W, H, budget, TILE)
    if bool(bins.overflowed):
        raise AssertionError(f"{name}: budget {budget} overflowed (demand "
                             f"{int(bins.n_slots)})")
    return inp, leaves, cam, pg, bins, budget


def chunk_stats(bins) -> dict:
    """The binning's record: the densest tile's batches of K1_BATCH, the
    empty tiles, the tiles, the instances and the overflow flag."""
    counts = (bins.ends - bins.starts).long().cpu().numpy()
    return {"max_chunks_per_tile": int(-(-counts.max() // K1_BATCH)),
            "max_instances_per_tile": int(counts.max()),
            "empty_tiles": int((counts == 0).sum()),
            "tiles": int(counts.shape[0]),
            "n_instances": int(bins.n_instances),
            "n_slots": int(bins.n_slots),
            "overflowed": bool(bins.overflowed)}


def _grads(img, target, leaves):
    loss = torch.mean(torch.abs(img - target))
    return torch.autograd.grad(loss, list(leaves.values()),
                               retain_graph=True)


def k1_bars(got: torch.Tensor, want: torch.Tensor) -> dict:
    """K1's bars on a raw image: the share within PIXEL_ATOL and the
    largest difference."""
    d = (got - want).abs().amax(0)
    share = float((d <= PIXEL_ATOL).float().mean())
    mx = float(d.max())
    return {"share": share, "max_abs": mx,
            "ok": share >= MIN_SHARE and mx <= MAX_ABS}


def k2_bars(got_f, got_b, want_f, want_b) -> dict:
    """K2's bars on grad_feat per column (9 live columns; the radius's
    zero) and grad_bg."""
    worst_share, worst_rel, max_abs = 1.0, 0.0, 0.0
    for c in range(9):
        d = (got_f[:, c] - want_f[:, c]).abs()
        max_abs = max(max_abs, float(d.max()))
        within = d <= GRAD_ATOL + GRAD_RTOL * want_f[:, c].abs()
        worst_share = min(worst_share, float(within.float().mean()))
        worst_rel = max(worst_rel, float(d.norm()) / max(
            float(want_f[:, c].norm()), 1e-30))
    bg_rel = float(((got_b - want_b).abs() / want_b.abs().clamp(
        min=1e-30)).max())
    ok = (worst_share >= GRAD_SHARE and worst_rel <= GRAD_REL_NORM
          and float(got_f[:, 9].abs().max()) == 0.0 and bg_rel <= 1e-4)
    return {"worst_column_share": worst_share,
            "worst_column_rel_norm": worst_rel, "max_abs": max_abs,
            "bg_rel": bg_rel, "ok": ok}


def run_case(name: str, device, power_mxu: bool = False) -> dict:
    """One case: the tiled path (K1 / K2 on the card) against the plain
    blend, end to end and, on the card, kernel by kernel. With power_mxu
    the tiled path runs in the POWER_MXU mode and is held end to end to
    the exact plain blend, kernel by kernel to the plain mode. Returns the
    script's record plus the binning's and the kernels' numbers."""
    device = torch.device(device)
    if name == GATHER:
        inp = gather_inputs()
        bins = gather_bins(inp, device)
        feat = torch.tensor(inp["feat"], device=device, requires_grad=True)
        leaves, budget, n = {"feat": feat}, int(bins.n_slots), len(feat)
    else:
        inp, leaves, cam, pg, bins, budget = case_bins(name, device)
        feat, n = gauss_features(pg), CASES[name]["n"]
    W, H = inp["W"], inp["H"]
    bg = torch.as_tensor(inp["bg"], device=device)
    target = torch.as_tensor(inp["target"], device=device)
    args = (bins.gauss_id, bins.starts, bins.ends, bg, W, H)

    img_k = cuda_blend.blend_feat(feat, *args, power_mxu=power_mxu)
    img_p = clip01(plain_blend(feat, *args)[0])
    g_k = _grads(img_k, target, leaves)
    g_p = _grads(img_p, target, leaves)
    rel = {}
    for k, a, b in zip(leaves, g_p, g_k):
        rel[k] = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
    out = {"case": name, "W": W, "H": H, "n": n,
           "power_mxu": power_mxu, "budget": budget, **chunk_stats(bins),
           "max_abs_dimg": float((img_k - img_p).detach().abs().max()),
           "rel_dgrad": rel}
    ok = out["max_abs_dimg"] < IMG_BAR and max(rel.values()) < GRAD_BAR
    if device.type == "cuda":
        f = feat.detach()
        raw_k, log_t, n_walked, _ = cuda_blend.blend_fwd(f, *args,
                                                         power_mxu)
        raw_p = plain_blend(f, *args, power_mxu=power_mxu)[0]
        g = torch.rand((3, H, W), generator=torch.Generator(
            device=device).manual_seed(TARGET_SEED), device=device)
        got = cuda_blend.blend_bwd(f, *args, g, log_t, n_walked, power_mxu)
        want = plain_blend_bwd(f, *args, g, power_mxu)
        torch.cuda.synchronize()
        out["k1"] = k1_bars(raw_k, raw_p)
        out["k2"] = k2_bars(*got, *want)
        ok = ok and out["k1"]["ok"] and out["k2"]["ok"]
    out["ok"] = ok
    return out


def run_all(device, names=tuple(CASES) + (GATHER,), modes=(False,)
            ) -> tuple[list, bool]:
    """Every case in order, in each of `modes` (power_mxu) in turn; (the
    records, whether all held)."""
    cases = [run_case(n, device, m) for m in modes for n in names]
    return cases, all(c["ok"] for c in cases)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (default %(default)s)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from hugs_tpu_torch import build
        build.build([cuda_blend.SOURCE, cuda_blend.BWD_SOURCE])
    cases, ok = run_all(dev, modes=(False, True))
    for c in cases:
        print(json.dumps(c))
    print("PASS" if ok else "FAIL", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": str(dev), "pass": ok, "cases": cases}, f,
                  indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
