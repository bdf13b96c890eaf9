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

The script's second half, the POWER_MXU mode (the exponent and K2's pixel
moments evaluated on the TPU's MXU), has no counterpart: the port does
not carry that mode (render/cuda_blend.py).

Run: `python -m hugs_tpu_torch.micro.kernel_parity [--device cpu]
[--out F]` (default F: runs/kernel_parity.json). Prints one JSON
line per case, in the script's keys, then PASS or FAIL; exits 1 on FAIL
and 2 without a card unless --device cpu.
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
from hugs_tpu_torch.render.tiles import TILE, bin_gaussians

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
    return torch.autograd.grad(loss, [leaves[k] for k in PARAMS],
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


def run_case(name: str, device) -> dict:
    """One case: the tiled path (K1 / K2 on the card) against the plain
    blend, end to end and, on the card, kernel by kernel. Returns the
    script's record plus the binning's and the kernels' numbers."""
    device = torch.device(device)
    inp, leaves, cam, pg, bins, budget = case_bins(name, device)
    W, H = inp["W"], inp["H"]
    bg = torch.as_tensor(inp["bg"], device=device)
    target = torch.as_tensor(inp["target"], device=device)
    feat = gauss_features(pg)
    args = (bins.gauss_id, bins.starts, bins.ends, bg, W, H)

    img_k = cuda_blend.blend_feat(feat, *args)
    img_p = clip01(plain_blend(feat, *args)[0])
    g_k = _grads(img_k, target, leaves)
    g_p = _grads(img_p, target, leaves)
    rel = {}
    for k, a, b in zip(PARAMS, g_p, g_k):
        rel[k] = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
    out = {"case": name, "W": W, "H": H, "n": CASES[name]["n"],
           "budget": budget, **chunk_stats(bins),
           "max_abs_dimg": float((img_k - img_p).detach().abs().max()),
           "rel_dgrad": rel}
    ok = out["max_abs_dimg"] < IMG_BAR and max(rel.values()) < GRAD_BAR
    if device.type == "cuda":
        f = feat.detach()
        raw_k, log_t, n_walked, _ = cuda_blend.blend_fwd(f, *args)
        raw_p = plain_blend(f, *args)[0]
        g = torch.rand((3, H, W), generator=torch.Generator(
            device=device).manual_seed(TARGET_SEED), device=device)
        got = cuda_blend.blend_bwd(f, *args, g, log_t, n_walked)
        want = plain_blend_bwd(f, *args, g)
        torch.cuda.synchronize()
        out["k1"] = k1_bars(raw_k, raw_p)
        out["k2"] = k2_bars(*got, *want)
        ok = ok and out["k1"]["ok"] and out["k2"]["ok"]
    out["ok"] = ok
    return out


def run_all(device, names=tuple(CASES)) -> tuple[list, bool]:
    """Every case in order; (the records, whether all held)."""
    cases = [run_case(n, device) for n in names]
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
    cases, ok = run_all(dev)
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
