"""The port's micro-benchmarks: the counterparts of hugs_tpu's TPU probes
under scripts/, each a hand-written CUDA kernel with a plain PyTorch
version and an entry point.

  vpu_peak    S2, scripts/vpu_peak.py: the card's elementwise rate on
              independent FMA chains, one dependent chain and the forward
              blend's per-pair mix (csrc/vpu_peak.cu);
  micro_bf16  S1, scripts/micro_bf16.py: chained madd / exp passes in
              float32 and bfloat16 (csrc/micro_bf16.cu);
  micro_bwd   S3, scripts/micro_bwd.py: K2's skeleton variants, which
              split K2's fixed cost from its gradient arithmetic
              (csrc/blend_bwd.cu, render/cuda_blend.blend_bwd_skeleton).
  kernel_parity  scripts/kernel_parity_tpu.py: K1 and K2 on four scenes
              that drive their edge paths, against their plain versions
              (no kernel of its own).

Run one with `python -m hugs_tpu_torch.micro.<name>`: on the card at the
scripts' full sizes by default, or `--device cpu` for the plain versions
at a small size (tests only; no times).
Each prints one JSON object, and writes it to a file only if `--out`
names one; kernel_parity prints a line per scene and PASS or FAIL, and
writes its record to --out (by default runs/kernel_parity.json).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
from pathlib import Path

import torch


def device_ms(fn, reps: int = 20, inner: int = 1, warmup: int = 3) -> float:
    """Median over `reps` spans of the CUDA-event time of `inner`
    back-to-back calls of fn(), divided by `inner`, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_kernels(fn, reps: int = 5):
    """From torch.profiler's CUDA trace of `reps` calls of fn: device time
    by kernel name (us per call), device kernels per call, and the span
    per call from the first kernel's start to the last one's end (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: tracing host ops would slow the host, which
    # sets the span
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, n, first, last = {}, 0, math.inf, -math.inf
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us() / reps
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            n += 1
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    return by_name, n / reps, (last - first) / reps if n else 0.0


def warp_cull_counts(feat, bins, n_walked, width: int, height: int) -> dict:
    """What the warp cull leaves K1 and K2 to do on one frame, from their
    own device cull (render/cuda_blend.py::warp_cull). K2's warps cull
    their tile's instances up to the most any of their 32 pixels walked
    in K1; K1's cull whole chunks of 32 until every pixel of the warp has
    saturated. Returns each kernel's culled (warp, instance) pairs ("K1",
    "K2") and the share dropped ("K1_dropped", "K2_dropped"), K2's kept
    ones ("K2_kept"), and the (pixel, instance) pairs both kernels test:
    the kept instances before each pixel's n_walked ("tested")."""
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.tiles import TILE, tile_grid
    dev = feat.device
    nx, ny = tile_grid(width, height, TILE)
    rows = cuda_blend.WARP_RECT[1]
    wpt = TILE // rows   # warps per tile
    nw = torch.zeros((ny * TILE, nx * TILE), dtype=torch.int64, device=dev)
    nw[:height, :width] = n_walked
    # (tiles * wpt, 32): the n_walked of each warp's pixels
    per_warp = nw.reshape(ny, wpt, rows, nx, TILE) \
        .permute(0, 3, 1, 2, 4).reshape(-1, rows * TILE)
    k2_len = per_warp.amax(1)
    count = (bins.ends - bins.starts).long().repeat_interleave(wpt)
    k1_len = torch.minimum((k2_len + 31) // 32 * 32, count)
    seg0 = torch.cumsum(k1_len, 0) - k1_len
    warp_of = torch.repeat_interleave(
        torch.arange(k1_len.numel(), device=dev), k1_len)
    offset = torch.arange(warp_of.numel(), device=dev) - seg0[warp_of]
    t, w = warp_of // wpt, warp_of % wpt
    gid = bins.gauss_id[bins.starts.long()[t] + offset]
    keep = cuda_blend.warp_cull(feat, gid, (t % nx).to(torch.int32),
                                ((t // nx) * wpt + w).to(torch.int32))
    in_k2 = offset < k2_len[warp_of]
    kept = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(keep.long(), 0)])
    s0 = seg0[:, None]
    out = {"tested": int((kept[s0 + per_warp] - kept[s0]).sum()),
           "K2_kept": int((keep & in_k2).sum())}
    for k, n in (("K1", int(keep.numel())), ("K2", int(in_k2.sum()))):
        kept_k = int(keep.sum()) if k == "K1" else out["K2_kept"]
        out[k] = n
        out[k + "_dropped"] = 1.0 - kept_k / n if n else 0.0
    return out


def feat_rows_read(bins) -> int:
    """The rows of feat that K1 and K2 read: the distinct gauss_id of the
    valid slots [starts, ends) of each tile."""
    n_slot = bins.gauss_id.shape[0]
    starts, ends = bins.starts.long(), bins.ends.long()
    edge = torch.zeros(n_slot + 1, dtype=torch.int64,
                       device=bins.gauss_id.device)
    edge.index_add_(0, starts, torch.ones_like(starts))
    edge.index_add_(0, ends, -torch.ones_like(ends))
    valid = torch.cumsum(edge, 0)[:n_slot] > 0
    return int(torch.unique(bins.gauss_id[valid]).numel())


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def parse_args(description: str, argv=None, **extra) -> argparse.Namespace:
    """The entry points' common arguments (--device, --out) and `extra`
    ones, each name -> (type, default, help)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) or cpu (the plain versions "
                         "at a small size, no times)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    for name, (typ, default, text) in extra.items():
        ap.add_argument(f"--{name}", type=typ, default=default, help=text)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    return args


_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def sass_opcodes(lib: Path, function: str) -> list[str]:
    """The opcodes, in order, of the function whose name contains
    `function` in the SASS of library `lib`, from cuobjdump beside nvcc."""
    from hugs_tpu_torch import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool})")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops, inside, found = [], False, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
            found = found or inside
        elif inside:
            m = _SASS_LINE.match(line)
            if m:
                ops.append(m.group(1))
    if not found:
        raise RuntimeError(f"no function {function} in the SASS of {lib}")
    return ops


def emit(result: dict, out: str | None) -> None:
    """Print `result` as one JSON line; also write it to `out` if given."""
    text = json.dumps(result)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
