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
import time
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


def _walk_pairs(feat, bins, n_walked, width: int, height: int,
                chunk: int = 32) -> dict:
    """The (warp, instance) pairs K1's warps cull on one frame, and the
    device cull's verdict on each: K1's warps cull whole chunks of `chunk`
    of their tile's list (32; the POWER_MXU mode's K1 its batches of 256)
    until every pixel of the warp has saturated, K2's up to the most any
    of their 32 pixels walked in K1."""
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
    k1_len = torch.minimum((k2_len + chunk - 1) // chunk * chunk, count)
    seg0 = torch.cumsum(k1_len, 0) - k1_len
    warp_of = torch.repeat_interleave(
        torch.arange(k1_len.numel(), device=dev), k1_len)
    offset = torch.arange(warp_of.numel(), device=dev) - seg0[warp_of]
    t, w = warp_of // wpt, warp_of % wpt
    gid = bins.gauss_id[bins.starts.long()[t] + offset]
    keep = cuda_blend.warp_cull(feat, gid, (t % nx).to(torch.int32),
                                ((t // nx) * wpt + w).to(torch.int32))
    return {"gid": gid, "t": t, "w": w, "nx": nx, "keep": keep,
            "in_k2": offset < k2_len[warp_of], "seg0": seg0,
            "per_warp": per_warp, "warp_of": warp_of, "offset": offset}


def warp_cull_counts(feat, bins, n_walked, width: int, height: int) -> dict:
    """What the warp cull leaves K1 and K2 to do on one frame, from their
    own device cull (render/cuda_blend.py::warp_cull; _walk_pairs). Returns
    each kernel's culled (warp, instance) pairs ("K1", "K2") and the share
    dropped ("K1_dropped", "K2_dropped"), K2's kept ones ("K2_kept"), and
    the (pixel, instance) pairs both kernels test: the kept instances
    before each pixel's n_walked ("tested")."""
    wp = _walk_pairs(feat, bins, n_walked, width, height)
    keep, in_k2, seg0, per_warp = (wp[k] for k in ("keep", "in_k2", "seg0",
                                                     "per_warp"))
    dev = feat.device
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


def mxu_cull_misses(feat, bins, n_walked, width: int, height: int,
                    chunk: int = 1 << 20) -> dict:
    """The warp cull against the POWER_MXU mode. The cull proves alpha <
    1/255 at every pixel of a warp from the exact exponent with a margin
    of 0.999 (about 1e-3 in the exponent); the mode's exponent, the
    product, differs from the exact one by about 1e-5 inside the tile and
    more for a splat whose mean lies outside it (pallas_blend.py:94-104).
    Over the (warp, instance) pairs K1's warps cull on this frame (its
    walk given by the mode's n_walked), counts those the cull drops where
    the plain mode's alpha reaches 1/255 at one of the warp's pixels in
    the image: {"dropped": pairs dropped, "missed": of them those,
    "max_alpha": the largest such alpha among the dropped, 0 if none}."""
    from hugs_tpu_torch.render.blend import (
        alpha_mxu, grid_basis, mxu_coefficients,
    )
    from hugs_tpu_torch.render.oracle import MIN_ALPHA
    from hugs_tpu_torch.render.tiles import TILE
    wp = _walk_pairs(feat, bins, n_walked, width, height)
    drop = ~wp["keep"]
    gid, t, w = wp["gid"][drop], wp["t"][drop], wp["w"][drop]
    nx = wp["nx"]
    bh, bl = (b.float() for b in grid_basis(TILE, feat.device))
    lin = torch.arange(32, device=feat.device)
    missed, top = 0, 0.0
    for warp in range(TILE // 2):           # each warp's 32 pixel columns
        cols = 32 * warp + lin
        sel = torch.nonzero(w == warp)[:, 0]
        for i0 in range(0, sel.numel(), chunk):
            s = sel[i0:i0 + chunk]
            f = feat[gid[s].long()]
            tx0 = ((t[s] % nx) * TILE).float()
            ty0 = ((t[s] // nx) * TILE).float()
            _, (c1, c2, c3) = mxu_coefficients(f, tx0, ty0)
            c1, c2, c3 = c1.float(), c2.float(), c3.float()
            b, l = bh[:, cols], bl[:, cols]
            power = c1 @ b + c2 @ b + c3 @ b + c1 @ l + c2 @ l
            px = tx0[:, None] + (lin % TILE).float()
            py = ty0[:, None] + (2 * warp + lin // TILE).float()
            a = alpha_mxu(f, f[:, 3], px, py, power).detach()
            a = torch.where((px < width) & (py < height), a, 0.0)
            hit = a.amax(1)
            missed += int((hit >= MIN_ALPHA).sum())
            top = max(top, float(hit.max()) if hit.numel() else 0.0)
    return {"dropped": int(drop.sum()), "missed": missed, "max_alpha": top}


def _mode_groups(wp, sel, grid_row, batch: int, back: bool, group: int,
                 walk=None) -> dict:
    """The POWER_MXU mode's groups over the (warp, instance) pairs `sel`
    of _walk_pairs: per warp and batch of `batch` slots, the selected
    instances in list order (back to front with `back`) cut into runs of
    `group`; with `walk` (per warp), only the groups whose first instance
    lies within the warp's walk run. Returns the groups run, the mma they
    issue (12 each: 2 pixel rows x 3 passes x 2 k steps), the share of
    their columns filled and the share of groups whose instances all lie
    in one row of grid points, which one k step would cover."""
    idx = torch.nonzero(sel)[:, 0]
    off, wof = wp["offset"][idx], wp["warp_of"][idx]
    n = idx.numel()
    if n == 0:
        return {"groups": 0, "mma": 0, "fill": 0.0, "one_step": 0.0}
    dev = off.device
    key = wof * (1 << 24) + off // batch
    _, kid, size = torch.unique_consecutive(key, return_inverse=True,
                                            return_counts=True)
    pos = torch.arange(n, device=dev)
    rank = pos - (torch.cumsum(size, 0) - size)[kid]
    if back:
        rank = size[kid] - 1 - rank
    _, gid = torch.unique(kid * (1 << 16) + rank // group,
                          return_inverse=True)
    ng = int(gid.max()) + 1
    row = grid_row[idx]
    lo = torch.full((ng,), 9, dtype=row.dtype, device=dev).scatter_reduce(
        0, gid, row, "amin")
    hi = torch.full((ng,), -1, dtype=row.dtype, device=dev).scatter_reduce(
        0, gid, row, "amax")
    members = torch.zeros(ng, dtype=torch.int64, device=dev).index_add_(
        0, gid, torch.ones_like(gid))
    run = torch.ones(ng, dtype=torch.bool, device=dev)
    if walk is not None:
        first = torch.full((ng,), 1 << 30, dtype=off.dtype,
                           device=dev).scatter_reduce(0, gid, off, "amin")
        gw = torch.zeros(ng, dtype=wof.dtype, device=dev).scatter_(0, gid,
                                                                   wof)
        run = first < walk[gw]
    one = (lo == hi) & run
    groups = int(run.sum())
    return {"groups": groups, "mma": 12 * groups,
            "fill": float(members[run].sum()) / (group * groups)
            if groups else 0.0,
            "one_step": float(one.sum()) / groups if groups else 0.0}


def mxu_groups(feat, bins, n_walked, width: int, height: int,
               group: int = 8) -> dict:
    """The tensor-core products of the POWER_MXU mode's K1 and K2 on one
    frame (blend_common.cuh::mxu_product), from the warp cull's own keep:
    each product covers the next `group` instances that a warp's cull
    keeps. K1 culls every batch of 256 its warp enters and walks the
    kept instances front to back until the warp's pixels have saturated;
    K2 walks the kept ones within the warp's walk back to front, in
    batches of 128. For each ("K1", "K2"): the groups, the mma they issue
    and the share of their columns filled ("K1_mma", "K1_fill", ...;
    "K1_one_step" the share of groups that one k step would cover), and the
    instances each stages, with a coefficient record each: K1 its tile's
    walked batches of 256 (from the mode's n_walked), K2 up to its tile's
    longest pixel walk ("K1_staged", "K2_staged")."""
    from hugs_tpu_torch.render.tiles import TILE, tile_grid
    wp = _walk_pairs(feat, bins, n_walked, width, height, chunk=256)
    nx, ny = tile_grid(width, height, TILE)
    ty0 = ((wp["t"] // nx) * TILE).to(feat.dtype)
    grid_row = torch.clamp(torch.floor((feat[wp["gid"].long(), 5] - ty0)
                                       * (1.0 / 8)), 0, 1).long()
    walk = wp["per_warp"].amax(1)
    out = {}
    for k, sel, batch, back, w in (
            ("K1", wp["keep"], 256, False, walk),
            ("K2", wp["keep"] & wp["in_k2"], 128, True, None)):
        g = _mode_groups(wp, sel, grid_row, batch, back, group, w)
        out[k] = g["groups"]
        out[k + "_mma"] = g["mma"]
        out[k + "_fill"] = g["fill"]
        out[k + "_one_step"] = g["one_step"]
    tile_walk = walk.reshape(nx * ny, -1).amax(1)
    count = (bins.ends - bins.starts).long()
    out["K1_staged"] = int(torch.minimum((tile_walk + 255) // 256 * 256,
                                         count).sum())
    out["K2_staged"] = int(tile_walk.sum())
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


_SASS_LINE = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA_TARGET = re.compile(r"(0x[0-9a-f]+)|`\((\.L_x_\d+)\)")

# Lanes per SM per clock of the Hopper (sm_90) pipes a loop of S1 or S2
# issues to (NVIDIA H100 architecture white paper: 128 FP32 lanes, 64
# INT32 lanes and 16 special-function units per SM, 4 schedulers issuing
# one warp instruction each per clock): `fp32` the FFMA / FADD / FMUL and
# packed-16-bit HFMA2 / HADD2 / HMUL2 instructions; `mufu` the special
# functions and conversions; `alu` compares, selects, min / max, integer
# and logic instructions; `issue` every instruction but the control
# flow's and the uniform datapath's.
PIPE_LANES = {"fp32": 128, "mufu": 16, "alu": 64, "issue": 128}
_FP32 = ("FFMA", "FADD", "FMUL", "HFMA2", "HADD2", "HMUL2")
_MUFU = ("MUFU", "F2F", "I2F", "F2I", "FRND")
_NOT_ISSUED_WORK = ("BRA", "EXIT", "NOP", "BSSY", "BSYNC", "WARPSYNC",
                    "RET", "CALL", "BAR")


def sass_text(lib: Path) -> str:
    """cuobjdump -sass of library `lib`, from the cuobjdump beside nvcc."""
    from hugs_tpu_torch import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool})")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_listing(lib: Path, function: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of each instruction, in order, of the
    function whose name contains `function` in the SASS of `lib`; a
    branch's label operand is replaced by the label's address."""
    out, labels, inside, found = [], {}, False, False
    pending = []
    for line in sass_text(lib).splitlines():
        if "Function :" in line:
            inside = function in line
            found = found or inside
            continue
        if not inside:
            continue
        lab = _SASS_LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _SASS_LINE.match(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            out.append((addr, m.group(2), m.group(3).strip()))
    if not found:
        raise RuntimeError(f"no function {function} in the SASS of {lib}")
    for i, (addr, op, args) in enumerate(out):
        t = _BRA_TARGET.search(args) if op.startswith("BRA") else None
        if t and t.group(2) in labels:
            out[i] = (addr, op, hex(labels[t.group(2)]))
    return out


def sass_opcodes(lib: Path, function: str) -> list[str]:
    """The opcodes, in order, of the function whose name contains
    `function` in the SASS of library `lib`, from cuobjdump beside nvcc."""
    return [op for _, op, _ in sass_listing(lib, function)]


def loop_opcodes(listing: list[tuple[int, str, str]]) -> list[str]:
    """The opcodes of the widest loop of a sass_listing: from a backward
    branch's target through the branch."""
    best = None
    for addr, op, args in listing:
        t = _BRA_TARGET.search(args) if op.startswith("BRA") else None
        if t and t.group(1) and int(t.group(1), 16) < addr:
            span = (int(t.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        raise RuntimeError("no backward branch: the function has no loop")
    return [op for addr, op, _ in listing if best[0] <= addr <= best[1]]


def pipe_counts(opcodes: list[str]) -> dict:
    """Instructions per PIPE_LANES pipe (`issue` counts every one but the
    control flow and the uniform datapath's)."""
    n = dict.fromkeys(PIPE_LANES, 0)
    for op in opcodes:
        base = op.split(".")[0]
        if base in _NOT_ISSUED_WORK or base.startswith("U"):
            continue
        n["issue"] += 1
        if base in _FP32:
            n["fp32"] += 1
        elif base in _MUFU:
            n["mufu"] += 1
        elif not base.startswith(("LD", "ST", "S2R", "CS2R", "RED", "ATOM")):
            n["alu"] += 1
    return n


def pipe_bound_ms(per_thread: dict, threads: int, clock_mhz: float,
                  sms: int) -> tuple[float, str]:
    """The least ms `threads` threads take that each issue `per_thread`
    instructions per pipe (pipe_counts' keys), every SM's pipes full at
    clock_mhz: (the largest pipe's ms, that pipe)."""
    ms = {p: per_thread[p] * threads / (PIPE_LANES[p] * sms * clock_mhz
                                        * 1e6) * 1e3
          for p in PIPE_LANES}
    pipe = max(ms, key=ms.get)
    return ms[pipe], pipe


def sm_clock_mhz(fn, seconds: float = 1.0, index: int = 0) -> float:
    """The SM clock (MHz) nvidia-smi reads while fn() runs back to back
    for about `seconds`: the median of its samples."""
    import threading
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60)
            if out.returncode == 0 and out.stdout.strip():
                samples.append(float(out.stdout.split()[0]))

    fn()
    torch.cuda.synchronize()
    t = threading.Thread(target=poll, daemon=True)
    end = time.monotonic() + seconds
    t.start()
    while time.monotonic() < end or (not samples and time.monotonic()
                                     < end + 30.0):
        fn()
        torch.cuda.synchronize()
    stop.set()
    t.join()
    if not samples:
        raise RuntimeError("nvidia-smi read no SM clock")
    return statistics.median(samples)


def emit(result: dict, out: str | None) -> None:
    """Print `result` as one JSON line; also write it to `out` if given."""
    text = json.dumps(result)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
