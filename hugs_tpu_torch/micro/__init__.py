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

Run one with `python -m hugs_tpu_torch.micro.<name>`: on the card at the
scripts' full sizes by default, or `--device cpu` for the plain versions
at a small size (tests only; no times).
Each prints one JSON object, and writes it to a file only if `--out`
names one.
"""
from __future__ import annotations

import argparse
import json
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
