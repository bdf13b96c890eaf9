"""S2: the card's elementwise rate on the forward blend's op mix.

The counterpart of scripts/vpu_peak.py. One call computes, per element of
a (1024, 128) float32 block, o = 0 and then for each of GRID steps
o = o + f(x + o * 1e-20), and returns o * 1e-6; REPS calls are chained,
each fed the last one's output. f is one of
  fma       four independent chains a = a * k + b, INNER steps each
            (8 operations per step: a fused multiply-add counts two);
  serial    one dependent chain of 4 INNER such steps (the same count);
  blendmix  INNER pairs of the forward blend's arithmetic (the conic
            quadratic, exp, the clamp and tests, log1p, exp(log T), two
            sums), counted 21 operations per pair, a transcendental as one.
The kernel is csrc/vpu_peak.cu (CUDA tensors); `plain_call` is the same
function in plain PyTorch (CPU tensors, and the reference on the card).
The rate divides those operation counts by the device time of a call.
`serial` runs SERIAL_DESIGN's elements a thread; `chain_call` launches
it at one a thread, the probe that reads its chain's latency.

Run: `python -m hugs_tpu_torch.micro.vpu_peak [--device cpu] [--out F]`;
on the CPU, at the script's smoke size (its VPU_SMOKE: GRID 8, INNER 4,
REPS 1).
"""
from __future__ import annotations

import ctypes

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.micro import (
    card, chain_latency, device_ms, emit, parse_args, sass_opcodes,
    sm_clock_mhz,
)
from hugs_tpu_torch.micro.micro_bf16 import fma

P, CHUNK = 1024, 128    # the block (vpu_peak.py:42-43)
GRID, INNER, REPS = 512, 64, 3
SMOKE_GRID, SMOKE_INNER, SMOKE_REPS = 8, 4, 1   # the script's smoke size
MODES = ("fma", "serial", "blendmix")
CARRY, OUT_SCALE = 1e-20, 1e-6
# H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet), which
# counts a fused multiply-add as two operations
PEAK_FP32 = 67e12
SOURCE = "vpu_peak"
# `serial`'s elements a thread and threads a block, as csrc/vpu_peak.cu
# builds it (kSerialChains, kSerialThreads)
SERIAL_DESIGN = {"chains": 4, "threads": 128}
LAUNCHES = 0    # kernel launches since the count was last set to 0

# the script's constants (vpu_peak.py:64-78), rounded to float32: the
# four chains' multipliers and offsets, a1's and a2's start multipliers,
# a3's start offset, the serial chain's multiplier and offset
CONSTS = torch.tensor([1.000001, 0.999999, 1.000002, 0.999998,
                       0.3, 0.2, 0.1, 0.4, 1.0001, 0.9999, 0.5,
                       1.000001, 0.1], dtype=torch.float32)
_C = CONSTS.tolist()
_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def ops_per_elem(mode: str, inner: int = INNER) -> int:
    """Operations per element and grid step, as vpu_peak.py:135-140."""
    return inner * (21 if mode == "blendmix" else 8)


def plain_call(x: torch.Tensor, mode: str, grid: int = GRID,
               inner: int = INNER) -> torch.Tensor:
    """One call in plain PyTorch, in the kernel's operation order; each
    a * k + b of fma and serial is fused (micro_bf16.fma), as the
    kernel's __fmaf_rn and XLA's CPU backend compute it."""
    o = torch.zeros_like(x)
    for _ in range(grid):
        v = x + o * CARRY
        if mode == "fma":
            a0, a1, a2, a3 = v, v * _C[8], v * _C[9], v + _C[10]
            for _ in range(inner):
                a0 = fma(a0, _C[0], _C[4])
                a1 = fma(a1, _C[1], _C[5])
                a2 = fma(a2, _C[2], _C[6])
                a3 = fma(a3, _C[3], _C[7])
            o = o + (a0 + a1 + a2 + a3)
        elif mode == "serial":
            a = v
            for _ in range(inner * 4):
                a = fma(a, _C[11], _C[12])
            o = o + a
        elif mode == "blendmix":
            acc, logt = v * 0.0, v * 0.0
            for k in range(inner):
                dx, dy = v + float(k), v - float(k)
                power = -0.5 * (1e-2 * dx * dx + 1e-2 * dy * dy) \
                    - 1e-3 * (dx * dy)
                alpha = torch.clamp(
                    0.7 * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
                keep = (power <= 0.0) & (alpha >= 1.0 / 255.0)
                alpha = torch.where(keep, alpha, 0.0)
                la = torch.log1p(-alpha)
                w = torch.exp(logt) * alpha
                acc = acc + w
                logt = logt + la
            o = o + (acc + logt)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return o * OUT_SCALE


_consts: dict[torch.device, torch.Tensor] = {}


def vpu_call(x: torch.Tensor, mode: str, grid: int = GRID,
             inner: int = INNER) -> torch.Tensor:
    """One call: the kernel for a CUDA tensor, plain_call for a CPU one.
    x: float32, contiguous; on the card inner is INNER, the kernel's."""
    if x.device.type == "cpu":
        return plain_call(x, mode, grid, inner)
    if mode not in MODES:
        raise ValueError(f"the kernel takes mode in {MODES}, not {mode!r}")
    return _launch("hugs_vpu_peak", (MODES.index(mode),), x, grid, inner)


def chain_call(x: torch.Tensor, grid: int = GRID,
               inner: int = INNER) -> torch.Tensor:
    """One `serial` call on the card at one element a thread: vpu_call's
    output; launched on few elements, it reads the chain's latency."""
    if x.device.type == "cpu":
        raise ValueError("chain_call runs on CUDA tensors only")
    return _launch("hugs_vpu_serial_chain", (), x, grid, inner)


def _launch(entry: str, head: tuple, x: torch.Tensor, grid: int,
            inner: int) -> torch.Tensor:
    """The library's function `entry` on x (its arguments `head`, then
    those of hugs_vpu_peak from inner on), counted in LAUNCHES."""
    global LAUNCHES
    if inner != INNER:
        raise ValueError(f"the kernel takes inner {INNER}, not {inner}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    dev = x.device
    if dev not in _consts:
        _consts[dev] = CONSTS.to(dev)
    out = torch.empty_like(x)
    fn = getattr(build.load(SOURCE), entry)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGS if head else _ARGS[1:], ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(
            *head, inner, x.data_ptr(), out.data_ptr(),
            _consts[dev].data_ptr(), x.numel(), grid, CARRY, OUT_SCALE,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"S2 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def run(x: torch.Tensor, mode: str, grid: int = GRID, inner: int = INNER,
        reps: int = REPS) -> torch.Tensor:
    """`reps` chained calls, as the script's fori_loop (:113-121)."""
    for _ in range(reps):
        x = vpu_call(x, mode, grid, inner)
    return x


def start_block(device) -> torch.Tensor:
    """The script's input: linspace(0, 1) over the (P, CHUNK) block."""
    return torch.linspace(0.0, 1.0, P * CHUNK, device=device).reshape(
        P, CHUNK)


def kernel_name(mode: str) -> str:
    """The kernel of `mode` in the library's SASS (a part of its mangled
    name)."""
    if mode == "serial":
        return (f"vpu_serial_kernelILi{INNER}ELi{SERIAL_DESIGN['chains']}"
                f"ELi{SERIAL_DESIGN['threads']}E")
    return f"vpu_peak_kernelILi{MODES.index(mode)}ELi{INNER}E"


def sass_ffma(mode: str = "fma") -> int:
    """FFMA instructions in the SASS of mode's kernel, from cuobjdump
    beside nvcc: the grid loop is not unrolled, so for fma this is the
    count per grid step, 4 INNER if nothing was folded."""
    ops = sass_opcodes(build.build([SOURCE])[SOURCE], kernel_name(mode))
    return sum(op.split(".")[0] == "FFMA" for op in ops)


def measure(device="cuda", grid: int = GRID, inner: int = INNER,
            reps: int = REPS, timed: int = 5) -> dict:
    """The script's fields for each mode: the sum of the last call's block
    (build()'s scalar) and, on the card, seconds per call (median of
    `timed` timed runs of `reps` chained calls), the rate and its share
    of PEAK_FP32, and the FFMA count of fma's SASS."""
    x = start_block(device)
    on_card = x.is_cuda
    out = {"P": P, "chunk": CHUNK, "grid": grid, "inner": inner,
           "reps": reps, "device": card() if on_card else "cpu"}
    for mode in MODES:
        v = run(x, mode, grid, inner, reps)
        res = {"sum": float(v.double().sum())}
        if on_card:
            ms = device_ms(lambda m=mode: run(x, m, grid, inner, reps),
                           reps=timed, warmup=1)
            per_rep = ms / 1e3 / reps
            rate = ops_per_elem(mode, inner) * P * CHUNK * grid / per_rep
            res.update(s_per_rep=per_rep, tera_ops_per_s=rate / 1e12,
                       share_of_peak_fp32=rate / PEAK_FP32)
        out[mode] = res
    if on_card:
        out["ffma_per_step"] = {"fma": sass_ffma("fma"),
                                "expected": 4 * inner}
    return out


def chain_depth(mode: str, grid: int = GRID, inner: int = INNER) -> int:
    """Dependent instructions of one element's chain in a call: for
    `serial` a step's FMUL and FADD of v, its 4 inner FFMA and the FADD
    into o; for the other modes a grid step counts one (their chain
    latency is then read in clocks a step)."""
    return grid * (4 * inner + 3 if mode == "serial" else 1)


def measure_chain(device, timed: int = 20) -> dict:
    """Each mode on 256 elements per SM, so that each scheduler holds at
    most two warps (`serial` through chain_call, one element a thread;
    the others through vpu_call): {mode: {"elements", "ms",
    "sm_clock_mhz", "depth", "latency_clocks"}}, ms a call (median of
    `timed` spans of 10 calls), the SM clock nvidia-smi reads while it
    runs, chain_depth and the clocks per dependent instruction (per grid
    step but for `serial`)."""
    dev = torch.device(device)
    n = 256 * torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.linspace(0.0, 1.0, n, device=dev)
    out = {}
    for mode in MODES:
        def probe(m=mode):
            return chain_call(x) if m == "serial" else vpu_call(x, m)
        ms = device_ms(probe, reps=timed, inner=10, warmup=1)
        clock = sm_clock_mhz(probe, index=dev.index or 0)
        depth = chain_depth(mode)
        out[mode] = {"elements": n, "ms": ms, "sm_clock_mhz": clock,
                     "depth": depth,
                     "latency_clocks": chain_latency(ms, depth, clock)}
    return out


def main(argv=None) -> None:
    args = parse_args(__doc__.splitlines()[0], argv)
    size = (SMOKE_GRID, SMOKE_INNER, SMOKE_REPS) if args.device == "cpu" \
        else (GRID, INNER, REPS)
    emit(measure(args.device, *size), args.out)


if __name__ == "__main__":
    main()
