"""S1: chained elementwise passes in float32 and bfloat16.

The counterpart of scripts/micro_bf16.py. One call runs r chained passes
over a (1024, 128) block of
  madd  v = v * c + 1e-3
  exp   v = exp(-|v|) + 1e-3
in the block's type (a float32 madd fused, as XLA's CPU backend
computes it), with c = 0.9999 a float32 scalar on the device cast
to that type; K = 20 calls are chained per timed block. One pass of one
element counts as one operation (gop_s). `r_scaling`, the time at the
largest r over the time at the smallest, should be near their ratio (4):
far from it, the loop was not run as written.

In bfloat16, 0.9999 rounds to 1.0 and 1e-3 is under half an ulp of 0.5,
so from the script's start (0.5) `madd` never moves the block; a check
of it needs a start that moves (tests and chip_smoke.py use a linspace).

The kernel is csrc/micro_bf16.cu (CUDA tensors); `plain_passes` is the
same function in plain PyTorch (CPU tensors, and the reference on the
card).

Run: `python -m hugs_tpu_torch.micro.micro_bf16 [--device cpu] [--out F]`;
on the CPU, at SMOKE_RS and SMOKE_K.
"""
from __future__ import annotations

import ctypes

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.micro import (
    card, chain_latency, device_ms, emit, parse_args, sm_clock_mhz,
)

P, C = 1024, 128
K = 20              # chained calls per timed block
RS = (8192, 32768)  # passes per call
SMOKE_RS, SMOKE_K = (8, 32), 2   # a --device cpu run's size
OPS = ("madd", "exp")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
C_VALUE, E, START = 0.9999, 1e-3, 0.5
SOURCE = "micro_bf16"
LAUNCHES = 0    # kernel launches since the count was last set to 0
_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def plain_passes(c: torch.Tensor, x: torch.Tensor, op: str,
                 r: int) -> torch.Tensor:
    """r passes in plain PyTorch, in x's type: c (1, 1) float32 cast to
    it, e = 1e-3 in it, each operation rounded to it, except that a
    float32 madd is fused (rounded once, from float64), as XLA's CPU
    backend computes jnp's `v * cv + ev` and as the kernel does."""
    cv = c.reshape(()).to(x.dtype)
    ev = torch.tensor(E, dtype=torch.float32, device=x.device).to(x.dtype)
    v = x
    for _ in range(r):
        if op == "madd" and x.dtype == torch.float32:
            v = fma(v, cv, ev)
        elif op == "madd":
            v = v * cv + ev
        elif op == "exp":
            v = torch.exp(-torch.abs(v)) + ev
        else:
            raise ValueError(f"unknown op {op!r}")
    return v


def fma(a: torch.Tensor, k, b) -> torch.Tensor:
    """a * k + b for float32 a, rounded once: the product of two float32
    values is exact in float64, so only the sum rounds before the cast
    (twice, which differs from one rounding only in rare ties)."""
    return (a.double() * k + b).to(torch.float32)


def passes(c: torch.Tensor, x: torch.Tensor, op: str, r: int) -> torch.Tensor:
    """One call: the kernel for CUDA tensors, plain_passes for CPU ones.
    x: float32 or bfloat16, contiguous (an even count in bfloat16); c:
    (1, 1) float32 on x's device."""
    global LAUNCHES
    if x.device.type == "cpu":
        return plain_passes(c, x, op, r)
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if x.dtype not in DTYPES.values() or not x.is_contiguous():
        raise ValueError("x must be contiguous float32 or bfloat16")
    if c.device != x.device or c.dtype != torch.float32 or c.numel() != 1:
        raise ValueError("c must be one float32 on x's device")
    out = torch.empty_like(x)
    lib = build.load(SOURCE)
    if lib.hugs_micro_bf16.argtypes is None:
        lib.hugs_micro_bf16.argtypes = _ARGS
        lib.hugs_micro_bf16.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = lib.hugs_micro_bf16(
            OPS.index(op), int(x.dtype == torch.bfloat16), x.data_ptr(),
            out.data_ptr(), c.data_ptr(), E, x.numel(), r,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"S1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def kernel_name(op: str, dtype: str) -> str:
    """The kernel of (op, dtype name) in the library's SASS (a part of its
    mangled name)."""
    kind = "bf16" if dtype == "bfloat16" else "f32"
    return f"passes_{kind}ILi{OPS.index(op)}E"


def block(c: torch.Tensor, x: torch.Tensor, op: str, r: int,
          k: int = K) -> torch.Tensor:
    """k chained calls, as the script's jitted fori_loop (:62-64)."""
    for _ in range(k):
        x = passes(c, x, op, r)
    return x


def measure(device="cuda", rs=RS, k: int = K, timed: int = 5) -> dict:
    """The script's fields: for each op and type, from its start block,
    the mean of one block's result and, on the card, ms per call (median
    of `timed` timed blocks of k calls), Gop/s per r, r_scaling, and the
    bf16 / f32 ratio per op."""
    c = torch.tensor([[C_VALUE]], dtype=torch.float32, device=device)
    on_card = c.is_cuda
    out = {"P": P, "C": C, "K": k, "rs": list(rs),
           "device": card() if on_card else "cpu"}
    for op in OPS:
        for name, dtype in DTYPES.items():
            x = torch.full((P, C), START, dtype=dtype, device=device)
            res = {"mean": float(block(c, x, op, rs[-1], k).double().mean())}
            if on_card:
                per_r = {}
                for r in rs:
                    ms = device_ms(lambda r=r: block(c, x, op, r, k),
                                   reps=timed, warmup=1) / k
                    per_r[r] = {"ms_per_call": ms,
                                "gop_s": P * C * r / (ms * 1e-3) / 1e9}
                res.update(per_r[rs[-1]], per_r=per_r,
                           r_scaling=per_r[rs[-1]]["ms_per_call"]
                           / per_r[rs[0]]["ms_per_call"])
            out[f"{op}_{name}"] = res
    if on_card:
        for op in OPS:
            out[f"{op}_bf16_speedup"] = (out[f"{op}_bfloat16"]["gop_s"]
                                         / out[f"{op}_float32"]["gop_s"])
    return out


def chain_depth(op: str, dtype: str, r: int = RS[-1]) -> int:
    """Dependent instructions of one chain in a call: for bfloat16 madd
    its HMUL2 and HADD2 a pass; for the other kernels a pass counts one
    (their chain latency is then read in clocks a pass)."""
    return r * (2 if (op, dtype) == ("madd", "bfloat16") else 1)


def measure_chain(device, r: int = RS[-1], timed: int = 20) -> dict:
    """Each op and type through `passes` (one element, or bf16x2 pair, a
    thread) on 256 threads' elements per SM, so that each scheduler holds
    at most two warps and a chain runs near alone: {"op_dtype":
    {"elements", "ms", "sm_clock_mhz", "depth", "latency_clocks"}}, ms a
    call (median of `timed` spans of 10 calls), the SM clock nvidia-smi
    reads while it runs, chain_depth and the clocks per dependent
    instruction (per pass but for bfloat16 madd)."""
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = torch.tensor([[C_VALUE]], dtype=torch.float32, device=dev)
    out = {}
    for op in OPS:
        for name, dtype in DTYPES.items():
            n = 256 * sms * (2 if name == "bfloat16" else 1)
            x = torch.linspace(-2.0, 3.0, n, device=dev).to(dtype)

            def probe(a=x, o=op):
                return passes(c, a, o, r)
            ms = device_ms(probe, reps=timed, inner=10, warmup=1)
            clock = sm_clock_mhz(probe, index=dev.index or 0)
            depth = chain_depth(op, name, r)
            out[f"{op}_{name}"] = {
                "elements": n, "ms": ms, "sm_clock_mhz": clock,
                "depth": depth,
                "latency_clocks": chain_latency(ms, depth, clock)}
    return out


def main(argv=None) -> None:
    args = parse_args(__doc__.splitlines()[0], argv)
    size = (SMOKE_RS, SMOKE_K) if args.device == "cpu" else (RS, K)
    emit(measure(args.device, *size), args.out)


if __name__ == "__main__":
    main()
