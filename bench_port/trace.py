"""Reading a torch.profiler trace of the device: busy time, kernels by
name and the longest idle gaps.

The benchmark's own copy of the method of hugs_tpu_torch/micro's
device_kernels (CUDA activity only, so that tracing does not slow the
host), with idle taken over the whole traced window, host gaps at its
edges included."""
from __future__ import annotations

import time
from typing import NamedTuple

import torch


class DeviceTrace(NamedTuple):
    window_s: float     # host wall time of the traced window
    busy_s: float       # union of the device operations' intervals
    n_ops: int          # device operations (kernels, copies, sets)
    by_name: dict       # name -> (seconds, count)
    gaps: list          # [(seconds, "before <op>")], longest first


def traced(fn):
    """Runs fn() between two synchronisations under the profiler.
    Returns (fn's result, DeviceTrace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t, e.name))
        sec, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (sec + (t - s) * 1e-6, n + 1)
    spans.sort()
    busy, gaps, end = 0.0, [], None
    for s, t, name in spans:
        if end is not None and s > end:
            gaps.append(((s - end) * 1e-6, f"before {name}"))
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(reverse=True)
    return out, DeviceTrace(window, busy * 1e-6, len(spans), by_name,
                            gaps[:10])


def kernel_seconds(trace: DeviceTrace, names: tuple[str, ...]) -> float:
    """Device seconds of the operations whose name holds one of names."""
    return sum(sec for n, (sec, _) in trace.by_name.items()
               if any(k in n for k in names))
