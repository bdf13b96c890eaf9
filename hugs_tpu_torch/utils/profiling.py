"""Tracing and debugging hooks (the reference has none; its
cfg.detect_anomaly is declared and never read, hugs/cfg/config.py:16).

- `StepTimer`: wall-clock time per step, as an exponential moving
  average; time a step on the card with `block` inside the span.
- `trace`: a torch.profiler trace of the host and the card, written to a
  directory as a Chrome / Perfetto trace.
- `enable_debug_nans`: autograd's anomaly detection, which names the
  forward operation behind a NaN in the backward.
- `block`: waits for the card's queued work on the tensors given.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        self.avg_s = dt if self.avg_s is None else \
            self.ema * self.avg_s + (1 - self.ema) * dt

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.avg_s if self.avg_s else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace(dir): step(...)` writes dir/trace.json: the host's
    operations and, where a card is present, its kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


def block(tree):
    """Waits until the card has finished every queued kernel when the
    nested dicts, lists or tuples hold a CUDA tensor; returns `tree`."""
    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
    devices = {t.device for t in leaves(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
