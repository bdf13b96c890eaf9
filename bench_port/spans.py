"""The program's own spans and step counters (hugs_tpu_torch/utils/
profiling.py) as the per-layer metrics that read them see them.

The program's recorder records while a torch.profiler session runs, so
the traced window (trace.traced) leaves its spans there, and the staged
steps after it theirs. The first reader drains them into the run's
record under 'spans' and 'step_counters'. The window's steps are those
with a `train.step` span (the staged steps call the stage functions and
_periodic, never _train_step), and only their spans and counters count.
A program without the recorder leaves none, and every reader gives None.
"""
from __future__ import annotations

from typing import NamedTuple

ROOTS = ("train.step", "train.periodic")


class Window(NamedTuple):
    spans: list       # the window's steps' spans (profiling.Span)
    counters: dict    # step -> {counter: count}
    steps: int


def window(rec: dict) -> Window | None:
    """The traced window's steps' spans and counters, or None."""
    if "spans" not in rec:
        rec["spans"], rec["step_counters"] = _drain()
    steps = {s.step for s in rec["spans"] if s.name == "train.step"}
    if not steps:
        return None
    return Window([s for s in rec["spans"] if s.step in steps],
                  {k: v for k, v in rec["step_counters"].items()
                   if k in steps}, len(steps))


def _drain() -> tuple[list, dict]:
    from hugs_tpu_torch.utils import profiling
    drain = getattr(profiling, "drain", None)
    if drain is None:          # a program without the recorder
        return [], {}
    out = drain()
    return list(out.spans), dict(out.steps)


def device_ms(rec: dict, name: str):
    """Device ms a step of the spans named `name`, summed in each step;
    None without such spans or without their device intervals."""
    w = window(rec)
    if w is None:
        return None
    ms = [s.device_ms for s in w.spans if s.name == name]
    if not ms or None in ms:
        return None
    return sum(ms) / w.steps


def host_ms(rec: dict, names: tuple[str, ...]) -> float | None:
    """Host ms a step inside the spans named in `names`."""
    w = window(rec)
    if w is None:
        return None
    return sum(s.host_ms for s in w.spans if s.name in names) / w.steps
