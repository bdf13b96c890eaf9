"""Tracing and debugging hooks (the reference has none; its
cfg.detect_anomaly is declared and never read, hugs/cfg/config.py:16).

- `span`, `count` and `drain`: the program's spans and counters, kept in
  memory while the recorder is on and handed over by `drain`.
- `trace`: a torch.profiler trace of the card's operations with the
  program's spans on one timeline, written to a directory as a Chrome /
  Perfetto trace, with the card's idle time put down to the spans
  (`idle_by_span`).
- `enable_debug_nans`: autograd's anomaly detection, which names the
  forward operation behind a NaN in the backward.
- `block`: waits for the card's queued work on the tensors given.

The recorder. `with span("name"):` records the span's name, its parent
(the span open around it), its step (the training iteration given to
the root span, `train.step` or `train.periodic`, which every span inside
it shares), its host start and end and, with `device=True` once the
process has used CUDA, its device time between two CUDA events recorded
on the current stream at its edges (None otherwise). `count(name, n)`
adds n to the open step's counters, n an int or a 0-d tensor, which is
kept as it is and read at the drain; a root span given `counters` (a
function returning named counts) adds each count's change over the span
to its step's counters. One thread records: the trainer's.

The recorder is on while `enable(True)` says so and, by default
(`enable(None)`), while a torch.profiler session runs, so that every
profiled window carries the program's spans; `enable(False)` keeps it
off under a profiler too. Off, `span` returns one shared no-op context
and `count` returns at once: no clock is read, no event recorded and no
record allocated. Nothing synchronises inside a step to read a span:
`drain()` synchronises once, returns the records and clears them.

The clock. Host times are `time.time_ns()`, the Unix clock in
nanoseconds, which is the clock torch.profiler stamps the card's
activity with: a device operation of `prof.events()` starts at
`prof.profiler.kineto_results.trace_start_ns() + 1000 *
time_range.start` (`device_intervals`), comparable with a span's
`start_ns` and `end_ns` (tests/test_torch_profiling.py's card test holds
it).

Spans in a CUDA graph. While `capturing(template, part)` is open, a
span records no event: a device span launches a stamp at each edge
(csrc/stamp.cu, the card's nanosecond clock written into a ring row on
the device), and its name, its parent and the numbers of its two marks
go into `template`, whatever the recorder's state, so that every replay
can record them later. The captured graph begins with `next_row`, which
moves the device's ring row on by one. The host keeps the same count:
`begin_replay()` before each replay of the graph that begins a row gives
the replay's sequence number, and `replay(template, part, seq)` around a
replay records `part`'s spans while the recorder is on, with the
replay's host interval for each span and their device times from the
ring at the drain (None where later replays have overwritten the row).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from typing import NamedTuple

import torch

# torch.autograd.profiler._is_profiler_enabled is True while a
# torch.profiler session runs
_PROFILER = torch.autograd.profiler
OUTSIDE = "outside_spans"


class Span(NamedTuple):
    name: str
    parent: int | None       # index of the enclosing span in the drained list
    step: int | None         # the root span's training iteration
    start_ns: int            # host, time.time_ns()
    end_ns: int
    device_ms: float | None  # between the CUDA events at its edges

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Records(NamedTuple):
    spans: list[Span]                  # in the order they opened
    steps: dict[int, dict[str, int]]   # step -> counter -> count


class _Recorder:
    def __init__(self):
        self.on = None    # None: while a torch.profiler session runs
        # [name, parent, step, start_ns, end_ns, start, end]: start and end
        # two CUDA events, two _Marks in the ring, or None
        self.spans = []
        self.open = []    # indices of the open spans, innermost last
        self.counts = []  # (step, name, int or 0-d tensor)
        self.capture = None   # (Template, part) while a graph is captured


_REC = _Recorder()
_OFF = contextlib.nullcontext()

# the ring of device stamps written by captured graphs: a row a replay
RING_ROWS = 1024      # replays a drain can reach back over
RING_MARKS = 32       # stamps a captured step can hold


class _Mark(NamedTuple):
    seq: int          # the replay's sequence number (its row, mod RING_ROWS)
    mark: int         # the stamp's column


class _Ring:
    def __init__(self, device):
        self.stamps = torch.zeros((RING_ROWS, RING_MARKS), dtype=torch.int64,
                                  device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self.begun = 0    # the host's count of the device's row


_RING: _Ring | None = None


def recording() -> bool:
    """Whether `span` and `count` record now."""
    on = _REC.on
    return bool(on or (on is None and _PROFILER._is_profiler_enabled))


def enable(on: bool | None) -> None:
    """True: record; False: do not, under a profiler either; None (the
    default): record while a torch.profiler session runs."""
    _REC.on = on


@contextlib.contextmanager
def paused():
    """Nothing recorded inside (work that is no part of a step)."""
    on = _REC.on
    _REC.on = False
    try:
        yield
    finally:
        _REC.on = on


class _Span:
    __slots__ = ("name", "step", "device", "counters", "i", "before")

    def __init__(self, name, step, device, counters):
        self.name, self.step, self.device = name, step, device
        self.counters = counters

    def __enter__(self):
        rec = _REC
        t = time.time_ns()
        parent = rec.open[-1] if rec.open else None
        step = self.step
        if step is None and parent is not None:
            step = rec.spans[parent][2]
        ev = None
        if self.device and torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        if self.counters is not None:
            self.before = self.counters()
        self.i = len(rec.spans)
        rec.spans.append([self.name, parent, step, t, None, ev, None])
        rec.open.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = _REC
        r = rec.spans[self.i]
        if r[5] is not None:
            r[6] = torch.cuda.Event(enable_timing=True)
            r[6].record()
        r[4] = time.time_ns()
        rec.open.pop()
        if self.counters is not None and r[2] is not None:
            rec.counts += [(r[2], k, v - self.before[k])
                           for k, v in self.counters().items()]
        return False


def span(name: str, *, step: int | None = None, device: bool = False,
         counters=None):
    """`with span(name):` records a span while the recorder is on (see
    the module's docstring); `step` on a root span, `device` for a
    device interval, `counters` (a function returning {name: count}) on
    a root span for its step's deltas. Inside `capturing` it goes into
    the template instead."""
    if _REC.capture is not None:
        return _CapturedSpan(name, device)
    if not recording():
        return _OFF
    return _Span(name, step, device, counters)


class Template:
    """The spans of a captured step, in the order they opened: [name,
    parent (its index here, None for the span open at the replay), the
    graph `part` it is in, start mark, end mark (None for a host span)];
    `marks` counts the stamps, numbered across the step's graphs."""

    def __init__(self):
        self.spans = []
        self.open = []
        self.marks = 0


class _CapturedSpan:
    __slots__ = ("name", "device", "i")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        t, part = _REC.capture
        self.i = len(t.spans)
        t.spans.append([self.name, t.open[-1] if t.open else None, part,
                        _stamp(t) if self.device else None, None])
        t.open.append(self.i)
        return self

    def __exit__(self, *exc):
        t, _ = _REC.capture
        if self.device:
            t.spans[self.i][4] = _stamp(t)
        t.open.pop()
        return False


def _stamp(t: Template) -> int:
    """The template's next mark; on the card, a stamp of it on the
    current stream."""
    mark = t.marks
    if mark >= RING_MARKS:
        raise RuntimeError(f"a captured step holds at most {RING_MARKS} "
                           f"stamps")
    t.marks += 1
    if _RING is not None:
        _launch_stamp(_RING.stamps, _RING.row, mark)
    return mark


def _launch_stamp(stamps, row, mark: int) -> None:
    import ctypes

    from hugs_tpu_torch import build
    lib = build.load("stamp")
    if lib.hugs_stamp.argtypes is None:
        lib.hugs_stamp.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.hugs_stamp.restype = ctypes.c_int
    err = lib.hugs_stamp(stamps.data_ptr(), row.data_ptr(), mark,
                         stamps.shape[1], stamps.shape[0],
                         torch.cuda.current_stream(stamps.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stamp launch failed: cudaError {err}")


def prepare_capture(device) -> None:
    """Before a capture on the card: the ring made, outside any graph's
    memory pool, and the stamp kernel built and loaded by one launch into
    a scratch row."""
    global _RING
    device = torch.device(device)
    if device.type != "cuda":
        return
    if _RING is None:
        _RING = _Ring(device)
    scratch = torch.zeros((1, RING_MARKS), dtype=torch.int64, device=device)
    _launch_stamp(scratch, _RING.row, 0)


@contextlib.contextmanager
def capturing(template: Template, part: str):
    """Spans opened inside go into `template` as `part`'s (see the
    module's docstring)."""
    if _REC.capture is not None:
        raise RuntimeError("capturing() inside capturing()")
    _REC.capture = (template, part)
    try:
        yield template
    finally:
        _REC.capture = None


def next_row() -> None:
    """Inside the capture of a step's first graph: the device's ring row
    moved on by one at each replay."""
    if _RING is not None:
        _RING.row.add_(1)


def begin_replay() -> int:
    """Before each replay of a graph that begins with next_row: the
    replay's sequence number (the host's count of the device's row)."""
    if _RING is None:
        return 0
    _RING.begun += 1
    return _RING.begun


class _Replay:
    __slots__ = ("template", "part", "seq", "t0")

    def __init__(self, template, part, seq):
        self.template, self.part, self.seq = template, part, seq

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = _REC
        t1 = time.time_ns()
        top = rec.open[-1] if rec.open else None
        step = rec.spans[top][2] if top is not None else None
        where = {}
        for i, (name, parent, part, m0, m1) in enumerate(self.template.spans):
            if part != self.part:
                continue
            where[i] = len(rec.spans)
            dev = (None, None) if m0 is None else (
                _Mark(self.seq, m0), _Mark(self.seq, m1))
            rec.spans.append([name, top if parent is None else where[parent],
                              step, self.t0, t1, *dev])
        return False


def replay(template: Template, part: str, seq: int):
    """`with replay(template, part, seq): graph.replay()` records the
    spans `template` holds for `part` while the recorder is on: each
    with the replay's host interval, under the span open around it, and
    its device time from ring row `seq` at the drain."""
    if not recording():
        return _OFF
    return _Replay(template, part, seq)


def count(name: str, n=1) -> None:
    """Adds n (an int, or a 0-d tensor read at the drain: no read-back in
    the step) to the open step's counter `name` while the recorder is on;
    outside a step nothing is counted."""
    rec = _REC
    if not recording() or not rec.open:
        return
    step = rec.spans[rec.open[-1]][2]
    if step is not None:
        rec.counts.append((step, name, n))


def drain() -> Records:
    """The records since the last drain, after one synchronisation where
    the process has used CUDA; clears them. Not inside a span."""
    rec = _REC
    if rec.open:
        raise RuntimeError("drain() inside an open span")
    if (rec.spans or rec.counts) and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    stamps = None
    if _RING is not None and any(isinstance(r[5], _Mark) for r in rec.spans):
        stamps = _RING.stamps.cpu()

    def device_ms(e0, e1):
        if e0 is None:
            return None
        if not isinstance(e0, _Mark):
            return e0.elapsed_time(e1)
        if _RING.begun - e0.seq >= RING_ROWS:    # the row was written over
            return None
        row = stamps[e0.seq % RING_ROWS]
        return int(row[e1.mark] - row[e0.mark]) * 1e-6

    spans = [Span(n, p, s, t0, t1, device_ms(e0, e1))
             for n, p, s, t0, t1, e0, e1 in rec.spans]
    steps: dict[int, dict[str, int]] = {}
    for step, name, n in rec.counts:
        c = steps.setdefault(step, {})
        c[name] = c.get(name, 0) + int(n)
    rec.spans, rec.counts = [], []
    return Records(spans, steps)


def device_intervals(prof) -> list[tuple[int, int, str]]:
    """The device operations of a finished torch.profiler session as
    (start_ns, end_ns, name) on the spans' clock, by start."""
    from torch.autograd import DeviceType
    t0 = prof.profiler.kineto_results.trace_start_ns()
    return sorted((t0 + round(e.time_range.start * 1000),
                   t0 + round(e.time_range.end * 1000), e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def idle_by_span(intervals, spans: list[Span], t0: int | None = None,
                 t1: int | None = None) -> dict[str, float]:
    """The device's idle seconds by the innermost span open on the host
    at each gap's start (OUTSIDE where none is): the gaps between the
    union of `intervals` ((start_ns, end_ns, ...) by start) and, where t0
    and t1 are given, those from t0 to the first operation and from the
    last to t1."""
    gaps, end = [], t0
    for s, e, *_ in intervals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    if t1 is not None and end is not None and t1 > end:
        gaps.append((end, t1))
    order = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in order]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        name = OUTSIDE
        i = bisect.bisect_right(starts, g0) - 1
        while i >= 0:
            s = order[i]
            if s.end_ns > g0:
                name = s.name
                break
            if s.parent is None:      # every earlier span ended before it
                break
            i -= 1
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace(dir): step(...)` writes dir/trace.json: the card's
    operations (CUDA activity only, so that tracing does not slow the
    host; without a card, the host's operations) and the program's spans
    (process "spans", recorded by default under the profiler; each
    `train.step` with its step's counters) on one timeline; with a card
    also dir/idle.json: the window's seconds, its steps and the card's
    idle seconds by span (idle_by_span)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    rec = drain()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    for s in rec.spans:
        args = {"step": s.step, "device_ms": s.device_ms}
        if s.name == "train.step":
            args.update(rec.steps.get(s.step, {}))
        doc["traceEvents"].append({
            "ph": "X", "cat": "span", "name": s.name, "pid": "spans",
            "tid": 0, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
    if cuda:
        steps = {s.step for s in rec.spans if s.name == "train.step"}
        with open(os.path.join(logdir, "idle.json"), "w") as f:
            json.dump({"window_s": (t1 - t0) * 1e-9, "steps": len(steps),
                       "idle_s": idle_by_span(device_intervals(prof),
                                              rec.spans, t0, t1)}, f)


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
