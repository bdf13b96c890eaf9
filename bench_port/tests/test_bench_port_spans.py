"""The per-layer metrics that read the program's spans and counters
(bench_port/spans.py): each reader on a synthetic record, a record with
no spans (None), and on the CPU the window's own steps told apart from
the staged steps that follow it."""
from __future__ import annotations

import importlib

import pytest

from hugs_tpu_torch.utils import profiling
from hugs_tpu_torch.utils.profiling import Span
from tiny import overrides

READERS = ("span_human_forward_ms", "span_render_ms", "span_loss_ms",
           "span_backward_ms", "span_optim_ms", "knn_ms", "binning_ms",
           "sync_wait_ms", "host_dispatch_ms", "slot_fill")
MS = 1_000_000


def read(name: str, rec: dict):
    return importlib.import_module(f"bench_port.metrics.{name}").read(
        rec, {"name": "joint_train"})


def synthetic() -> dict:
    """Two window steps (10, 11), one a sync step, and a staged step's
    spans (no train.step; its periodic at step 12). Host ms as laid out;
    device ms given."""
    spans = []

    def add(name, parent, step, t0, t1, dev):
        spans.append(Span(name, parent, step, t0 * MS, t1 * MS, dev))
        return len(spans) - 1

    for step, t, sync in ((10, 0, True), (11, 100, False)):
        root = add("train.step", None, step, t, t + 60, 50.0)
        hf = add("step.human_forward", root, step, t, t + 20, 30.0)
        add("human.knn_targets", hf, step, t + 5, t + 10, 12.0)
        r = add("step.render", root, step, t + 20, t + 30, 8.0)
        add("render.bin", r, step, t + 21, t + 23, 1.0)
        add("render.bin", r, step, t + 24, t + 25, 0.5)
        add("step.loss", root, step, t + 30, t + 35, 2.0)
        if sync:
            add("step.sync_readback", root, step, t + 35, t + 45, None)
        add("step.backward", root, step, t + 45, t + 55, 6.0)
        add("step.optim", root, step, t + 55, t + 60, 4.0)
        add("train.periodic", None, step, t + 60, t + 62, None)
    # the staged step after the window
    add("step.human_forward", None, None, 300, 400, 99.0)
    add("train.periodic", None, 12, 400, 401, None)
    counters = {10: {"n_slots": 250, "n_instances": 200, "budget": 1000,
                     "knn_chunks": 128},
                11: {"knn_chunks": 128}, 12: {"n_slots": 1, "budget": 1}}
    return {"steps": 2, "spans": spans, "step_counters": counters}


def test_readers_on_a_synthetic_record():
    rec = synthetic()
    want = {"span_human_forward_ms": 30.0, "span_render_ms": 8.0,
            "span_loss_ms": 2.0, "span_backward_ms": 6.0,
            "span_optim_ms": 4.0, "knn_ms": 12.0, "binning_ms": 1.5,
            # 10 ms of read-back over 2 steps
            "sync_wait_ms": 5.0,
            # (60 + 2) ms a step inside the roots, less the read-back's 5
            "host_dispatch_ms": 57.0,
            "slot_fill": 25.0}
    for name in READERS:
        assert read(name, rec) == pytest.approx(want[name]), name


def test_readers_without_spans_give_none():
    """A record without spans, from a program whose recorder holds
    nothing (as a program without the recorder leaves it)."""
    profiling.drain()
    for name in READERS:
        assert read(name, {"steps": 3}) is None, name
    empty = {"steps": 3, "spans": [], "step_counters": {}}
    for name in READERS:
        assert read(name, empty) is None, name


def test_device_metrics_need_device_intervals():
    """On the CPU the spans carry no device interval: the device
    metrics give None, not host times."""
    rec = synthetic()
    rec["spans"] = [s._replace(device_ms=None) for s in rec["spans"]]
    for name in READERS:
        got = read(name, rec)
        if name in ("sync_wait_ms", "host_dispatch_ms", "slot_fill"):
            assert got is not None, name
        else:
            assert got is None, name


def test_window_steps_on_the_cpu(tmp_path):
    """A tiny joint cell on the CPU: three steps of the window's call
    with the recorder on, then two staged steps, read as the traced run
    reads them: the window's three steps alone."""
    from bench_port.drivers import trainer_steps as ts
    o = overrides("joint_train")
    c = ts.Cell(o["config"], o["traffic"], 3000000019, "cpu", str(tmp_path))
    profiling.drain()
    profiling.enable(True)
    try:
        first = c.loop.t_iter
        for _ in range(3):
            c.loop.step()
        for _ in range(2):
            ts.staged_step(c.loop, None)
    finally:
        profiling.enable(None)
    rec = {"steps": 3}
    assert read("span_render_ms", rec) is None        # no device here
    from bench_port.spans import window
    w = window(rec)
    assert w.steps == 3
    assert {s.step for s in w.spans} == {first, first + 1, first + 2}
    assert read("host_dispatch_ms", rec) > 0
    assert read("sync_wait_ms", rec) >= 0
    fill = read("slot_fill", rec)
    if any(c.trainer._is_sync_step(t) for t in range(first, first + 3)):
        assert 0 < fill <= 100
