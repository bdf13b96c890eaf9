"""What the program's spans cost, and where the card's idle time falls
among them, on the chip at a cell's own size:

    python3 bench_port/span_study.py --workload <cell> --seed <n> \
        [--seconds 10] [--turns 2] [--out span_study.jsonl] \
        [--logdir DIR]

One set-up of the cell (as a run makes it), then in one process, in
turns (off, on, on, off, ...): the window's loop for `--seconds` with the
program's recorder off and on (ms a step), and the traced window of
bench_port/trace.py with the recorder kept off and at its default (on
under the profiler): ms a step and the device's idle share, as
`device_idle` reads it; the host µs of an empty span with a device
interval, on and off, and the spans a step. Last, one traced window
through the program's
own exporter (hugs_tpu_torch.utils.profiling.trace), whose idle.json
puts each idle gap down to the innermost span open on the host at its
start: idle ms a step by span; with --logdir its trace.json (the card's
operations and the spans on one timeline, for Perfetto) and idle.json
are kept there. One JSON line, to standard output and to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from bench_port import run as harness  # noqa: E402
from bench_port.drivers import trainer_steps as ts  # noqa: E402
from bench_port.trace import traced  # noqa: E402


def timed(loop, seconds: float, dev) -> float:
    """ms a step of the window's loop over `seconds`, to a sync."""
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        loop.step()
        n += 1
    ts._sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def span_us(profiling, on: bool, n: int = 20000) -> float:
    """Host µs of one empty span with a device interval."""
    profiling.enable(on)
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("study.empty", device=True):
            pass
    t = time.perf_counter() - t0
    profiling.drain()
    return t * 1e6 / n


def traced_window(loop, seconds: float) -> dict:
    def window():
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            loop.step()
            n += 1
        return n
    n, dt = traced(window)
    return {"steps": n, "ms_per_step": dt.window_s * 1e3 / n,
            "device_idle": 100.0 * (1.0 - dt.busy_s / dt.window_s)}


def study(cell_name: str, seed: int, seconds: float, turns: int,
          device="cuda", logdir: str | None = None) -> dict:
    from hugs_tpu_torch.utils import profiling
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, cell_name)
    config = harness.load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = harness.load_json(HERE, "traffic", f"{cell['traffic']}.json")
    t_trace = float(traffic["trace_seconds"])
    dev = ts.torch.device(device)
    out = {"cell": cell_name, "seed": seed, "card": harness.power_limit(),
           "turns": []}
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        c = ts.Cell(config, traffic, seed, dev, tmp)
        c.warm_up()
        loop = c.loop
        out["span_us"] = {"off": span_us(profiling, False),
                          "on": span_us(profiling, True)}
        order = [False, True, True, False] * turns
        for on in order:
            profiling.enable(on)
            first = loop.t_iter
            ms = timed(loop, seconds, dev)
            rec = profiling.drain()
            if on:
                n = loop.t_iter - first
                out["spans_per_step"] = len(rec.spans) / n
                out["device_spans_per_step"] = sum(
                    s.device_ms is not None for s in rec.spans) / n
            profiling.enable(None if on else False)
            tw = traced_window(loop, t_trace)
            profiling.drain()
            out["turns"].append({"spans": on, "timed_ms_per_step": ms,
                                 "traced": tw})
            print(json.dumps(out["turns"][-1]), file=sys.stderr, flush=True)
        profiling.enable(None)
        logdir = logdir or os.path.join(tmp, "trace")
        with profiling.trace(logdir):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < t_trace:
                loop.step()
        with open(os.path.join(logdir, "idle.json")) as f:
            idle = json.load(f)
        out["idle"] = {"window_s": idle["window_s"], "steps": idle["steps"],
                       "idle_ms_per_step": {
                           k: v * 1e3 / idle["steps"] for k, v in sorted(
                               idle["idle_s"].items(), key=lambda kv: -kv[1])}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--out", default=None)
    p.add_argument("--logdir", default=None)
    a = p.parse_args(argv)
    line = json.dumps(study(a.workload, a.seed, a.seconds, a.turns,
                            logdir=a.logdir))
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    bad = harness.loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
