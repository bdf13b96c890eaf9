"""The benchmark of hugs_tpu_torch: runs one cell once and prints one
result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
BENCHMARK.json's `workloads`, its configuration in configs/<config>.json,
its traffic in traffic/<traffic>.json (which names its driver,
drivers/<driver>.py), its limits in limits/<cell>.json, and each metric
in metrics/<metric>.py, whose `read(rec, cell)` gives the number or None.
With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer ones. The comparison with the reference decides
`correct`; each number compared is printed beside its limit, last on
standard error and last in the line.

Exits non-zero, printing no result, without a CUDA device for every chip
the cell asks for, or if jax, jaxlib, flax or hugs_tpu was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hugs_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: end to end, or per layer
    with trace; those with a `workloads` list only where it names the
    cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def loaded_forbidden() -> list[str]:
    """Modules of sys.modules whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def result_line(bench: dict, cell: dict, rec: dict, trace: bool,
                device: dict) -> dict:
    """The result's dict: each metric from its reader, then the checks,
    last."""
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        reader = importlib.import_module(f"bench_port.metrics.{m['name']}")
        value = reader.read(rec, cell)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    out = {"correct": all(v <= lim for _, v, lim, _ in checks),
           "attempted": rec["steps"], "failed": 0, "metrics": metrics,
           "device": device}
    dt = rec.get("device_trace")
    if trace and dt is not None:
        out["device"] = dict(device, busy_s=dt.busy_s, window_s=dt.window_s)
        ops = sorted(dt.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, (s, _) in ops],
            "idle_gaps": [[label, s] for s, label in dt.gaps]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim, _ in checks}
    return out


def main(argv=None, device: str = "cuda", overrides: dict | None = None
         ) -> int:
    """One run. `device` and `overrides` (replacement 'config',
    'traffic' or 'limits' dicts, and a 'fault' for the driver) are for
    the benchmark's own tests, which run a tiny cell on the CPU."""
    args = parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # every kernel cache at a fixed path in the checkout: the port's nvcc
    # builds go to build/hugs_tpu_torch (hugs_tpu_torch/build.py)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build",
                                                  "triton_cache")
    os.environ["USE_FLAX"] = "0"
    overrides = overrides or {}
    config = overrides.get("config") or load_json(
        HERE, "configs", f"{cell['config']}.json")
    traffic = overrides.get("traffic") or load_json(
        HERE, "traffic", f"{cell['traffic']}.json")
    limits = overrides.get("limits") or load_json(
        HERE, "limits", f"{cell['name']}.json")
    driver = importlib.import_module(f"bench_port.drivers.{traffic['driver']}")
    kw = {"fault": overrides["fault"]} if "fault" in overrides else {}
    rec = driver.run(config, traffic, limits, args.seed, args.seconds,
                     bool(args.trace), device, T_PROCESS, **kw)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    line = result_line(bench, cell, rec, bool(args.trace), dev)
    print(f"# setup_s {rec['setup_s']:.4f} by part: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["setup_split"].items()),
        file=sys.stderr)
    # the driver's notes: the reference's seconds, the instance budget,
    # the device's peak bytes in set-up and in the window
    print("# " + ", ".join(f"{k} {rec[k]}" for k in (
        "reference_s", "budget", "setup_peak_bytes", "memory_peak_bytes")
        if k in rec), file=sys.stderr)
    for w in rec.get("renders", []):
        print("# staged render: " + ", ".join(f"{k} {v}" for k, v in
                                             w.items()), file=sys.stderr)
    if args.trace and device == "cuda":
        print(f"# card, power limit: {power_limit()}", file=sys.stderr)
    for name, v, lim, where in rec["checks"]:
        print(f"{name} {v!r} limit {lim!r} ({where})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
