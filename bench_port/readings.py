"""The readings that a cell's limits are set from, on the chip at the
cell's own size:

    python3 bench_port/readings.py --workload <cell> --seeds <n> ... \
        [--faults 3] [--out chiprun_out/readings_<cell>.jsonl]

For each seed, one set-up of the cell (as a run makes it), then
compare.py's numbers for the program's first steps (sound), and for the
first `--faults` seeds also for the program with half of each frame left
out of its loss (the fault 'half'), for the reference with its
distillation left out put in the program's place ('undistilled', where
the recipe distills), for the control: the reference run in TF32, the
precision below the configuration's float32, put in the program's place,
and for a second run of the reference itself (the round-off between two
runs of one implementation on the card). A state left unchanged reads 1
by construction and needs no run. Every number is against the reference
in float32. One JSON line a seed, to standard output and to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from bench_port import run as harness  # noqa: E402
from bench_port.drivers import trainer_steps as ts  # noqa: E402
from bench_port.reference import compare  # noqa: E402


def record(out: dict, kind: str, got: dict, ref: dict) -> None:
    """compare.py's numbers of `got` against `ref` under out[kind], with
    their `where` (the worst leaf) and each step's loss gap beside."""
    gaps = compare.gaps(got, ref)
    out[kind] = {k: v for k, (v, _) in gaps.items()}
    out[f"{kind}_where"] = {k: w for k, (_, w) in gaps.items()}
    out[f"{kind}_step_loss_gaps"] = [
        abs(p - r) / abs(r) for p, r in zip(got["losses"], ref["losses"])]


def readings(cell_name: str, seed: int, fault: bool, device="cuda",
             overrides: dict | None = None) -> dict:
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, cell_name)
    overrides = overrides or {}
    config = overrides.get("config") or harness.load_json(
        HERE, "configs", f"{cell['config']}.json")
    traffic = overrides.get("traffic") or harness.load_json(
        HERE, "traffic", f"{cell['traffic']}.json")
    out = {"cell": cell_name, "seed": seed}
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        c = ts.Cell(config, traffic, seed, device, tmp)
        sound = c.program
        half = c.again("half") if fault else None
        c.trainer = c.loop = None
        ts._free(ts.torch.device(device))
        ctl = c.reference(tf32=True) if fault else None
        ref = c.reference(judged=(ctl["distill"]["own_nets"],)
                          if ctl and "distill" in ctl else ())
        record(out, "sound", sound, ref)
        if fault:
            record(out, "half", half, ref)
            record(out, "control", ctl, ref)
            if "distill" in ref:
                d = ref["distill"]
                out["control"]["distill_gap"] = abs(
                    d["judged"][0] - d["own"]) / d["own"]
                out["undistilled"] = {"distill_gap": abs(
                    d["init"] - d["own"]) / d["own"]}
            again = c.reference()
            record(out, "reference_again", again, ref)
            if "distill" in ref:
                out["reference_again"]["distill_gap"] = abs(
                    again["distill"]["own"] - d["own"]) / d["own"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    for i, seed in enumerate(a.seeds):
        rec = readings(a.workload, seed, i < a.faults)
        line = json.dumps(rec)
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
