"""The harness: files found by name, the result line, and the checks on
what a run loads."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from tiny import BENCH, overrides

ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_tiny(cell: str, capsys, **extra) -> dict:
    from bench_port import run
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                   "0.5", "--trace", "0"], device="cpu",
                  overrides=dict(overrides(cell), **extra))
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_result_line_keys(capsys):
    """The last line holds the contract's keys, the checks last, and
    the cell's end-to-end metrics."""
    line = run_tiny("scene_train", capsys)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    assert line["correct"] is True
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])


def test_found_by_name_without_edits(tmp_path):
    """A cell, a configuration, a traffic mix with its driver and a
    per-layer metric, each added as new files and BENCHMARK.json entries
    in a copy, run with no edit to a file the benchmark already has."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    before = {p: p.read_bytes() for p in (copy / "bench_port").rglob("*")
              if p.is_file()}
    b = copy / "bench_port"
    (b / "configs" / "echo_config.json").write_text(json.dumps(
        {"name": "echo_config", "steps": 7}))
    (b / "traffic" / "echo.json").write_text(json.dumps(
        {"driver": "echo_driver", "ms": 2.5}))
    (b / "drivers" / "echo_driver.py").write_text(textwrap.dedent('''
        def run(config, traffic, limits, seed, seconds, trace, device,
                t_process):
            return {"steps": config["steps"], "window_s": 1.0,
                    "setup_s": 0.5, "setup_split": {},
                    "memory_peak_bytes": 0, "budget": 0,
                    "reference_s": 0.0, "echo_ms": traffic["ms"],
                    "checks": [("gap", 0.0, float(limits["gap"]), "")]}
        '''))
    (b / "limits" / "echo_cell.json").write_text(json.dumps({"gap": 1e-3}))
    (b / "metrics" / "echo_ms.py").write_text(
        "def read(rec, cell):\n    return rec.get('echo_ms')\n")
    bench["configs"].append({"name": "echo_config", "source": "x",
                             "file": "bench_port/configs/echo_config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "echo_cell", "config": "echo_config",
                               "traffic": "echo", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "echo_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "echo", "moves": "train_step_ms",
                               "workloads": ["echo_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, 'bench_port'); "
            "from bench_port import run; sys.exit(run.main(sys.argv[1:], "
            "device='cpu'))")
    out = {}
    for trace in ("0", "1"):
        p = subprocess.run([sys.executable, "-c", code, "--workload",
                            "echo_cell", "--seed", "1", "--seconds", "1",
                            "--trace", trace], cwd=copy, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, p.stderr
        out[trace] = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["0"]["metrics"]["train_step_ms"]["value"] == 1000.0 / 7
    assert out["1"]["metrics"] == {"echo_ms": {"value": 2.5, "unit": "ms"}}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing
    on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "joint_train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_by_whole_top_level_name(monkeypatch):
    from bench_port import run
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "hugs_tpu",
                 "hugs_tpu.render"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in run.loaded_forbidden()
        monkeypatch.delitem(sys.modules, name)
    for name in ("hugs_tpu_torch", "hugs_tpu_torch.render", "jaxtyping_x",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name not in run.loaded_forbidden()


def test_a_run_loads_no_jax():
    """A whole tiny run of each cell, in a fresh process, leaves no
    module of jax, jaxlib, flax or hugs_tpu in sys.modules."""
    code = textwrap.dedent('''
        import sys
        sys.path.insert(0, "bench_port/tests")
        from tiny import overrides
        from bench_port import run
        for cell in ("joint_train", "scene_train"):
            assert run.main(["--workload", cell, "--seed", "5", "--seconds",
                             "0.2", "--trace", "0"], device="cpu",
                            overrides=overrides(cell)) == 0
        print("FORBIDDEN", run.loaded_forbidden())
        ''')
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def imported_names(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program():
    """bench_port/reference names no module of hugs_tpu_torch (nor
    jax, nor hugs_tpu), and importing it loads none."""
    forbidden = {"hugs_tpu_torch", "hugs_tpu", "jax", "jaxlib", "flax"}
    for dirpath, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                tops = {n.split(".")[0] for n in imported_names(
                    os.path.join(dirpath, f))}
                assert not tops & forbidden, (f, tops & forbidden)
    code = ("import sys; import bench_port.reference.train_steps, "
            "bench_port.reference.compare, bench_port.gen.neuman_sequence, "
            "bench_port.work.step, bench_port.work.blend; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hugs_tpu_torch', 'hugs_tpu', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
