"""A tiny dry run of the traffic driver on the CPU, the checks of the
check (the timed path broken underneath a run must read not correct),
and, on the card, the control."""
from __future__ import annotations

import json
import statistics

import pytest

from bench_port.reference import compare
from tiny import TINY_LIMITS, overrides

CELLS = ("joint_train", "scene_train")


def run_line(cell: str, capsys, **extra) -> dict:
    from bench_port import run
    rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds",
                   "0.5", "--trace", "0"], device="cpu",
                  overrides=dict(overrides(cell), **extra))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell, capsys):
    """The whole run of a tiny cell: set-up, the checked steps, the
    window and the reference, correct, with steps in the window."""
    line = run_line(cell, capsys)
    assert line["correct"] is True
    assert line["attempted"] >= 1
    assert line["metrics"]["train_step_ms"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_step_is_not_correct(cell, fault, capsys):
    """A step that returns its state unchanged, and a loss over half of
    the frame (the mean over the rest), each read not correct."""
    line = run_line(cell, capsys, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_undistilled_nets_are_not_correct(capsys):
    """The avatar's nets left as drawn, the program's init distillation
    skipped, read not correct by the distillation's own number."""
    line = run_line("joint_train", capsys, fault="undistilled")
    assert line["correct"] is False
    gap = line["checks"]["distill_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda_device):
    """The control, the reference in TF32 put in the program's place,
    fails one of the tiny cell's numbers against its limits, on the
    card; the program itself passes them."""
    from bench_port import readings
    limits = TINY_LIMITS
    rec = readings.readings(cell, 2147483711, True, cuda_device,
                            overrides(cell))
    assert all(v <= limits[k] for k, v in rec["sound"].items())
    assert any(v > limits[k] for k, v in rec["control"].items())



def _step_record(tr) -> dict:
    """What one step from the first leaves behind: Adam's first moment
    of every leaf (0.1 of the gradient it got) and the densification
    statistics."""
    from bench_port.drivers import trainer_steps as ts
    out = {k: m.detach().clone() for k, (_, m) in
           ts.program_leaves(tr).items()}
    for name, s in (("human", tr.human and tr.human.state),
                    ("scene", tr.scene and tr.scene.gs)):
        if s:
            for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
                out[f"{name}.{f}"] = getattr(s, f).detach().clone()
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_staged_step_is_the_window_step(cell, tmp_path):
    """The traced run's staged step, whose stages the per-layer metrics
    time, does what the window's step does: from the same state and
    frame, the same loss, the same gradients in Adam's moments and the
    same statistics, to the CPU's round-off (its threads sum in no fixed
    order, so two window steps differ by as much): each leaf's gap over
    the larger of its norm and the median leaf's, as compare.py takes
    it; and the parameters' change within the tiny cell's limits."""
    import torch

    from bench_port.drivers import trainer_steps as ts
    o = overrides(cell)
    c = ts.Cell(o["config"], o["traffic"], 3000000019, "cpu", str(tmp_path))
    tr = c.trainer
    runs = []
    for step in (lambda loop: loop.step()["loss"],
                 lambda loop: ts.staged_step(loop, None)["loss"]):
        ts.restore(tr, c.start, c.gen_state)
        loss = step(ts.Loop(tr))
        leaves = ts.program_leaves(tr)
        runs.append((float(loss), _step_record(tr), {
            "losses": [float(loss)],
            "grad_norms": {k: float(torch.linalg.vector_norm(m / 0.1))
                           for k, (_, m) in leaves.items()},
            "change_norms": {k: float(torch.linalg.vector_norm(
                p.detach() - c.start[k])) for k, (p, _) in leaves.items()}}))
    (loss_w, rec_w, steps_w), (loss_s, rec_s, steps_s) = runs
    assert loss_s == loss_w
    for name, (gap, where) in compare.gaps(steps_s, steps_w).items():
        assert gap <= TINY_LIMITS[name], (name, gap, where)
    assert rec_s.keys() == rec_w.keys()
    norms = {k: float(torch.linalg.vector_norm(w)) for k, w in rec_w.items()}
    med = statistics.median(norms.values())
    assert med > 0
    for k, w in rec_w.items():
        gap = float(torch.linalg.vector_norm(rec_s[k] - w))
        assert gap <= 1e-5 * max(norms[k], med), k
