"""The convergence recipes' entry points on the CPU
(hugs_tpu_torch/convergence): each runs `--smoke --device cpu` to its
end, in process, and writes its JSON record with the script's keys
(workload, steps_per_s, wall_s, psnr_curve, device) and the card's line,
finite numbers, a positive held-out PSNR at every point of the curve, no
overflow that persisted past a retry, and its PNGs; without --device cpu
and without a card each exits 2 and writes nothing. (The parity of their
pieces with the scripts and hugs_tpu is test_torch_convergence.py's.)
"""
import json
import math

import pytest
import torch

from hugs_tpu_torch.convergence import (
    flagship_release, human_avatar, joint_scene, surface_scene,
)
from torch_parity import few_threads  # noqa: F401 (autouse)

ENTRIES = {"human_avatar": human_avatar, "joint_scene": joint_scene,
           "surface_scene": surface_scene,
           "flagship_release": flagship_release}
RECORD_KEYS = {"workload", "steps_per_s", "wall_s", "psnr_curve", "device",
               "card"}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_point_smoke_on_cpu(name, tmp_path):
    mod = ENTRIES[name]
    assert mod.main(["--smoke", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    rec = json.loads((tmp_path / f"{name}.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["device"] == "cpu"
    assert rec["psnr_curve"] and all(
        math.isfinite(p["psnr_held"]) and p["psnr_held"] > 0
        for p in rec["psnr_curve"])
    assert math.isfinite(rec["steps_per_s"]) and rec["steps_per_s"] > 0
    assert math.isfinite(rec["wall_s"]) and rec["wall_s"] > 0
    assert rec.get("overflow_persisted", 0) == 0
    assert sorted(p.name for p in tmp_path.glob("*.png"))


def test_entry_points_refuse_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for mod in ENTRIES.values():
        assert mod.main(["--smoke", "--out", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
