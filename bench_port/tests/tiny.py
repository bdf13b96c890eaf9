"""A tiny cell for the benchmark's CPU tests: the configurations and the
traffic cut to a few hundred Gaussians and 64x48 frames, so that a run of
the harness takes seconds on the CPU."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_traffic() -> dict:
    return dict(load("traffic", "orbit24.json"), frames=10, width=64,
                height=48, trace_seconds=0.5)


def tiny_config(name: str) -> dict:
    c = copy.deepcopy(load("configs", f"{name}.json"))
    c["scene_points"] = 300
    c["body_vpb"] = 4
    r = c["recipe"]
    r["scene"]["max_n_gaussians"] = 1024
    r["human"].update(max_n_gaussians=2048, triplane_res=16, init_steps=2,
                      n_subdivision=1)
    r["human"]["loss"].update(num_patches=1, patch_size=16)
    return c


# The tiny cell's limits. A cell's own limits are set from readings at
# its size; at a few hundred Gaussians one leaf's Adam step that flips
# sign (the cameras reach the program through COLMAP's quaternions)
# weighs far more in a leaf's change than among 524,288 rows.
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2,
               "distill_gap": 1e-3}


def overrides(cell: str) -> dict:
    config = {"joint_train": "hugs_human_scene",
              "scene_train": "hugs_scene"}[cell]
    return {"config": tiny_config(config), "traffic": tiny_traffic(),
            "limits": dict(TINY_LIMITS)}
