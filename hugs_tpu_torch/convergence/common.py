"""What the convergence recipes share: the command line, the device and
the card's line, the ground truth's striped splats, slot budgets sized
from demand, and the record each run writes.

Budgets. The TPU scripts fixed their slot budgets for 32-px tiles
(1 << 17 for the avatar's renders, 1 << 18 and 1 << 19 for the
flagship's and the surface's ground truth). The port bins into 16-px
tiles, where a Gaussian covers more tiles, so every render here sizes
its budget from the demand of render/tiles.py's binning: the ground
truth from a binning-only probe of each frame (`probe_demand`), the
training and held-out renders from a starting budget that grows and
renders again when a frame overflows it (train/budget.py::fit_budget,
the trainer's own rule). A render that still overflows raises; none
drops instances silently.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hugs_tpu_torch.ops.knn import mean_sq_dist_to_knn
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.train.trainer import GaussianTrainer
from hugs_tpu_torch.utils.image import save_png

SH_C0 = 0.28209479177387814
PAGE = 8192            # budgets are whole pages of slots
PROBE = 1 << 12        # a probe's own budget: n_slots reports the demand


def parse_args(name: str, description: str, argv=None,
               **extra) -> argparse.Namespace:
    """--device (cuda unless cpu is asked for), --smoke (the script's
    SMOKE sizes), --out (default runs/<name>) and `extra`
    arguments, each name -> (type, default, help)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the script's SMOKE sizes")
    ap.add_argument("--out", default=os.path.join("runs", name),
                    help="directory of the JSON record and the PNGs "
                         "(default %(default)s)")
    for key, (typ, default, text) in extra.items():
        ap.add_argument(f"--{key}", type=typ, default=default, help=text)
    return ap.parse_args(argv)


def device_of(args) -> torch.device | None:
    """The run's device with TF32 off (SSIM's and LPIPS's convolutions
    must not round to TF32), or None, with a message, where the card is
    asked for and there is none."""
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from hugs_tpu_torch import build
        build.build([cuda_blend.SOURCE, cuda_blend.BWD_SOURCE])
    return dev


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"
    on the CPU."""
    if device.type != "cuda":
        return "cpu"
    from hugs_tpu_torch.micro import card
    return card()


def sh0(col: np.ndarray) -> np.ndarray:
    """(n, 16, 3) SH coefficients of a constant colour (n, 3): the DC term
    only."""
    out = np.zeros((col.shape[0], 16, 3), np.float32)
    out[:, 0, :] = (col - 0.5) / SH_C0
    return out


def stripes(v: np.ndarray) -> np.ndarray:
    """The striped colour of the scripts' ground-truth body, per vertex of
    its template (n, 3)."""
    return np.stack([0.5 + 0.45 * np.sin(25.0 * v[:, 1]),
                     0.5 + 0.45 * np.sin(20.0 * v[:, 0] + 2.0),
                     0.5 + 0.45 * np.cos(18.0 * v[:, 2] + 4.0)], axis=1)


def knn_scales(points: torch.Tensor, mult: float) -> torch.Tensor:
    """(n, 3) isotropic scales: mult x the root mean squared distance to
    each point's 3 nearest neighbours (ops/knn.py)."""
    d2 = mean_sq_dist_to_knn(points, k=3)
    return (torch.sqrt(torch.clamp(d2, min=1e-8))[:, None] * mult).repeat(
        1, 3)


def pages(n: int) -> int:
    """n slots rounded up to whole pages."""
    return max(-(-int(n) // PAGE), 1) * PAGE


def probe_demand(xyz, scales, rotq, opacity, shs, camera, width, height,
                 **kw) -> int:
    """The slot demand of one render's binning, from a binning-only probe
    (no blend kernel runs)."""
    pkg = render(xyz, scales, rotq, opacity, shs, camera, width, height,
                 instance_budget=PROBE, bin_only=True, **kw)
    return int(pkg["n_slots"])


def launches() -> dict:
    """K1's and K2's launch counts (cuda_blend's counters)."""
    return {"K1": cuda_blend.LAUNCHES, "K2": cuda_blend.K2_LAUNCHES}


def since(before: dict) -> dict:
    """The launches since `before` (launches())."""
    now = launches()
    return {k: now[k] - before[k] for k in now}


def wall(device: torch.device) -> float:
    """Host-clock seconds, the device's queued work finished first."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


class Trainer(GaussianTrainer):
    """GaussianTrainer printing each validation's metrics as it makes them,
    so that the log of a run cut short keeps its curve."""

    def validate(self, t_iter: int | None = None) -> dict:
        out = super().validate(t_iter)
        print(f"validate {'final' if t_iter is None else t_iter}: "
              f"{json.dumps(out)}", flush=True)
        return out


class FrameList:
    """Frames in a list, the trainer's dataset: with the scene's initial
    cloud (points, colours) and radius."""

    def __init__(self, items, init_pcd=None, radius=None):
        self.items = items
        self.init_pcd = init_pcd
        self.radius = radius

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def write_record(out_dir: str, name: str, record: dict) -> str:
    """The run's JSON record, printed on one line and written to
    out_dir/<name>.json."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return path


def write_png(out_dir: str, name: str, img) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_png(img, os.path.join(out_dir, name))
