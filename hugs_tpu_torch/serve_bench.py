"""Times the inference fast path (train/trainer.py's PoseRenderer, the
engine of render_poses) on a trained checkpoint in the port's layout:

  python -m hugs_tpu_torch.serve_bench --ckpt DIR [--out F]

DIR holds human_{iter} and scene_{iter} as train/checkpoint.py writes
them (convert.save_checkpoint_from_numpy carries a hugs_tpu checkpoint
across). The model is scripts/fps_bench_tpu.py:61-80's: cfg_files/
neuman/hugs_human_scene.yaml with synthetic_smpl(460) subdivided twice
and capacities 131,072, restored into an evaluation trainer and
compacted (compact_for_eval). The frames are fps_bench_tpu.py's: its
orbit camera (distance 3, fov 0.95) at 960x540 and 20 poses, each the
one before plus 0.01 sin(i + arange(69)), the avatar alone on black.

Prints and returns one JSON object: the budget the rehearsal sized; the
frame latency (median of the 20 poses, CUDA events); the frame split
human_forward / project / bin / blend (medians of 20 after 3 warm-up
frames); the device kernels per frame and the device's idle share from
a torch.profiler trace of 5 frames; and on pose 0's frame K1's device
time (20 back-to-back launches), the plain blend's time and K1's bound:
the larger of the bytes K1 must move over 3.35 TB/s and the operations
this frame needs of it over 67 TFLOP/s (H100 SXM), counted as
chip_smoke.py's kernel_times counts them (the pairs its warp cull keeps
and tests, the culls, the blended pairs). Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

from hugs_tpu_torch.micro import (
    card, device_kernels, device_ms, feat_rows_read, warp_cull_counts,
)

W, H = 960, 540
POSES = 20
WARMUP = 3
BACK_TO_BACK = 20
PEAK_FP32 = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3
# chip_smoke.py's operation counts: per (pixel, instance) pair tested,
# per pair K1 blends, per (warp, instance) the warp cull tests
OPS_TESTED, OPS_BLENDED, OPS_CULL = 22, 12, 91


def flagship_trainer(ckpt_dir: str, device):
    """An evaluation trainer with fps_bench_tpu.py's settings, the latest
    checkpoint under ckpt_dir restored and compacted."""
    from hugs_tpu_torch.cfg import load_config
    from hugs_tpu_torch.train.trainer import GaussianTrainer
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "cfg_files", "neuman",
                                   "hugs_human_scene.yaml"))
    cfg.eval = True
    cfg.human.n_subdivision = 2
    cfg.human.max_n_gaussians = cfg.scene.max_n_gaussians = 131072
    cfg.tpu.human_capacity = cfg.tpu.scene_capacity = 131072
    cfg.tpu.smpl_vpb = 460
    cfg.logdir, cfg.logdir_ckpt = "", ckpt_dir
    tr = GaussianTrainer(cfg, None, None, None, device=device)
    if not tr.load_latest_ckpt():
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    tr.compact_for_eval()
    return tr


def k1_work(feat, bins, n_walked, blended: int, width: int, height: int):
    """(operations, bytes) K1 needs on one frame: the (pixel, instance)
    pairs its warp cull keeps and tests, the (warp, instance) pairs it
    culls, the pairs it blends; the rows of feat the lists reference,
    the list, starts and ends, bg, the image, log T and n_walked, and
    per tile its walk."""
    cull = warp_cull_counts(feat, bins, n_walked, width, height)
    ops = OPS_TESTED * cull["tested"] + OPS_CULL * cull["K1"] \
        + OPS_BLENDED * blended
    n_inst = int((bins.ends - bins.starts).sum())
    n_tiles = bins.starts.shape[0]
    nbytes = feat_rows_read(bins) * feat.shape[1] * 4 + n_inst * 4 \
        + 2 * n_tiles * 4 + 3 * 4 + 5 * width * height * 4 + n_tiles * 4
    return ops, nbytes


def measure(pr, frames, smi: str = "") -> dict:
    """The fast path's numbers on `frames` (see the module docstring) for
    a PoseRenderer `pr` on the card."""
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import bin_gaussians
    n = len(frames)
    latency = []
    stages = {k: [] for k in ("human_forward", "project", "bin", "blend",
                              "frame")}
    with torch.no_grad():
        for rep in range(WARMUP + n):
            if rep == WARMUP:       # K1's launches in the timed frames
                cuda_blend.LAUNCHES = 0
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            pr.render(frames[rep % n], rep % n)
            b.record()
            b.synchronize()
            if rep >= WARMUP:
                latency.append(a.elapsed_time(b))
        launches = cuda_blend.LAUNCHES
        for rep in range(WARMUP + n):
            cp = frames[rep % n]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            ho = pr.human_forward(cp)
            ev[1].record()
            pg = project_gaussians(ho["xyz"], ho["scales"], ho["rotq"],
                                   ho["opacity"], ho["shs"], cp["camera"],
                                   cp["width"], cp["height"],
                                   ho["active_sh_degree"], alive=ho["alive"])
            ev[2].record()
            bins = bin_gaussians(pg, cp["width"], cp["height"], pr.budget)
            ev[3].record()
            cuda_blend.blend_tiles(pg, bins, cp["width"], cp["height"],
                                   pr.bg)
            ev[4].record()
            ev[4].synchronize()
            if rep >= WARMUP:
                for k, (e0, e1) in (("human_forward", (0, 1)),
                                    ("project", (1, 2)), ("bin", (2, 3)),
                                    ("blend", (3, 4)), ("frame", (0, 4))):
                    stages[k].append(ev[e0].elapsed_time(ev[e1]))
        by_kernel, per_frame, span_us = device_kernels(
            lambda: pr.render(frames[0]))
        # K1 on pose 0's frame: its time, the plain blend's, its bound
        cp = frames[0]
        ho = pr.human_forward(cp)
        pg = project_gaussians(ho["xyz"], ho["scales"], ho["rotq"],
                               ho["opacity"], ho["shs"], cp["camera"],
                               cp["width"], cp["height"],
                               ho["active_sh_degree"], alive=ho["alive"])
        bins = bin_gaussians(pg, cp["width"], cp["height"], pr.budget)
        feat = gauss_features(pg)
        args = (feat, bins.gauss_id, bins.starts, bins.ends, pr.bg,
                cp["width"], cp["height"])
        _, _, n_walked, _ = cuda_blend.blend_fwd(*args)
        _, _, pairs = plain_blend(*args)
        k1_ms = device_ms(lambda: cuda_blend.blend_fwd(*args),
                          inner=BACK_TO_BACK)
        plain_ms = device_ms(lambda: plain_blend(*args), reps=3, warmup=1)
        ops, nbytes = k1_work(feat, bins, n_walked, int(pairs[1].sum()),
                              cp["width"], cp["height"])
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    busy = sum(by_kernel.values())
    return {
        "card": smi, "frames": n, "budget": pr.budget,
        "k1_launches": launches,
        "frame_ms": statistics.median(latency),
        "frame_ms_range": [min(latency), max(latency)],
        "stage_ms": {k: statistics.median(v) for k, v in stages.items()},
        "device_kernels_per_frame": per_frame,
        "device_idle_share": 1.0 - busy / span_us if span_us else None,
        "top_kernels_us": dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:8]),
        "instances_frame0": int((bins.ends - bins.starts).sum()),
        "k1_ms": k1_ms, "plain_ms": plain_ms,
        "k1_bound_ms": max(ops_ms, bytes_ms),
        "k1_bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "k1_ops": ops, "k1_bytes": nbytes,
        "k1_bound_share": max(ops_ms, bytes_ms) / k1_ms,
    }


def fps_bench_frames(device) -> list:
    """fps_bench_tpu.py's camera and 20 poses as PoseRenderer frames."""
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    cam = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                              nframes=2, device=device)[0]
    pose = np.zeros(69, np.float32)
    frames = []
    for i in range(POSES):
        frames.append(dict(cam, body_pose=pose.copy()))
        pose = pose + 0.01 * np.sin(i + np.arange(69, dtype=np.float32))
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="a checkpoint directory in the port's layout")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ERROR: serve_bench times the card; no CUDA device",
              file=sys.stderr)
        return 2
    from hugs_tpu_torch.train.trainer import PoseRenderer
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = flagship_trainer(args.ckpt, dev)
    body = {"global_orient": np.zeros(3, np.float32),
            "betas": np.zeros(10, np.float32),
            "transl": np.zeros(3, np.float32), "smpl_scale": np.float32(1)}
    frames = fps_bench_frames(dev)
    pr = PoseRenderer(tr, body, bg_color="black")
    pr.rehearse(frames)
    out = measure(pr, frames, card())
    out["alive"] = [int(tr.human.state.alive.sum()),
                    int(tr.scene.gs.alive.sum())]
    out["human_rows"] = int(pr.state.alive.shape[0])
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
