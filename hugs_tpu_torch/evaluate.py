"""The port's evaluation command (the JAX package's scripts/evaluate.py):

  python -m hugs_tpu_torch.evaluate -o OUTDIR [--device cuda|cpu]

OUTDIR is a training run's logdir (hugs_tpu_torch.main writes one under
output_path/dataset/seq/exp_name). Reads its config_train.yaml, loads the
NeuMan val and anim splits, restores the latest checkpoint, compacts the
Gaussians to the live rows, sizes the instance budget from a binning-only
rehearsal of the val and anim frames, validates into OUTDIR/
results_eval.json, animates the anim split into OUTDIR/anim and, for a
run with a human, renders the canonical turntable into OUTDIR/canon (the
JAX package's evaluate stops after animate; its main.py renders the
turntable). Exits 1 without a config_train.yaml or a checkpoint, 2
without a card unless --device cpu.

On N cards: `python -m torch.distributed.run --nproc_per_node=N -m
hugs_tpu_torch.evaluate -o OUTDIR`. Each rank restores the checkpoint;
rank 0 validates and writes, and animate splits each batch of
train.anim_batch_size frames over the ranks. A run with tpu.gauss_shard
= N renders through the Gaussian-sharded renderer on the N ranks:
every rank validates, animates and renders the turntable, rank 0
writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.main import build_datasets
from hugs_tpu_torch.parallel.mesh import init_distributed, make_mesh
from hugs_tpu_torch.train.trainer import GaussianTrainer


def evaluate(output_dir: str, device: torch.device | str = "cuda",
             trainer_cls=GaussianTrainer, times: dict | None = None) -> int:
    """Evaluates the run in output_dir on `device`; returns the exit code.
    `times`, if given, receives each stage's host-clock seconds (load,
    compact, rehearse, validate, animate, canonical); `trainer_cls` is
    the trainer class to build."""
    cfg_path = os.path.join(output_dir, "config_train.yaml")
    if not os.path.exists(cfg_path):
        # a checkpoint evaluated under the default configuration gives
        # wrong metrics without an error: refuse instead
        print(f"error: {cfg_path} not found: not a training output "
              f"directory", file=sys.stderr)
        return 1
    times = {} if times is None else times
    t0 = time.time()
    cfg = load_config(cfg_path)
    cfg.eval = True
    cfg.logdir = output_dir
    cfg.logdir_ckpt = os.path.join(output_dir, "ckpt")
    _, val_ds, anim_ds = build_datasets(cfg, device)
    mesh = make_mesh()
    trainer = trainer_cls(cfg, None, val_ds, anim_ds, device=device,
                          mesh=mesh)
    if not trainer.load_latest_ckpt():
        print(f"error: no checkpoint found under {cfg.logdir_ckpt}",
              file=sys.stderr)
        return 1

    def stage(name, fn):
        t = time.time()
        out = fn()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        times[name] = time.time() - t
        return out

    times["load"] = time.time() - t0
    # the training capacity's padded rows cost every frame
    stage("compact", trainer.compact_for_eval)
    stage("rehearse", trainer.rehearse_budget)
    # renders that exchange fragments (tpu.gauss_shard > 1) run on every
    # rank
    every = mesh.is_writer or trainer.gauss_collective
    if every:
        metrics = stage("validate", trainer.validate)
        if mesh.is_writer:
            with open(os.path.join(output_dir, "results_eval.json"),
                      "w") as f:
                json.dump(metrics, f, indent=2)
            print(json.dumps(metrics, indent=2))
    mesh.barrier()
    if anim_ds is not None:
        stage("animate", trainer.animate)
    if cfg.mode in ("human", "human_scene") and every:
        stage("canonical", lambda: trainer.render_canonical(
            nframes=cfg.human.canon_nframes))
    mesh.barrier()
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    device = init_distributed(args.device)
    try:
        return evaluate(args.output_dir, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(cli())
