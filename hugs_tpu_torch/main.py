"""The port's training command (the reference's and the JAX package's
main.py):

  python -m hugs_tpu_torch.main --cfg_file cfg_files/neuman/hugs_human_scene.yaml \\
      [--cfg_id N] [--device cuda|cpu] [dotted.key=value ...]

Merges the defaults, the YAML file and the dotted overrides, expands
list-valued leaves into a grid of configurations (--cfg_id picks one),
and for each: makes the logdir tree, loads the NeuMan train, val and
anim splits (the anim split where its AMASS clip exists), trains, writes
results_train.json and the final checkpoint, validates and writes
results_eval.json, animates the anim split into logdir/anim and renders
the canonical avatar's turntable into logdir/canon (reference main.py:
24-108). The device defaults to cuda; a run on the CPU must ask for it.

On N cards of one machine (config[4]'s scale-out; train.batch_size a
multiple of N, so that no rank idles):

  python -m torch.distributed.run --nproc_per_node=N -m hugs_tpu_torch.main \\
      --cfg_file ... train.batch_size=B [train.anim_batch_size=B] ...

Under torchrun's variables each rank joins one process group (NCCL on
card LOCAL_RANK; gloo with --device cpu) and trains its share of each
batch; rank 0 writes the logdir, the checkpoints, the metrics and the
images while the others wait, and animate splits each batch of frames
over the ranks. Without the variables nothing changes.

The Gaussian-sharded scene (tpu.gauss_shard = N, the world's size; 1 on
one card without torchrun):

  python -m torch.distributed.run --nproc_per_node=N -m hugs_tpu_torch.main \\
      --cfg_file ... mode=scene tpu.gauss_shard=N

each rank owns 1/N of the scene's rows and the evaluation renders
exchange fragments, so every rank validates, animates and renders the
turntable, and rank 0 writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from hugs_tpu_torch.cfg import get_cfg_items, load_config
from hugs_tpu_torch.data.neuman import NeumanDataset
from hugs_tpu_torch.parallel.mesh import init_distributed, make_mesh
from hugs_tpu_torch.train.trainer import GaussianTrainer


def setup_logdir(cfg, write: bool = True):
    """Sets the run's logdir and, where `write`, makes its tree and
    writes config_train.yaml."""
    cfg.logdir = os.path.join(cfg.output_path, cfg.dataset.name,
                              str(cfg.dataset.seq), cfg.exp_name)
    cfg.logdir_ckpt = os.path.join(cfg.logdir, "ckpt")
    if not write:
        return
    for sub in ("", "ckpt", "train", "val", "anim", "meshes", "canon"):
        os.makedirs(os.path.join(cfg.logdir, sub), exist_ok=True)
    with open(os.path.join(cfg.logdir, "config_train.yaml"), "w") as f:
        f.write(cfg.to_yaml())


def build_datasets(cfg, device):
    """(train, val, anim) NeuMan splits, None where the sequence is
    missing; anim is None where its AMASS clip is missing or the
    sequence has none."""
    root = cfg.dataset_path or "data/neuman/dataset"
    if cfg.dataset.name != "neuman" or not os.path.isdir(
            os.path.join(root, str(cfg.dataset.seq))):
        return None, None, None
    train_ds = None
    if not cfg.eval:
        train_ds = NeumanDataset(
            root, cfg.dataset.seq, "train", render_mode=cfg.mode,
            add_bg_points=cfg.scene.add_bg_points,
            num_bg_points=cfg.scene.num_bg_points,
            bg_sphere_dist=cfg.scene.bg_sphere_dist,
            clean_pcd=cfg.scene.clean_pcd, device=device)
    val_ds = NeumanDataset(root, cfg.dataset.seq, "val",
                           render_mode=cfg.mode, device=device)
    try:
        anim_ds = NeumanDataset(root, cfg.dataset.seq, "anim",
                                render_mode=cfg.mode, device=device)
    except (FileNotFoundError, KeyError):
        anim_ds = None
    return train_ds, val_ds, anim_ds


def main(cfg, device: torch.device | str = "cuda") -> int:
    np.random.seed(cfg.seed)
    mesh = make_mesh()
    setup_logdir(cfg, write=mesh.is_writer)
    mesh.barrier()
    train_ds, val_ds, anim_ds = build_datasets(cfg, device)
    if train_ds is None and not cfg.eval:
        print(f"ERROR: dataset not found under "
              f"{cfg.dataset_path or 'data/neuman/dataset'}: prepare the "
              f"NeuMan data first", file=sys.stderr)
        return 1
    trainer = GaussianTrainer(cfg, train_ds, val_ds, anim_ds, device=device,
                              mesh=mesh)
    if not cfg.eval:
        log = trainer.train()
        if mesh.is_writer:
            with open(os.path.join(cfg.logdir, "results_train.json"),
                      "w") as f:
                json.dump(log, f)
        trainer.save_ckpt()
    # renders that exchange fragments run on every rank
    every = mesh.is_writer or trainer.gauss_collective
    if val_ds is not None and every:
        metrics = trainer.validate()
        if mesh.is_writer:
            with open(os.path.join(cfg.logdir, "results_eval.json"),
                      "w") as f:
                json.dump(metrics, f, indent=2)
            print(json.dumps(metrics, indent=2))
    mesh.barrier()
    if anim_ds is not None:
        trainer.animate()
    if cfg.mode in ("human", "human_scene") and every:
        trainer.render_canonical(nframes=cfg.human.canon_nframes)
    mesh.barrier()
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg_file", type=str, default=None)
    ap.add_argument("--cfg_id", type=int, default=-1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    items = get_cfg_items(load_config(args.cfg_file, args.overrides))
    if args.cfg_id >= 0:
        items = [items[args.cfg_id]]
    device = init_distributed(args.device)
    rc = 0
    try:
        for c in items:
            rc |= main(c, device) or 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(cli())
