"""Checkpoints of the training states, with torch.save.

The JAX package's layout and auto-resume (reference state_dicts with the
optimizer moments and densification statistics, scene.py:70-104 /
hugs_trimlp.py:152-195; resume from the latest, gs_trainer.py:134-138,
163-167): `human_{iter}` and `scene_{iter}` under the checkpoint
directory, `final` after every numbered one. A file holds one train
state flattened to {dotted name: tensor} (modules by their parameter
and buffer names, NamedTuples by field, dicts by key), which
torch.load(weights_only=True) reads back without unpickling code.

Restoring copies into the caller's states in place and refuses a shape
mismatch, except in the per-frame pose tables (`global_orient`,
`body_pose`, `transl`, their moments included): an evaluation trainer
has no train split, so those keep the caller's values with a warning;
evaluation poses the body from the dataset's SMPL parameters.
"""
from __future__ import annotations

import os
import re
import warnings

import torch

PER_FRAME_KEYS = ("global_orient", "body_pose", "transl")


def flatten(x, prefix: str = "") -> dict:
    """{dotted name: tensor} of a train state; None leaves are left out."""
    if isinstance(x, torch.nn.Module):
        items = list(x.named_parameters()) + list(x.named_buffers())
        return {f"{prefix}{k}": v for k, v in items}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        x = x._asdict()
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(x, torch.Tensor):
        return {prefix[:-1]: x}
    return {}


def save(ckpt_dir: str, iter_s: str, human=None, scene=None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, st in (("human", human), ("scene", scene)):
        if st is not None:
            torch.save({k: v.detach() for k, v in flatten(st).items()},
                       os.path.join(ckpt_dir, f"{name}_{iter_s}"))


def _latest(ckpt_dir: str, prefix: str):
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir) if d.startswith(prefix + "_")]
    if not cands:
        return None

    def keyf(d):
        m = re.search(r"(\d+)$", d)
        return (1, 10 ** 9) if d.endswith("final") else \
            (0, int(m.group(1)) if m else -1)
    return os.path.join(ckpt_dir, sorted(cands, key=keyf)[-1])


@torch.no_grad()
def _restore_checked(path: str, template, what: str):
    """Copies the checkpoint at `path` into `template` in place; raises
    ValueError, before copying anything, if a name is missing or a shape
    differs outside the per-frame keys."""
    want = flatten(template)
    dev = next(iter(want.values())).device
    got = torch.load(path, map_location=dev, weights_only=True)
    bad, keep = [], []
    for k, t in want.items():
        if k not in got:
            bad.append(f"{k}: missing")
        elif got[k].shape != t.shape:
            if any(p in k for p in PER_FRAME_KEYS):
                keep.append(k)
            else:
                bad.append(f"{k}: ckpt {tuple(got[k].shape)} != run "
                           f"{tuple(t.shape)}")
    if bad:
        raise ValueError(
            f"checkpoint {path} does not match the current {what} state "
            f"(different capacity/config?): " + "; ".join(bad[:5])
            + (f" (+{len(bad) - 5} more)" if len(bad) > 5 else ""))
    for k in keep:
        warnings.warn(
            f"checkpoint {what} {k}: per-frame params "
            f"{tuple(got[k].shape)} don't fit this trainer's "
            f"{tuple(want[k].shape)} (different split length); keeping "
            f"initial values — dataset SMPL parameters drive eval",
            stacklevel=3)
    for k, t in want.items():
        if k not in keep:
            t.copy_(got[k])
    return template


def load_latest(ckpt_dir: str, human=None, scene=None):
    """Restores the latest checkpoints into the given train states, in
    place. Returns (human, scene), None for a part not restored, or None
    if the directory holds no checkpoint. Raises ValueError if the latest
    checkpoint's shapes do not match the states (e.g. another capacity)."""
    h_path = _latest(ckpt_dir, "human")
    s_path = _latest(ckpt_dir, "scene")
    if h_path is None and s_path is None:
        return None
    h = s = None
    if h_path is not None and human is not None:
        h = _restore_checked(h_path, human, "human")
    if s_path is not None and scene is not None:
        s = _restore_checked(s_path, scene, "scene")
    return h, s
