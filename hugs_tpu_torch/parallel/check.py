"""What the data x tile paths are held to on several ranks: the workers
that run on each rank of a group (parallel/launch.py::run_ranks), from
states and frames handed to them as numpy arrays, and the comparison of
two runs' states at the one-step bars.

The one-step bars (the joint step's against the JAX package): the first
moments atol 1e-7 + rtol 1e-4, the second atol 1e-12 + rtol 1e-4, the
parameters atol 1e-6 where the reference's first moment is beyond
rounding (1e-7), the densification statistics atol 1e-6 + rtol 1e-4,
`alive` and the step counts exact.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch import convert
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.parallel.mesh import Mesh, make_mesh
from hugs_tpu_torch.parallel.shard import render_tile_sharded
from hugs_tpu_torch.parallel.train_dp_tile import make_dp_tile_train_step
from hugs_tpu_torch.train import checkpoint as ckpt_io

STAT_KEYS = ("xyz_gradient_accum", "denom", "max_radii2d")


def snapshot(jstate) -> dict:
    """Every tensor of a JointTrainState as {'human.<name>' /
    'scene.<name>': numpy} (checkpoint.flatten's names)."""
    return {f"{side}.{k}": v.detach().cpu().numpy()
            for side, st in (("human", jstate.human), ("scene", jstate.scene))
            for k, v in ckpt_io.flatten(st).items()}


def compare_snapshots(got: dict, want: dict, p_rtol: float = 0.0) -> dict:
    """Holds snapshot `got` to `want` at the one-step bars; raises
    AssertionError naming the first entry outside them. Returns the
    largest |difference| of each kind."""
    worst = dict.fromkeys(("mu", "nu", "param", "stats"), 0.0)

    def close(kind, key, a, b, atol, rtol=0.0, where=None):
        if where is not None:
            a, b = a[where], b[where]
        bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
        if bad.any():
            raise AssertionError(f"{key}: {int(bad.sum())} entries outside "
                                 f"atol {atol} + rtol {rtol}; max |d| "
                                 f"{np.abs(a - b).max():.3e}")
        if a.size:
            worst[kind] = max(worst[kind], float(np.abs(a - b).max()))

    if set(got) != set(want):
        raise AssertionError(f"other tensors: {set(got) ^ set(want)}")
    for key, b in want.items():
        a = got[key]
        side, _, name = key.partition(".")
        if name.endswith(".step") or name.endswith("alive"):
            if not np.array_equal(a, b):
                raise AssertionError(f"{key} differs")
        elif name.startswith("opt.mu."):
            close("mu", key, a, b, 1e-7, 1e-4)
            pkey = ("human.params." if side == "human" else "scene.gs.") \
                + name[len("opt.mu."):]
            close("param", pkey, got[pkey], want[pkey], 1e-6, p_rtol,
                  np.abs(b) > 1e-7)
        elif name.startswith("opt.nu."):
            close("nu", key, a, b, 1e-12, 1e-4)
        elif name.rpartition(".")[2] in STAT_KEYS:
            close("stats", key, a, b, 1e-6, 1e-4)
    return worst


def _setup(state_np, smpl_np, cfg_kw, frames_np, device):
    """The port's (jstate, fixed, cfg, frames) of the numpy inputs."""
    jstate = convert.joint_state_from_numpy(*state_np, device=device)
    smpl = convert.smpl_model_from_numpy(smpl_np, device)
    fixed = hgs.compute_vitruvian(smpl, jstate.human.params.betas.detach())
    frames = [dict(camera=convert.camera_from_numpy(f["camera"], device),
                   rgb=torch.as_tensor(f["rgb"], device=device),
                   mask=torch.as_tensor(f["mask"], device=device),
                   bg=torch.as_tensor(f["bg"], device=device),
                   human_bg=torch.as_tensor(f["human_bg"], device=device),
                   smpl_scale=torch.tensor(1.0, device=device),
                   dataset_idx=int(f["dataset_idx"]), draws=LossDraws())
              for f in frames_np]
    return jstate, fixed, hgs.HumanGSConfig(**cfg_kw), frames


def dp_step(mesh: Mesh, state_np, smpl_np, cfg_kw, frames_np, loss_kw,
            lrs, width, height, budget, mode="human_scene",
            device="cpu") -> dict:
    """One data x tile step on `mesh` from the numpy state over the numpy
    batch (LPIPS off, so the loss draws nothing): its loss, terms,
    overflow and the state after it as a snapshot."""
    jstate, fixed, cfg, frames = _setup(state_np, smpl_np, cfg_kw,
                                        frames_np, device)
    step = make_dp_tile_train_step(mesh, fixed, cfg, width=width,
                                   height=height,
                                   loss_fn=HumanSceneLoss(**loss_kw),
                                   instance_budget=budget, mode=mode)
    _, aux = step(jstate, frames, *lrs)
    return {"loss": float(aux["loss"]),
            "loss_dict": {k: float(v) for k, v in aux["loss_dict"].items()},
            "overflowed": bool(aux["overflowed"]),
            "state": snapshot(jstate)}


def sharded_render(mesh: Mesh, scene: dict, cam_np: dict, width: int,
                   height: int, budget: int) -> np.ndarray:
    """render_tile_sharded of a numpy Gaussian set (means, scales, rotq,
    opacity, shs) on `mesh`: the gathered (3, H, W)."""
    t = {k: torch.as_tensor(v) for k, v in scene.items()}
    img = render_tile_sharded(
        t["means"], t["scales"], t["rotq"], t["opacity"], t["shs"],
        convert.camera_from_numpy(cam_np, "cpu"), width, height, mesh,
        active_sh_degree=3, instance_budget=budget)
    return img.detach().numpy()


def parity_worker(rank: int, world: int, render_args: tuple,
                  step_args: tuple, batch2: list, batch1: list) -> dict:
    """On each of 2 gloo ranks: render_tile_sharded on a (1, 2) mesh,
    one data x tile step on a (1, 2) mesh over batch1 and one on a
    (2, 1) mesh over batch2."""
    return {"render": sharded_render(make_mesh(1, 2), *render_args),
            "tile": dp_step(make_mesh(1, 2), step_args[0], step_args[1],
                            step_args[2], batch1, *step_args[3:]),
            "data": dp_step(make_mesh(2, 1), step_args[0], step_args[1],
                            step_args[2], batch2, *step_args[3:])}


def anim_frames(n: int, device="cpu", width: int = 48,
                height: int = 32) -> list:
    """n anim frames as the NeuMan anim split gives them (hugs_tpu's
    tests/test_batch.py::make_anim_frames): cameras turning about the
    body, poses drawn from RandomState(7), a manual alignment."""
    from hugs_tpu_torch.render import make_camera
    rng = np.random.RandomState(7)
    out = []
    for i in range(n):
        a = 0.15 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        out.append({
            "camera": make_camera(R, np.array([0.0, 0.2, 2.5], np.float32),
                                  0.9, 0.7, device=device),
            "width": width, "height": height,
            "global_orient": rng.randn(3).astype(np.float32) * 0.1,
            "body_pose": rng.randn(69).astype(np.float32) * 0.1,
            "betas": np.zeros(10, np.float32),
            "transl": np.array([0.0, 0.0, 0.5], np.float32),
            "smpl_scale": np.float32(1.0),
            "manual_trans": np.array([0.05, 0.0, 0.1], np.float32),
            "manual_rotmat": np.eye(3, dtype=np.float32),
            "manual_scale": np.float32(1.1)})
    return out


def small_trainer(root: str, overrides: list, mesh: Mesh):
    """A GaussianTrainer on the CPU over the NeuMan sequence `lab` under
    root, with synthetic_smpl(8), the configuration's defaults under
    `overrides`, on `mesh`."""
    from hugs_tpu_torch.cfg import load_config
    from hugs_tpu_torch.data.neuman import NeumanDataset
    from hugs_tpu_torch.models.smpl import synthetic_smpl
    from hugs_tpu_torch.train.trainer import GaussianTrainer
    cfg = load_config(None, overrides)
    train = NeumanDataset(root, "lab", "train", render_mode=cfg.mode,
                          device="cpu")
    return GaussianTrainer(cfg, train, None, device="cpu",
                           smpl_model=synthetic_smpl(8, device="cpu"),
                           mesh=mesh)


def band_demands(tr, n_bands: int) -> list[int]:
    """Each band's slot demand in the merged frame of the first training
    step (the frame the trainer visits first, at its pose row)."""
    from hugs_tpu_torch.models import scene_gs as sgs
    from hugs_tpu_torch.parallel.shard import render_band
    idx = int(np.random.RandomState(tr.cfg.seed).permutation(
        len(tr.train_dataset))[0])
    d = tr.train_dataset[idx]
    with torch.no_grad():
        h = hgs.human_forward(tr.human.params, tr.human.state, tr.fixed,
                              tr.human_cfg, smpl_scale=tr._scale(d),
                              dataset_idx=idx)
        s = sgs.scene_forward(tr.scene.gs)
        a = {k: torch.cat([h[k], s[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs", "alive")}
        return [int(render_band(
            a["xyz"], a["scales"], a["rotq"], a["opacity"], a["shs"],
            d["camera"], d["width"], d["height"], b, n_bands,
            active_sh_degree=h["active_sh_degree"], alive=a["alive"],
            instance_budget=1 << 20)["n_slots"]) for b in range(n_bands)]


def trainer_worker(rank: int, world: int, root: str, overrides: list
                   ) -> dict:
    """On each of 2 gloo ranks: a trainer on a (2, 1) mesh renders 8 anim
    frames alone in batches of 1 and split over the ranks in batches of
    8; then a trainer on a (1, 2) mesh, its band budget set between the
    two bands' demands so that one band alone overflows, takes one
    training step through train(). Returns the animate difference, the
    step's retries, budget and loss, the demands and the state after."""
    from hugs_tpu_torch.train.joint_step import JointTrainState

    tr = small_trainer(root, overrides, make_mesh(2, 1))
    tr.anim_dataset = anim_frames(8)
    alone = tr.animate(batch_size=1, mesh=Mesh())
    split = tr.animate(batch_size=8)
    anim_err = max(float((a - b).abs().max()) for a, b in zip(alone, split))

    tr = small_trainer(root, overrides, make_mesh(1, 2))
    demands = band_demands(tr, 2)
    tr._ibudget = (demands[0] + demands[1]) // 2
    budget0 = tr._ibudget
    log = tr.train()
    return {"anim_frames": len(split), "anim_err": anim_err,
            "demands": demands, "budget0": budget0, "retries": tr.retries,
            "budget": tr._ibudget, "loss": log[0]["loss"],
            "state": snapshot(JointTrainState(tr.human, tr.scene))}
