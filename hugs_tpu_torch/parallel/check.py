"""What the data x tile and Gaussian-sharded paths are held to on several
ranks: the workers that run on each rank of a group (parallel/launch.py::
run_ranks), from states and frames handed to them as numpy arrays, and
the comparison of two runs' states at the one-step bars.

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
from hugs_tpu_torch.parallel.gauss_shard import render_gauss_sharded
from hugs_tpu_torch.parallel.gauss_train import (
    gather_scene_state, gauss_densify_step, make_gauss_scene_train_step,
    shard_scene_state,
)
from hugs_tpu_torch.parallel.mesh import Mesh, make_gauss_mesh, make_mesh
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


# ------------------------------------------------------- Gaussian shard

GRAD_KEYS = ("means", "opacity", "shs")


def gauss_render(mesh: Mesh, scene: dict, cam_np: dict, width: int,
                 height: int, bg, g=None, **kw) -> dict:
    """render_gauss_sharded of a numpy Gaussian set on `mesh` (SH degree
    3): the frame, the overflow flag, frag_counts, radii and visibility;
    with g (3, H, W), this rank's gradients of sum(g x frame) / D of
    means, opacity and shs (zero outside its rows)."""
    t = {k: torch.tensor(v, requires_grad=g is not None and k in GRAD_KEYS)
         for k, v in scene.items()}
    out = render_gauss_sharded(
        t["means"], t["scales"], t["rotq"], t["opacity"], t["shs"],
        convert.camera_from_numpy(cam_np, "cpu"), width, height, mesh,
        bg=torch.as_tensor(bg), active_sh_degree=3, **kw)
    res = {"render": out["render"].detach().numpy(),
           "overflowed": bool(out["overflowed"]),
           "frag_counts": out["frag_counts"].numpy(),
           "radii": out["radii"].numpy(),
           "visibility_filter": out["visibility_filter"].numpy()}
    if g is not None:
        loss = (out["render"] * torch.as_tensor(g)).sum()
        (loss / mesh.axis_size("gauss")).backward()
        res["grads"] = {k: t[k].grad.numpy() for k in GRAD_KEYS}
    return res


def scene_state_from_numpy(state_np: dict, device="cpu"):
    """A SceneTrainState from {'gs': fields, 'mu': ..., 'nu': ...,
    'step': ...} of numpy arrays."""
    from hugs_tpu_torch.train.scene_step import SceneTrainState
    return SceneTrainState(
        gs=convert.scene_gs_from_numpy(state_np["gs"], device),
        opt=convert.adam_state_from_numpy(state_np["mu"], state_np["nu"],
                                          state_np["step"], device))


def _gs_numpy(state) -> dict:
    return {f: getattr(state.gs, f).detach().numpy() for f in STAT_KEYS
            + ("alive", "xyz", "opacity")}


def gauss_steps(mesh: Mesh, state_np: dict, cam_np: dict, target, bg,
                xyz_lrs: list, static_lrs: dict, width: int, height: int,
                budget: int, noise, extent: float, densify_kw: dict,
                n_before: int) -> dict:
    """The Gaussian-sharded scene step on `mesh` from a numpy state over
    len(xyz_lrs) steps, gauss_densify_step (noise, the same on every
    rank) after the first n_before: the losses, the densify's info, the
    whole state's statistics before the densify and after the last
    step."""
    state = shard_scene_state(scene_state_from_numpy(state_np), mesh)
    step = make_gauss_scene_train_step(mesh, width=width, height=height,
                                       local_budget=budget)
    cam = convert.camera_from_numpy(cam_np, "cpu")
    target, bg = torch.as_tensor(target), torch.as_tensor(bg)
    losses, over, out = [], [], {}
    for i, lr in enumerate(xyz_lrs):
        if i == n_before:
            out["before"] = _gs_numpy(gather_scene_state(state, mesh))
            _, info = gauss_densify_step(state, mesh, torch.tensor(noise),
                                         extent, **densify_kw)
            out["info"] = {k: int(v) for k, v in info.items()}
        state, aux = step(state, cam, target, bg, lr, static_lrs)
        losses.append(float(aux["loss"]))
        over.append(bool(aux["overflowed"]))
    out.update(losses=losses, overflowed=over,
               frag_counts=aux["frag_counts"].numpy(),
               n_visible=int(aux["n_visible"]),
               after=_gs_numpy(gather_scene_state(state, mesh)))
    return out


def gauss_trainer_checks(root: str, render_overrides: list,
                         train_overrides: list, world: int) -> dict:
    """render_frame of a human_scene trainer with tpu.gauss_shard set to
    the world and 0 (its largest difference), and a scene-mode run
    through train() with tpu.gauss_shard the world: its logged losses,
    the population before and after, and how far xyz moved."""
    tr = small_trainer(root, render_overrides, Mesh())
    d = tr.train_dataset[0]
    tr.cfg.tpu.gauss_shard = world
    pkg = tr.render_frame(d)
    tr.cfg.tpu.gauss_shard = 0
    ref = tr.render_frame(d)["render"]
    out = {"render_err": float((pkg["render"] - ref).abs().max()),
           "render_frag_counts": pkg["frag_counts"].numpy()}
    tr = small_trainer(root, train_overrides
                       + [f"tpu.gauss_shard={world}"], Mesh())
    n0 = int(tr.scene.gs.alive.sum())
    xyz0 = tr.scene.gs.xyz.detach().clone()
    log = tr.train()
    out.update(losses=[e["loss"] for e in log], n_alive=(
        n0, int(tr.scene.gs.alive.sum())), xyz_moved=float(
        (tr.scene.gs.xyz.detach() - xyz0).abs().max()),
        retries=tr.retries)
    return out


def multihost_checks(rank: int) -> dict:
    """make_hybrid_mesh's layouts, global_batch and sync_hosts."""
    from hugs_tpu_torch.parallel import multihost
    out = {"default": dict(multihost.make_hybrid_mesh().shape),
           "tile1": dict(multihost.make_hybrid_mesh(1).shape)}
    try:
        multihost.make_hybrid_mesh(3)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    frames = {"rgb": np.full((2, 3, 4, 4), rank, np.float32),
              "idx": [np.arange(2) + 2 * rank]}
    b = multihost.global_batch(frames, "cpu")
    out["batch"] = {"rgb": b["rgb"].numpy(), "idx": b["idx"][0].numpy()}
    multihost.sync_hosts()
    return out


def gauss_worker(rank: int, world: int, render_args: tuple, skew: dict,
                 step_args: tuple, root: str, render_overrides: list,
                 train_overrides: list) -> dict:
    """On each of the group's ranks, over one ('gauss',) mesh of the world:
    gauss_render of the parity scene (with gradients), at frag_cap 8 and
    of the skewed scene; gauss_steps; gauss_trainer_checks; the
    multi-host helpers; and graft_entry's dryrun steps."""
    from hugs_tpu_torch import graft_entry
    mesh = make_gauss_mesh(world)
    scene, cam_np, width, height, bg, g, budget = render_args
    return {
        "render": gauss_render(mesh, scene, cam_np, width, height, bg, g,
                               local_budget=budget),
        "overflow": gauss_render(mesh, scene, cam_np, width, height, bg,
                                 local_budget=budget, frag_cap=8),
        "skew": gauss_render(mesh, skew, cam_np, width, height, bg,
                             local_budget=budget),
        "steps": gauss_steps(mesh, *step_args),
        "trainer": gauss_trainer_checks(root, render_overrides,
                                        train_overrides, world),
        "multihost": multihost_checks(rank),
        "dryrun": graft_entry.check_dryrun(
            graft_entry.dryrun_rank(rank, world, "cpu")),
    }
