"""Joint human + scene convergence: the counterpart of
scripts/joint_scene_tpu.py.

Trains both Gaussian sets through the merged, depth-sorted render with
the release loss, L1 0.8 + SSIM 0.2 + LBS 10 + humansep 1.0 (no LPIPS),
through joint_train_step, against a synthetic monocular video: the
striped body of human_avatar.py orbited by the camera inside a static,
procedurally striped room (a background sphere of 6,000 points at radius
5 and a floor disc of 2,000, the reference's background-sphere trick,
hugs/datasets/neuman.py:246-273). The held-out (pose, view) frames
measure the joint reconstruction.

  ground truth  body and room splats rendered together on grey (0.2)
                through the tiled path (K1 on the card); the mask from
                the body alone on black and on white (`build_gt`);
  model         the avatar as in human_avatar.py, and the scene from a
                noisy observation of the room (create_from_pcd at
                capacity 8,192, SH degree 3) (`build_model`);
  training      joint_train_step with the human pass rendered separately
                on a random background each step (`train_iteration`);
  evaluation    the merged render of the held-out frames
                (render_human_scene), every VAL_EVERY steps (`eval_held`).

Random streams as in human_avatar.py; the room's points and their noise
are numpy's RandomState(0), as in the script.

Run: `python -m hugs_tpu_torch.convergence.joint_scene [--smoke]
[--device cpu] [--out DIR]` (DIR default runs/joint_scene:
joint_scene.json, joint_gt.png, joint_fit_final.png). Exits 2 without a
card unless --device cpu.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import torch

from hugs_tpu_torch.cfg import default_config
from hugs_tpu_torch.convergence import common
from hugs_tpu_torch.convergence.human_avatar import (
    DIST, FOV, SEED, build_model, gt_poses, gt_splats, split,
)
from hugs_tpu_torch.convergence.human_avatar import \
    gt_attrs as gt_attrs_of_body
from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.losses.basic import psnr
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.render.renderer import render, render_human_scene
from hugs_tpu_torch.train import joint_step as jst
from hugs_tpu_torch.train import scene_step as sst
from hugs_tpu_torch.train.budget import fit_budget
from hugs_tpu_torch.train.human_step import make_human_lrs

NAME = "joint_scene"
# the script's sizes (joint_scene_tpu.py:38-46), and its SMOKE sizes
SIZES = dict(W=512, F=24, STEPS=1500, DISTILL=1500, VAL_EVERY=250,
             N_SPHERE=6000, N_FLOOR=2000, SCENE_CAP=8192)
SMOKE = dict(W=64, F=4, STEPS=8, DISTILL=40, VAL_EVERY=4, N_SPHERE=256,
             N_FLOOR=64, SCENE_CAP=512)
VPB = 24
BG = 0.2                  # the fixed grey behind the room
SCENE_EXTENT = 5.0        # make_scene_lrs' spatial scale
LOSS = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=0.0, l_lbs_w=10.0,
            l_humansep_w=1.0, use_patches=False)


def scene_points(rng, n_sphere=SIZES["N_SPHERE"], n_floor=SIZES["N_FLOOR"]):
    """Static room: bg sphere (radius 5) + floor disc (radius 2.4,
    y=-1.25), procedurally striped (the script's scene_points)."""
    u = rng.normal(size=(n_sphere, 3))
    sph = 5.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    r = np.sqrt(rng.uniform(0.05, 1.0, n_floor)) * 2.4
    th = rng.uniform(0, 2 * np.pi, n_floor)
    floor = np.stack([r * np.cos(th), np.full(n_floor, -1.25),
                      r * np.sin(th)], axis=1)
    pts = np.concatenate([sph, floor]).astype(np.float32)
    col = np.stack([0.5 + 0.35 * np.sin(3.0 * pts[:, 0]),
                    0.5 + 0.35 * np.sin(2.0 * pts[:, 1] + 1.0),
                    0.5 + 0.35 * np.cos(2.5 * pts[:, 2] + 3.0)], axis=1)
    return pts, np.clip(col, 0.0, 1.0).astype(np.float32)


def room_splats(spts, scol, device) -> dict:
    """The room's ground-truth splats: kNN scales x 1.2, identity
    rotations, opacity 0.95, SH0 colour."""
    xyz = torch.as_tensor(spts, device=device)
    n = xyz.shape[0]
    return {"xyz": xyz, "scales": common.knn_scales(xyz, 1.2),
            "rotq": torch.tensor([1.0, 0, 0, 0], device=device).repeat(n, 1),
            "opacity": torch.full((n,), 0.95, device=device),
            "shs": torch.as_tensor(common.sh0(scol), device=device)}


def gt_attrs(smpl, body, room, pose, orient) -> tuple:
    """The ground truth's render inputs in one pose, (xyz, scales, rotq,
    opacity, shs) of the body and the room merged, body first, and of
    the body alone."""
    alone = gt_attrs_of_body(smpl, body, pose, orient)
    merged = (torch.cat([alone[0], room["xyz"]]),) + tuple(
        torch.cat([body[k], room[k]]) for k in ("scales", "rotq", "opacity",
                                                "shs"))
    return merged, alone


def gt_frame(smpl, body, room, pose, orient, camera, W, H):
    """One ground-truth frame: (the merged image on grey, the body's
    mask, the slot demands of the merged and the body's renders), each
    render at its own demand."""
    dev = room["xyz"].device
    merged, alone = gt_attrs(smpl, body, room, pose, orient)
    out, demands = [], []
    for args, bgs in ((merged, (BG,)), (alone, (0.0, 1.0))):
        d = common.probe_demand(*args, camera, W, H, active_sh_degree=0)
        demands.append(d)
        for bgv in bgs:
            pkg = render(*args, camera, W, H,
                         bg=torch.full((3,), bgv, device=dev),
                         active_sh_degree=0,
                         instance_budget=common.pages(d))
            if bool(pkg["overflowed"]):
                raise RuntimeError(f"ground truth: demand {d} overflowed")
            out.append(pkg["render"])
    full, i0, i1 = out
    mask = (torch.clamp((i1 - i0).mean(0), 0, 1) < 0.5).to(torch.float32)
    return full, mask, demands


def build_gt(smpl, W, F, sz, device):
    """(frames, per-frame demands (merged, body), the room's points and
    colours, the numpy generator after them)."""
    rng = np.random.RandomState(0)
    spts, scol = scene_points(rng, sz["N_SPHERE"], sz["N_FLOOR"])
    body = gt_splats(smpl)
    room = room_splats(spts, scol, device)
    cams = get_rotating_camera(img_size=(W, W), fov=FOV, dist=DIST,
                               nframes=F + 1, angle_limit=2 * np.pi,
                               device=device)[:-1]
    frames, demands = [], []
    with torch.no_grad():
        for f in range(F):
            pose, orient = gt_poses(f, F)
            rgb, mask, d = gt_frame(smpl, body, room, pose, orient,
                                    cams[f]["camera"], W, W)
            frames.append({"pose": torch.as_tensor(pose, device=device),
                           "orient": torch.as_tensor(orient, device=device),
                           "camera": cams[f]["camera"], "rgb": rgb,
                           "mask": mask})
            demands.append(d)
    return frames, demands, (spts, scol), rng


def build_scene(spts, scol, rng, capacity, device):
    """The scene model from a noisy observation of the room: points +
    N(0, 0.05^2), colours + N(0, 0.1^2) clipped, from the script's
    generator after the room."""
    s_init = spts + rng.normal(size=spts.shape).astype(np.float32) * 0.05
    c_init = np.clip(scol + rng.normal(size=scol.shape).astype(
        np.float32) * 0.1, 0, 1)
    return sst.init_scene_train_state(sgs.create_from_pcd(
        s_init, c_init, capacity, max_sh_degree=3, device=device))


def make_run(frames, jstate, fixed, cfg, W, budget) -> SimpleNamespace:
    """What an iteration and the evaluation read (human_avatar.make_run's
    fields, the joint state and both sets' rates)."""
    dcfg = default_config()
    h_static, h_sched = make_human_lrs(dcfg.human.lr, optim_pose=True,
                                       optim_trans=False)
    s_static, s_sched = sst.make_scene_lrs(dcfg.scene.lr, SCENE_EXTENT)
    train_i, held_i = split(len(frames))
    dev = frames[0]["rgb"].device
    return SimpleNamespace(
        frames=frames, train_i=train_i, held_i=held_i, jstate=jstate,
        fixed=fixed, cfg=cfg, h_static=h_static, h_sched=h_sched,
        s_static=s_static, s_sched=s_sched, loss_fn=HumanSceneLoss(**LOSS),
        bg=torch.full((3,), BG, device=dev), W=W, H=W,
        budget=common.pages(budget), budget_grown=0)


def setup(sz: dict, device, distill: int | None = None):
    """The ground truth and both models at sizes sz (SIZES or SMOKE), the
    distillation cut to `distill` steps where given: (run, the merged
    ground truth's slot demands). The budget starts at 1.5x the largest."""
    smpl = synthetic_smpl(verts_per_bone=VPB, device=device)
    frames, demands, (spts, scol), rng = build_gt(smpl, sz["W"], sz["F"],
                                                  sz, device)
    merged = [d[0] for d in demands]
    hstate, fixed, cfg = build_model(
        smpl, sz["F"], sz["DISTILL"] if distill is None else distill,
        device)
    jstate = jst.JointTrainState(
        human=hstate, scene=build_scene(spts, scol, rng, sz["SCENE_CAP"],
                                        device))
    return make_run(frames, jstate, fixed, cfg, sz["W"],
                    budget=max(merged) * 3 // 2), merged


def train_iteration(run, step: int, human_bg: torch.Tensor) -> dict:
    """Joint step `step` (from 1) on frame train_i[step % len], the human
    pass on human_bg: joint_train_step, its forward again at a grown
    budget where it overflowed. Returns the step's aux."""
    i = run.train_i[step % len(run.train_i)]
    fr = run.frames[i]
    _, aux = jst.joint_train_step(
        run.jstate, run.fixed, fr["camera"], fr["rgb"], fr["mask"], run.bg,
        human_bg, torch.tensor(1.0, device=run.bg.device), i, LossDraws(),
        run.h_sched(step), run.h_static, run.s_sched(step), run.s_static,
        cfg=run.cfg, loss_fn=run.loss_fn, width=run.W, height=run.H,
        instance_budget=run.budget, render_human_separate=True,
        grow_budget=True)
    run.budget_grown += aux["instance_budget"] != run.budget
    run.budget = aux["instance_budget"]
    return aux


@torch.no_grad()
def render_held(run, fr) -> torch.Tensor:
    """The merged render of a frame with its ground-truth pose."""
    js = run.jstate
    dev = run.bg.device
    h_out = hgs.human_forward(
        js.human.params, js.human.state, run.fixed, run.cfg,
        global_orient=fr["orient"], body_pose=fr["pose"],
        betas=torch.zeros(10, device=dev), transl=torch.zeros(3, device=dev),
        smpl_scale=torch.tensor(1.0, device=dev), compute_gt_lbs=False)
    s_out = sgs.scene_forward(js.scene.gs)
    data = {"camera": fr["camera"], "width": run.W, "height": run.H}

    def fwd(budget):
        return render_human_scene(data, h_out, s_out, bg_color=run.bg,
                                  render_mode="human_scene",
                                  instance_budget=budget)

    # a budget grown here serves this render alone
    return fit_budget(fwd, run.budget, "held-out render")[0]["render"]


@torch.no_grad()
def eval_held(run) -> float:
    """The mean PSNR of the held-out frames' merged renders."""
    return float(np.mean([float(psnr(render_held(run, run.frames[i]),
                                     run.frames[i]["rgb"]))
                          for i in run.held_i]))


def main(argv=None) -> int:
    args = common.parse_args(NAME, __doc__.splitlines()[0], argv)
    dev = common.device_of(args)
    if dev is None:
        return 2
    sz = SMOKE if args.smoke else SIZES
    W, F = sz["W"], sz["F"]
    card = common.card_line(dev)
    print(f"# {NAME}: {W}x{W}, {F} frames, {sz['STEPS']} steps, "
          f"distillation {sz['DISTILL']}, room {sz['N_SPHERE']} + "
          f"{sz['N_FLOOR']} in capacity {sz['SCENE_CAP']} [{card}]",
          flush=True)
    t_setup = common.wall(dev)
    n0 = common.launches()
    run, merged = setup(sz, dev)
    gt_launches = common.since(n0)          # the distillation renders none
    setup_s = common.wall(dev) - t_setup
    frames, jstate = run.frames, run.jstate
    print(f"# GT: {F} frames, mean "
          f"{np.mean([float(f['rgb'].mean()) for f in frames]):.4f}, mask "
          f"{np.mean([float(f['mask'].mean()) for f in frames]):.4f}; merged "
          f"slot demand {min(merged)}-{max(merged)}, each rendered at its "
          f"own", flush=True)

    # the launches count the held-out renders of step 0 with the others
    n0 = common.launches()
    curve = [{"step": 0, "psnr_held": round(eval_held(run), 2)}]
    eval_launches = common.since(n0)
    print(f"step 0 psnr_held {curve[0]['psnr_held']} budget "
          f"{run.budget}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t0 = common.wall(dev)
    for step in range(1, sz["STEPS"] + 1):
        hbg = torch.rand(3, generator=gen, device=dev)
        aux = train_iteration(run, step, hbg)
        if step % sz["VAL_EVERY"] == 0:
            e0 = common.launches()
            p = eval_held(run)
            for k, v in common.since(e0).items():
                eval_launches[k] += v
            curve.append({"step": step, "psnr_held": round(p, 2)})
            print(f"step {step} loss {float(aux['loss']):.4f} psnr_held "
                  f"{p:.2f} t {common.wall(dev) - t0:.0f}s", flush=True)
    wall = common.wall(dev) - t0
    total = common.since(n0)
    record = {
        "workload": f"JOINT human+scene (release loss: l1 .8 + ssim .2 + "
                    f"lbs 10 + humansep 1), {len(run.train_i)} train / "
                    f"{len(run.held_i)} held (pose, view) frames, {W}x{W}, "
                    f"{'cuda K1/K2' if dev.type == 'cuda' else 'plain'}",
        "steps_per_s": sz["STEPS"] / wall,
        "wall_s": wall,
        "setup_s": setup_s,
        "psnr_curve": curve,
        "device": dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "card": card,
        "steps": sz["STEPS"], "distill_steps": sz["DISTILL"],
        "gt_slot_demand": [min(merged), max(merged)],
        "final_budget": run.budget, "budget_grown": run.budget_grown,
        "final_scene_alive": int(jstate.scene.gs.n_alive),
        "launches": {"gt": gt_launches,
                     "train": {k: total[k] - eval_launches[k]
                               for k in total},
                     "eval": eval_launches},
    }
    common.write_record(args.out, NAME, record)
    fr = frames[run.held_i[0]]
    common.write_png(args.out, "joint_fit_final.png", render_held(run, fr))
    common.write_png(args.out, "joint_gt.png", fr["rgb"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
