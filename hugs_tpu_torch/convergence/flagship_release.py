"""The release recipe end to end: the counterpart of
scripts/flagship_release_tpu.py.

Runs cfg_files/neuman/hugs_human_scene.yaml (14,998 joint steps of human
+ scene training at 960x540, from a body subdivided twice) through the
port's GaussianTrainer on one card, and records wall time and the
held-out metrics. The sequence stands in for NeuMan's lab at its
statistics: a striped synthetic_smpl(460) body (11,040 vertices;
subdivided twice, ~110,000 human Gaussians to start) walking through an
orbit of 104 frames at distance 3, inside a striped room of 24,000
sphere, 8,000 floor and 2 x 2,000 box points, the masks from the body's
transmittance; every 8th frame from the 5th is held out.

  ground truth  body and room rendered together on grey (0.2) through the
                tiled path (K1 on the card), the mask from the body alone
                on black and white, each render at its own slot demand
                (`build_gt`, joint_scene.gt_frame);
  model         the trainer's own: the recipe with the script's changes
                (`config`): capacities 131,072 / 131,072 (also the live
                maxima), a starting budget of 393,216 that grows (the
                trainer's automatic growth turned on), distillation 7,000
                steps, validation every 1,000 steps, LPIPS weight 0 (no
                pretrained VGG weights: the metric's LPIPS is
                uncalibrated), no anim interval;
  training      GaussianTrainer.train, its validation every 1,000 steps,
                then validate() and the novel-pose strip.

The trainer resumes from the newest checkpoint in its logdir, so every
run trains in a fresh temporary logdir (--logdir to keep one; it must be
new). `--steps N` stands in for the script's FLAGSHIP_STEPS.

Run: `python -m hugs_tpu_torch.convergence.flagship_release [--smoke]
[--device cpu] [--steps N] [--out DIR]` (DIR default
runs/flagship_release: flagship_release.json, flagship_gt.png,
flagship_fit.png, flagship_anim_strip.png). Exits 2 without a card
unless --device cpu.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.convergence import common
from hugs_tpu_torch.convergence.human_avatar import gt_splats
from hugs_tpu_torch.convergence.joint_scene import gt_frame, room_splats
from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.models.smpl import synthetic_smpl

NAME = "flagship_release"
RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cfg_files", "neuman",
    "hugs_human_scene.yaml")
# the script's sizes (flagship_release_tpu.py:60-84), and its SMOKE sizes
SIZES = dict(W=960, H=540, F=104, STEPS=14998, VPB=460, N_SUBDIV=2,
             H_CAP=131072, S_CAP=131072, IBUDGET=393216, N_SPHERE=24000,
             N_FLOOR=8000, N_BOX=2000, VAL_INTERVAL=1000, CKPT=5000,
             INIT_STEPS=7000)
SMOKE = dict(W=96, H=64, F=8, STEPS=10, VPB=4, N_SUBDIV=1, H_CAP=512,
             S_CAP=512, IBUDGET=1 << 14, N_SPHERE=128, N_FLOOR=64, N_BOX=16,
             VAL_INTERVAL=4, CKPT=4, INIT_STEPS=100, CANON_NFRAMES=4)
FOV, DIST = 0.95, 3.0
RADIUS = 4.0


def gt_poses(f, n):
    """Walking-ish articulated cycle (the script's gt_poses): swinging
    arms/legs, slight torso turn; two full gait cycles over the sequence
    so held-out frames are interpolations."""
    t = 4.0 * np.pi * f / n
    pose = np.zeros(69, np.float32)
    pose[0 * 3 + 0] = 0.45 * np.sin(t)          # L hip
    pose[1 * 3 + 0] = -0.45 * np.sin(t)         # R hip
    pose[3 * 3 + 0] = 0.55 * max(0.0, np.sin(t))    # L knee
    pose[4 * 3 + 0] = 0.55 * max(0.0, -np.sin(t))   # R knee
    pose[15 * 3 + 2] = 0.7 * np.sin(t)          # L shoulder
    pose[16 * 3 + 2] = -0.7 * np.sin(t)         # R shoulder
    pose[17 * 3 + 1] = 0.45 * np.cos(t)         # L elbow
    pose[18 * 3 + 1] = -0.45 * np.cos(t)        # R elbow
    pose[8 * 3 + 1] = 0.25 * np.sin(2 * t)      # spine twist
    pose[11 * 3 + 0] = 0.1 * np.sin(t + 1.0)    # neck nod
    orient = np.array([0.0, 0.2 * np.sin(t * 0.5), 0.0], np.float32)
    return pose, orient


def scene_points(rng, n_sphere=SIZES["N_SPHERE"], n_floor=SIZES["N_FLOOR"],
                 n_box=SIZES["N_BOX"]):
    """Textured room at NeuMan-lab point-cloud scale: bg sphere + floor
    disc + two box obstacles, all procedurally striped (the script's
    scene_points)."""
    u = rng.normal(size=(n_sphere, 3))
    sph = 6.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    r = np.sqrt(rng.uniform(0.05, 1.0, n_floor)) * 3.0
    th = rng.uniform(0, 2 * np.pi, n_floor)
    floor = np.stack([r * np.cos(th), np.full(n_floor, -1.25),
                      r * np.sin(th)], axis=1)
    boxes = []
    for cx, cz in ((1.6, 1.2), (-1.5, -1.0)):
        b = rng.uniform(-1, 1, (n_box, 3)) * [0.25, 0.45, 0.25]
        b[:, 1] += -0.8
        b[:, 0] += cx
        b[:, 2] += cz
        boxes.append(b)
    pts = np.concatenate([sph, floor] + boxes).astype(np.float32)
    col = np.stack([0.5 + 0.35 * np.sin(3.0 * pts[:, 0]),
                    0.5 + 0.35 * np.sin(2.0 * pts[:, 1] + 1.0),
                    0.5 + 0.35 * np.cos(2.5 * pts[:, 2] + 3.0)], axis=1)
    return pts, np.clip(col, 0.0, 1.0).astype(np.float32)


def bbox_of(mask: np.ndarray) -> np.ndarray:
    """The mask's box (y0, x0, y1, x1), the whole frame where it is
    empty."""
    ys, xs = np.where(mask > 0.5)
    if not ys.size:
        return np.array([0, 0, mask.shape[0] - 1, mask.shape[1] - 1],
                        np.int32)
    return np.array([ys.min(), xs.min(), ys.max(), xs.max()], np.int32)


def build_gt(smpl, sz, device):
    """The F frames in the NeumanDataset item layout, each render's slot
    demands (merged, body), the room's points and colours and the numpy
    generator after them (RandomState(0), as the script)."""
    W, H, F = sz["W"], sz["H"], sz["F"]
    rng = np.random.RandomState(0)
    spts, scol = scene_points(rng, sz["N_SPHERE"], sz["N_FLOOR"],
                              sz["N_BOX"])
    body = gt_splats(smpl)
    room = room_splats(spts, scol, device)
    cams = get_rotating_camera(img_size=(H, W), fov=FOV, dist=DIST,
                               nframes=F + 1, angle_limit=2 * np.pi,
                               device=device)[:-1]
    frames, demands = [], []
    with torch.no_grad():
        for f in range(F):
            pose, orient = gt_poses(f, F)
            rgb, mask, d = gt_frame(smpl, body, room, pose, orient,
                                    cams[f]["camera"], W, H)
            frames.append({
                "camera": cams[f]["camera"], "rgb": rgb, "mask": mask,
                "width": W, "height": H,
                "bbox": bbox_of(mask.cpu().numpy()),
                "betas": np.zeros(10, np.float32), "body_pose": pose,
                "global_orient": orient, "transl": np.zeros(3, np.float32),
                "smpl_scale": np.float32(1.0)})
            demands.append(d)
    return frames, demands, (spts, scol), rng


def datasets(frames, spts, scol, rng):
    """(train, val): every 8th frame from the 5th held out; the room's
    sparse observation (60 % of its points moved by N(0, 0.03^2), colours
    by N(0, 0.08^2)) as the scene's initial cloud."""
    F = len(frames)
    val_idx = [i for i in range(F) if i % 8 == 4]
    train_idx = [i for i in range(F) if i % 8 != 4]
    obs = rng.rand(spts.shape[0]) < 0.6
    init_pts = (spts[obs] + rng.normal(size=(obs.sum(), 3)).astype(
        np.float32) * 0.03)
    init_col = np.clip(scol[obs] + rng.normal(size=(obs.sum(), 3)).astype(
        np.float32) * 0.08, 0, 1)
    pcd = (init_pts.astype(np.float32), init_col.astype(np.float32))
    return (common.FrameList([frames[i] for i in train_idx], pcd,
                                 RADIUS),
            common.FrameList([frames[i] for i in val_idx], pcd, RADIUS))


def config(sz, steps, lpips_w, logdir):
    """The recipe with the script's changes (flagship_release_tpu.py:
    247-261)."""
    cfg = load_config(RECIPE)
    cfg.train.num_steps = steps
    cfg.train.val_interval = sz["VAL_INTERVAL"]
    cfg.train.save_ckpt_interval = sz["CKPT"]
    cfg.train.anim_interval = 0
    cfg.human.n_subdivision = sz["N_SUBDIV"]
    cfg.human.loss.lpips_w = lpips_w
    cfg.human.max_n_gaussians = sz["H_CAP"]
    cfg.scene.max_n_gaussians = sz["S_CAP"]
    cfg.tpu.human_capacity = sz["H_CAP"]
    cfg.tpu.scene_capacity = sz["S_CAP"]
    cfg.tpu.instance_budget = sz["IBUDGET"]
    cfg.human.init_steps = sz["INIT_STEPS"]
    if "CANON_NFRAMES" in sz:       # the smoke run's turntable dump
        cfg.human.canon_nframes = sz["CANON_NFRAMES"]
    cfg.logdir = logdir
    cfg.logdir_ckpt = os.path.join(logdir, "ckpt")
    for sub in ("", "train", "val", "ckpt", "anim"):
        os.makedirs(os.path.join(logdir, sub), exist_ok=True)
    return cfg


def build_trainer(cfg, ds_train, ds_val, smpl, device) -> common.Trainer:
    """The trainer (with its distillation) at the recipe's fixed starting
    budget, its automatic growth turned on."""
    trainer = common.Trainer(cfg, train_dataset=ds_train,
                              val_dataset=ds_val, smpl_model=smpl,
                              device=device)
    trainer._ibudget_fixed = False
    return trainer


def anim_strip(trainer, frame, n: int = 6) -> torch.Tensor:
    """The trained avatar in n poses between the training phases, from a
    held-out camera, side by side."""
    imgs = []
    for k in range(n):
        pose, orient = gt_poses(k + 0.5, n)
        imgs.append(trainer.render_frame(dict(frame, body_pose=pose,
                                              global_orient=orient))["render"])
    return torch.cat(imgs, dim=2)


def main(argv=None) -> int:
    args = common.parse_args(
        NAME, __doc__.splitlines()[0], argv,
        steps=(int, 0, "training steps (default: the script's 14,998, 10 "
                       "smoke)"),
        lpips=(float, 0.0, "the LPIPS loss weight (the script's "
                           "FLAGSHIP_LPIPS, default 0)"),
        logdir=(str, "", "the trainer's logdir, which must not exist "
                         "(default: a fresh temporary one)"))
    dev = common.device_of(args)
    if dev is None:
        return 2
    sz = SMOKE if args.smoke else SIZES
    steps = args.steps or sz["STEPS"]
    card = common.card_line(dev)
    print(f"# {NAME}: {sz['W']}x{sz['H']}, {sz['F']} frames, {steps} steps "
          f"[{card}]", flush=True)
    t_wall0 = common.wall(dev)
    smpl = synthetic_smpl(verts_per_bone=sz["VPB"], device=dev)
    n0 = common.launches()
    frames, demands, (spts, scol), rng = build_gt(smpl, sz, dev)
    gt_launches = common.since(n0)
    merged = [d[0] for d in demands]
    print(f"# GT: {len(frames)} frames, body {smpl.n_verts} vertices, "
          f"room {spts.shape[0]} points, mask "
          f"{np.mean([float(f['mask'].mean()) for f in frames]):.3f}; merged "
          f"slot demand {min(merged)}-{max(merged)}, each rendered at its "
          f"own; t={common.wall(dev) - t_wall0:.0f}s", flush=True)
    ds_train, ds_val = datasets(frames, spts, scol, rng)
    if args.logdir and os.path.exists(args.logdir):
        raise SystemExit(f"--logdir {args.logdir} exists: the trainer would "
                         f"resume from its checkpoints")
    tmp = None if args.logdir else tempfile.TemporaryDirectory(
        prefix="flagship_")
    logdir = args.logdir or tmp.name
    try:
        cfg = config(sz, steps, args.lpips, logdir)
        t0 = common.wall(dev)
        trainer = build_trainer(cfg, ds_train, ds_val, smpl, dev)
        setup_s = common.wall(dev) - t0
        n_h_init = int(trainer.human.state.alive.sum())
        print(f"# trainer built (with its {cfg.human.init_steps}-step "
              f"distillation): {setup_s:.1f} s; {n_h_init} human Gaussians "
              f"in capacity {sz['H_CAP']}; budget {trainer._ibudget}",
              flush=True)
        n0 = common.launches()
        t0 = common.wall(dev)
        trainer.train()
        train_s = common.wall(dev) - t0
        train_launches = common.since(n0)
        t0 = common.wall(dev)
        final = trainer.validate()
        val_s = common.wall(dev) - t0
        print(f"final metrics: {final}", flush=True)
        vf = ds_val[len(ds_val) // 2]
        common.write_png(args.out, "flagship_anim_strip.png",
                         anim_strip(trainer, ds_val[0]))
        common.write_png(args.out, "flagship_fit.png",
                         trainer.render_frame(vf)["render"])
        common.write_png(args.out, "flagship_gt.png", vf["rgb"])
    finally:
        if tmp is not None:
            tmp.cleanup()
    n_h = int(trainer.human.state.alive.sum())
    n_s = int(trainer.scene.gs.n_alive)
    loss = cfg.human.loss
    # a validation whose frames gave no human box has no human PSNR: null
    curve = [{"step": int(k), "psnr_held": round(m["hugs_psnr"], 2),
              "human_psnr_held": (round(m["hugs_human_psnr"], 2)
                                  if "hugs_human_psnr" in m else None)}
             for k, m in sorted(trainer.eval_metrics.items()) if k.isdigit()]
    record = {
        "workload": f"RELEASE recipe (hugs_human_scene.yaml): {steps} "
                    f"joint steps @ {sz['W']}x{sz['H']}, human template "
                    f"{n_h_init} -> {n_h} gaussians (cap {sz['H_CAP']}), "
                    f"scene {ds_train.init_pcd[0].shape[0]} -> {n_s} (cap "
                    f"{sz['S_CAP']}), densify+prune+SH-ramp+budget-autogrow "
                    f"active, loss l1 {loss.l1_w} + ssim {loss.ssim_w} + "
                    f"lbs {loss.lbs_w} + humansep {loss.humansep_w} + "
                    f"lpips {args.lpips}",
        "train_wall_s": train_s,
        "train_wall_min": train_s / 60,
        "wall_s": train_s,
        "setup_s": setup_s,
        "final_validate_s": val_s,
        "steps_per_s": steps / train_s,
        "final_metrics": final,
        "eval_curve": trainer.eval_metrics,
        "psnr_curve": curve,
        "device": dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "card": card,
        "steps": steps,
        "gt_slot_demand": [min(merged), max(merged)],
        "final_instance_budget": trainer._ibudget,
        "retries": trainer.retries,
        "overflow_persisted": trainer.overflow_persisted,
        "eval_retries": trainer.eval_retries,
        "launches": {"gt": gt_launches, "train_and_validate": train_launches},
        "lpips_note": "lpips_w=0 unless --lpips is set: no pretrained VGG "
                      "weights (metrics report hugs_lpips_uncalibrated)",
    }
    common.write_record(args.out, NAME, record)
    return 0 if trainer.overflow_persisted == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
