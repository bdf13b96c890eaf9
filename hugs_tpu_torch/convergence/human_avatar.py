"""Human-avatar convergence: the counterpart of scripts/human_avatar_tpu.py.

Trains the full avatar (triplane and the appearance, geometry and
deformation decoders, the vitruvian canonical pose, LBS posing, learned
per-frame pose refinement) against a synthetic articulated ground truth,
striped splats glued to the posed synthetic_smpl(24) body (576
vertices), over 24 (pose, orbit camera) frames at 512x512, and measures
the PSNR of the held-out frames (i % 6 == 3) the model never trains on.

  ground truth  the splats (SH degree 0, kNN scales x 0.9, opacity 0.95)
                rendered through the tiled path (K1 on the card) on
                black and on white; the mask is the body's
                transmittance < 0.5 (`build_gt`);
  model         init_human_gs at capacity 1,024 with the deformer and no
                pose blend shapes, then distill_init (`build_model`);
  training      L1 0.8 + SSIM 0.2 + LBS 10, no LPIPS, pose optimised, a
                random background each step (`train_iteration`: one
                human_train_step given its background, its budget grown
                where a forward overflows);
  evaluation    the held-out frames with their ground-truth poses on
                black (`eval_held`) every VAL_EVERY steps, then the
                8-pose animation strip at phases between the training
                poses.

The random streams are torch.Generators seeded from the script's seed
(the nets' initialisation, then one for the backgrounds): the TPU run
drew from jax.random, so the two trajectories differ and compare as
curves, not values.

Run: `python -m hugs_tpu_torch.convergence.human_avatar [--smoke]
[--device cpu] [--out DIR]` (DIR default runs/human_avatar:
human_avatar.json with the curve, steps/s, wall time, the card's line
and K1 / K2 launches; human_gt.png, human_fit_final.png,
human_anim_strip.png). Exits 2 without a card unless --device cpu.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import torch

from hugs_tpu_torch.cfg import default_config
from hugs_tpu_torch.convergence import common
from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.losses.basic import psnr
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models.smpl import smpl_forward, synthetic_smpl
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.train import human_step as hst
from hugs_tpu_torch.train.budget import fit_budget

NAME = "human_avatar"
SEED = 0
# the script's sizes (human_avatar_tpu.py:38-43), and its SMOKE sizes
SIZES = dict(W=512, F=24, STEPS=2000, DISTILL=1500, VAL_EVERY=250)
SMOKE = dict(W=64, F=4, STEPS=30, DISTILL=60, VAL_EVERY=10)
VPB = 24                  # synthetic_smpl(24): 576 vertices
CAPACITY = 1024
FOV, DIST = 0.95, 2.6
N_ANIM = 8
LOSS = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=0.0, l_lbs_w=10.0,
            use_patches=False)


def gt_poses(f, n):
    """Smooth swing of arms/legs + slow torso twist, frame f of n (the
    script's gt_poses)."""
    t = 2.0 * np.pi * f / n
    pose = np.zeros(69, np.float32)
    pose[0 * 3 + 0] = 0.35 * np.sin(t)            # L hip swing (x)
    pose[1 * 3 + 0] = -0.35 * np.sin(t)           # R hip swing
    pose[3 * 3 + 0] = 0.5 * max(0.0, np.sin(t))   # L knee
    pose[4 * 3 + 0] = 0.5 * max(0.0, -np.sin(t))  # R knee
    pose[15 * 3 + 2] = 0.6 * np.sin(t)            # L shoulder (z)
    pose[16 * 3 + 2] = -0.6 * np.sin(t)           # R shoulder
    pose[17 * 3 + 1] = 0.4 * np.cos(t)            # L elbow
    pose[18 * 3 + 1] = -0.4 * np.cos(t)           # R elbow
    pose[8 * 3 + 1] = 0.2 * np.sin(2 * t)         # spine twist
    orient = np.array([0.0, 0.15 * np.sin(t), 0.0], np.float32)
    return pose, orient


def gt_splats(smpl, scale_mult: float = 0.9) -> dict:
    """The ground truth's splats on the body's vertices: the striped SH0
    colour, kNN scales x scale_mult, identity rotations, opacity 0.95."""
    dev = smpl.v_template.device
    vt = smpl.v_template
    n = vt.shape[0]
    col = np.clip(common.stripes(vt.detach().cpu().numpy()), 0, 1)
    return {"scales": common.knn_scales(vt, scale_mult),
            "rotq": torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1),
            "opacity": torch.full((n,), 0.95, device=dev),
            "shs": torch.as_tensor(common.sh0(col), device=dev)}


def posed(smpl, pose, orient):
    """The body's vertices in one pose (zero betas and translation)."""
    dev = smpl.v_template.device
    return smpl_forward(smpl, torch.zeros(10, device=dev),
                        torch.as_tensor(pose, device=dev),
                        torch.as_tensor(orient, device=dev),
                        torch.zeros(3, device=dev)).vertices


def gt_attrs(smpl, splats, pose, orient) -> tuple:
    """The ground truth's render inputs in one pose: (xyz, scales, rotq,
    opacity, shs)."""
    return (posed(smpl, pose, orient), splats["scales"], splats["rotq"],
            splats["opacity"], splats["shs"])


def gt_frame(smpl, splats, pose, orient, camera, W, H, budget=None):
    """One ground-truth frame: (rgb on black, mask, the slot demand). The
    budget is the frame's demand unless given; a render that overflows
    raises."""
    args = gt_attrs(smpl, splats, pose, orient) + (camera, W, H)
    xyz = args[0]
    demand = common.probe_demand(*args, active_sh_degree=0)
    budget = budget or common.pages(demand)
    imgs = []
    for bgv in (0.0, 1.0):
        pkg = render(*args, bg=torch.full((3,), bgv, device=xyz.device),
                     active_sh_degree=0, instance_budget=budget)
        if bool(pkg["overflowed"]):
            raise RuntimeError(f"ground truth: budget {budget} overflowed "
                               f"(demand {int(pkg['n_slots'])})")
        imgs.append(pkg["render"])
    t_map = torch.clamp((imgs[1] - imgs[0]).mean(0), 0.0, 1.0)
    return imgs[0], (t_map < 0.5).to(torch.float32), demand


def build_gt(smpl, W, F, device):
    """The F frames {pose, orient, camera, rgb, mask} and each frame's
    slot demand."""
    splats = gt_splats(smpl)
    cams = get_rotating_camera(img_size=(W, W), fov=FOV, dist=DIST,
                               nframes=F + 1, angle_limit=2 * np.pi,
                               device=device)[:-1]
    frames, demands = [], []
    with torch.no_grad():
        for f in range(F):
            pose, orient = gt_poses(f, F)
            rgb, mask, d = gt_frame(smpl, splats, pose, orient,
                                    cams[f]["camera"], W, W)
            frames.append({"pose": torch.as_tensor(pose, device=device),
                           "orient": torch.as_tensor(orient, device=device),
                           "camera": cams[f]["camera"], "rgb": rgb,
                           "mask": mask})
            demands.append(d)
    return frames, demands


def split(F):
    """(train frame indices, held-out frame indices): every 6th from 3."""
    return ([i for i in range(F) if i % 6 != 3],
            [i for i in range(F) if i % 6 == 3])


def build_model(smpl, F, distill, device, seed=SEED, cfg=None,
                capacity=CAPACITY):
    """(tstate, fixed, cfg): init_human_gs on the body at `capacity`, the
    frames' poses as the learned pose tables' start, nets drawn from a
    generator seeded `seed`, then `distill` steps of distill_init."""
    cfg = cfg or hgs.HumanGSConfig(use_deformer=True, disable_posedirs=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    poses = [gt_poses(f, F) for f in range(F)]
    params, state, fixed, init_values = hgs.init_human_gs(
        gen, cfg, smpl, smpl, torch.zeros(10, device=device), F,
        capacity=capacity,
        init_body_pose=torch.as_tensor(np.stack([p for p, _ in poses]),
                                       device=device),
        init_global_orient=torch.as_tensor(np.stack([o for _, o in poses]),
                                           device=device),
        init_transl=torch.zeros((F, 3), device=device))
    hst.distill_init(params, state, init_values, cfg, num_steps=distill,
                     log_every=500)
    return hst.init_human_train_state(params, state), fixed, cfg


def make_run(frames, tstate, fixed, cfg, W, budget) -> SimpleNamespace:
    """What an iteration and the evaluation read: the frames, the split,
    the model, the rates (the default configuration's human.lr, pose
    optimised), the loss, and the slot budget the training steps grow
    (train/budget.py) with the times it grew."""
    static, sched = hst.make_human_lrs(default_config().human.lr,
                                       optim_pose=True, optim_trans=False)
    train_i, held_i = split(len(frames))
    return SimpleNamespace(
        frames=frames, train_i=train_i, held_i=held_i, tstate=tstate,
        fixed=fixed, cfg=cfg, static_lrs=static, sched=sched,
        loss_fn=HumanSceneLoss(**LOSS), W=W, H=W,
        budget=common.pages(budget), budget_grown=0)


def setup(sz: dict, device, distill: int | None = None):
    """The ground truth and the model at sizes sz (SIZES or SMOKE), the
    distillation cut to `distill` steps where given: (run, the ground
    truth's slot demands). The budget starts at 1.5x the ground truth's
    largest demand."""
    smpl = synthetic_smpl(verts_per_bone=VPB, device=device)
    frames, demands = build_gt(smpl, sz["W"], sz["F"], device)
    tstate, fixed, cfg = build_model(
        smpl, sz["F"], sz["DISTILL"] if distill is None else distill,
        device)
    return make_run(frames, tstate, fixed, cfg, sz["W"],
                    budget=max(demands) * 3 // 2), demands


def train_iteration(run, step: int, bg: torch.Tensor) -> dict:
    """Training step `step` (from 1) on frame train_i[step % len], with
    the background bg: the ground truth composited over bg outside the
    mask, then human_train_step, its forward again at a grown budget
    where it overflowed. Returns the step's aux (loss, its terms, the
    binning's counts)."""
    i = run.train_i[step % len(run.train_i)]
    fr = run.frames[i]
    m = fr["mask"][None]
    gt = fr["rgb"] * m + bg[:, None, None] * (1.0 - m)
    _, aux = hst.human_train_step(
        run.tstate, run.fixed, fr["camera"], gt, fr["mask"], bg,
        torch.tensor(1.0, device=bg.device), i, LossDraws(),
        run.sched(step), run.static_lrs, cfg=run.cfg, loss_fn=run.loss_fn,
        width=run.W, height=run.H, instance_budget=run.budget,
        grow_budget=True)
    run.budget_grown += aux["instance_budget"] != run.budget
    run.budget = aux["instance_budget"]
    return aux


@torch.no_grad()
def render_posed(run, pose, orient, camera) -> torch.Tensor:
    """The model in a given pose from a camera, on black."""
    ts = run.tstate
    dev = ts.params.xyz.device
    out = hgs.human_forward(ts.params, ts.state, run.fixed, run.cfg,
                            global_orient=torch.as_tensor(orient, device=dev),
                            body_pose=torch.as_tensor(pose, device=dev),
                            betas=torch.zeros(10, device=dev),
                            transl=torch.zeros(3, device=dev),
                            smpl_scale=torch.tensor(1.0, device=dev),
                            compute_gt_lbs=False)

    def fwd(budget):
        return render(out["xyz"], out["scales"], out["rotq"],
                      out["opacity"], out["shs"], camera, run.W, run.H,
                      bg=torch.zeros(3, device=dev), alive=out["alive"],
                      active_sh_degree=out["active_sh_degree"],
                      instance_budget=budget)

    # a budget grown here serves this render alone
    return fit_budget(fwd, run.budget, "held-out render")[0]["render"]


@torch.no_grad()
def eval_held(run) -> float:
    """The mean PSNR of the held-out frames, each rendered with its
    ground-truth pose on black (the reference's val path takes the
    dataset's SMPL parameters, gs_trainer.py:469-505)."""
    ps = []
    for i in run.held_i:
        fr = run.frames[i]
        img = render_posed(run, fr["pose"], fr["orient"], fr["camera"])
        ps.append(float(psnr(img, fr["rgb"])))
    return float(np.mean(ps))


def anim_strip(run, n: int = N_ANIM) -> torch.Tensor:
    """The trained avatar in n poses between the training phases, from
    frame 0's camera, side by side (3, H, n W)."""
    cam0 = run.frames[0]["camera"]
    return torch.cat([render_posed(run, *gt_poses(a + 0.5, n), cam0)
                      for a in range(n)], dim=2)


def main(argv=None) -> int:
    args = common.parse_args(NAME, __doc__.splitlines()[0], argv)
    dev = common.device_of(args)
    if dev is None:
        return 2
    sz = SMOKE if args.smoke else SIZES
    W, F = sz["W"], sz["F"]
    card = common.card_line(dev)
    print(f"# {NAME}: {W}x{W}, {F} frames, {sz['STEPS']} steps, "
          f"distillation {sz['DISTILL']} [{card}]", flush=True)
    t_setup = common.wall(dev)
    n0 = common.launches()
    run, demands = setup(sz, dev)
    gt_launches = common.since(n0)          # the distillation renders none
    setup_s = common.wall(dev) - t_setup
    frames = run.frames
    print(f"# GT: {F} frames, mean "
          f"{np.mean([float(f['rgb'].mean()) for f in frames]):.4f}, mask "
          f"{np.mean([float(f['mask'].mean()) for f in frames]):.4f}; slot "
          f"demand {min(demands)}-{max(demands)}, each rendered at its own",
          flush=True)

    # the launches count the held-out renders of step 0 with the others
    n0 = common.launches()
    curve = [{"step": 0, "psnr_held": round(eval_held(run), 2)}]
    eval_launches = common.since(n0)
    print(f"step 0 psnr_held {curve[0]['psnr_held']} budget "
          f"{run.budget}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t0 = common.wall(dev)
    for step in range(1, sz["STEPS"] + 1):
        bg = torch.rand(3, generator=gen, device=dev)
        aux = train_iteration(run, step, bg)
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
    train_launches = {k: total[k] - eval_launches[k] for k in total}
    train_i, held_i = run.train_i, run.held_i
    record = {
        "workload": f"HUGS avatar (triplane+LBS+pose-refine), "
                    f"{len(train_i)} train / {len(held_i)} held "
                    f"(pose, view) frames, {W}x{W}, "
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
        "gt_slot_demand": [min(demands), max(demands)],
        "final_budget": run.budget, "budget_grown": run.budget_grown,
        "launches": {"gt": gt_launches, "train": train_launches,
                     "eval": eval_launches},
    }
    common.write_record(args.out, NAME, record)
    fr = frames[held_i[0]]
    common.write_png(args.out, "human_fit_final.png",
                     render_posed(run, fr["pose"], fr["orient"],
                                  fr["camera"]))
    common.write_png(args.out, "human_gt.png", fr["rgb"])
    common.write_png(args.out, "human_anim_strip.png", anim_strip(run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
