"""Surface-scene convergence: the counterpart of scripts/surface_scene.py.

Multi-view reconstruction of a surface-like synthetic scene, ~28,000
ground-truth Gaussians (a bumpy striped sphere, a checkered floor and a
sky dome, `gt_surface_scene`), 40 training views and 4 held-out views
(every 11th) at 960x540 from an orbit at distance 3, trained in scene
mode through the port's GaussianTrainer with the automatic slot budget
(tpu.instance_budget 0: a step that overflows is rendered again at a
grown budget) and densification until step 3,000, without an opacity
reset (the script's config, surface_scene.py:155-176). The held-out
PSNR comes from the trainer's validation every VAL_EVERY steps
(`trainer.eval_metrics`), then a last validate().

  ground truth  the splats rendered through the tiled path (K1 on the
                card) on black, each view at its own slot demand
                (`build_gt`);
  model         create_from_pcd of 5,000 ground-truth points picked and
                moved by N(0, 0.03^2) with grey colours (`build_trainer`),
                capacity 65,536, at most 60,000 live;
  training      GaussianTrainer.train, its validation every VAL_EVERY
                steps, then validate() (`curve_of` reads the curve).

The record adds final_alive and final_instance_budget, as the script's,
and the trainer's retries (steps rendered again at a grown budget) and
steps whose overflow persisted (none may).

Run: `python -m hugs_tpu_torch.convergence.surface_scene [--smoke]
[--device cpu] [--out DIR]` (DIR default
runs/surface_scene: surface_scene.json, surface_gt.png,
surface_fit_final.png). The script has no SMOKE size; --smoke here is
64x36, 11 views (1 held), every 4th ground-truth Gaussian, 8 steps,
capacity 8,192. Exits 2 without a card unless --device cpu.
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from hugs_tpu_torch.cfg import default_config
from hugs_tpu_torch.convergence import common
from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.render.renderer import render

NAME = "surface_scene"
# the script's sizes (surface_scene.py:35-37, :137-176)
SIZES = dict(W=960, H=540, VIEWS=44, STEPS=4000, VAL_EVERY=250,
             CAPACITY=65536, MAX_N=60000, DENSIFY_UNTIL=3000)
SMOKE = dict(W=64, H=36, VIEWS=11, STEPS=8, VAL_EVERY=4, CAPACITY=8192,
             MAX_N=8192, DENSIFY_UNTIL=3000, THIN=4)
FOV, DIST = 0.95, 3.0
N_INIT = 5000
RADIUS = 4.6


def gt_surface_scene(seed=0):
    """~28k Gaussians: bumpy striped sphere (r=1 @ origin) + checkered
    floor plane (y=-1.05) + enclosing sky dome (r=7) (the script's
    gt_surface_scene, as numpy arrays (xyz, scales, rotq, opacity, shs)).

    The dome matters: training uses a random background colour per step
    (reference gs_trainer.py:254), and a ground truth with open black sky
    is ill-posed under that loss."""
    rng = np.random.RandomState(seed)
    # fibonacci sphere
    n_s = 12000
    i = np.arange(n_s) + 0.5
    phi = np.arccos(1 - 2 * i / n_s)
    theta = np.pi * (1 + 5 ** 0.5) * i
    bump = 1.0 + 0.06 * np.sin(6 * phi) * np.cos(5 * theta) \
        + 0.02 * rng.randn(n_s)
    xyz_s = np.stack([np.cos(theta) * np.sin(phi) * bump,
                      np.cos(phi) * bump,
                      np.sin(theta) * np.sin(phi) * bump], axis=1)
    col_s = np.stack([0.5 + 0.45 * np.sin(8 * theta),
                      0.5 + 0.45 * np.cos(6 * phi),
                      0.35 + 0.3 * np.sin(3 * phi + 2 * theta)], axis=1)
    # floor: grid on y = -1.05, extent [-2.2, 2.2] x [-2.2, 2.2]
    n_f = 100
    gx, gz = np.meshgrid(np.linspace(-2.2, 2.2, n_f),
                         np.linspace(-2.2, 2.2, n_f))
    xyz_f = np.stack([gx.ravel(), np.full(n_f * n_f, -1.05),
                      gz.ravel()], axis=1)
    checker = ((np.floor(gx.ravel() * 2) + np.floor(gz.ravel() * 2))
               % 2).astype(np.float32)
    col_f = np.stack([0.15 + 0.7 * checker,
                      0.25 + 0.5 * checker,
                      0.55 - 0.3 * checker], axis=1)
    # sky dome: fibonacci sphere r=7 around the origin (cameras orbit at
    # dist 3), soft vertical gradient + broad colour blotches
    n_d = 6000
    j = np.arange(n_d) + 0.5
    phi_d = np.arccos(1 - 2 * j / n_d)
    th_d = np.pi * (1 + 5 ** 0.5) * j
    xyz_d = 7.0 * np.stack([np.cos(th_d) * np.sin(phi_d),
                            np.cos(phi_d),
                            np.sin(th_d) * np.sin(phi_d)], axis=1)
    up = np.cos(phi_d)                        # +1 zenith .. -1 nadir
    col_d = np.stack([0.25 + 0.15 * np.sin(2 * th_d) + 0.1 * up,
                      0.35 + 0.25 * up,
                      0.55 + 0.3 * up], axis=1)

    xyz = np.concatenate([xyz_s, xyz_f, xyz_d]).astype(np.float32)
    col = np.clip(np.concatenate([col_s, col_f, col_d]), 0.0, 1.0).astype(
        np.float32)
    n = xyz.shape[0]
    scales = np.full((n, 3), 0.022, np.float32)
    scales[n_s:n_s + n_f * n_f] *= 1.6       # floor splats a bit larger
    scales[n_s + n_f * n_f:] = 0.30          # dome splats: ~2x point spacing
    rotq = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opacity = np.full(n, 0.92, np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0, :] = (col - 0.5) / 0.28209479177387814
    return xyz, scales, rotq, opacity, shs


def build_gt(gt, W, H, views, device):
    """The views' frames {camera, width, height, ..., rgb, mask (ones)}
    on black, each at its own slot demand, and the demands."""
    g = tuple(torch.as_tensor(a, device=device) for a in gt)
    cams = get_rotating_camera(img_size=(H, W), fov=FOV, dist=DIST,
                               nframes=views + 1, angle_limit=2 * np.pi,
                               device=device)[:-1]
    frames, demands = [], []
    with torch.no_grad():
        for c in cams:
            d = common.probe_demand(*g, c["camera"], W, H,
                                    active_sh_degree=0)
            pkg = render(*g, c["camera"], W, H,
                         bg=torch.zeros(3, device=device),
                         active_sh_degree=0,
                         instance_budget=common.pages(d))
            if bool(pkg["overflowed"]):
                raise RuntimeError(f"ground truth: demand {d} overflowed")
            frames.append({**c, "rgb": pkg["render"],
                           "mask": torch.ones((H, W), device=device)})
            demands.append(d)
    return frames, demands


def split(frames):
    """(train, held): every 11th view from the 11th held out."""
    return ([f for i, f in enumerate(frames) if i % 11 != 10],
            [f for i, f in enumerate(frames) if i % 11 == 10])


def init_cloud(gt_xyz):
    """The noisy subsample of the ground truth's points the scene starts
    from (numpy RandomState(1), as the script)."""
    rng = np.random.RandomState(1)
    sel = rng.choice(len(gt_xyz), N_INIT, replace=False)
    pts = (gt_xyz[sel] + 0.03 * rng.randn(N_INIT, 3)).astype(np.float32)
    return pts, np.full((N_INIT, 3), 0.5, np.float32)


def config(sz, steps, logdir):
    """The script's trainer configuration at the run's sizes."""
    cfg = default_config()
    cfg.mode = "scene"
    cfg.seed = 0
    cfg.train.num_steps = steps
    cfg.train.val_interval = sz["VAL_EVERY"]
    cfg.train.save_ckpt_interval = 10 ** 9
    cfg.train.anim_interval = 0
    cfg.scene.densify_until_iter = sz["DENSIFY_UNTIL"]
    # no opacity reset: its transient dip would hide what this run shows
    cfg.scene.opacity_reset_interval = 10 ** 9
    cfg.scene.max_n_gaussians = sz["MAX_N"]
    cfg.tpu.scene_capacity = sz["CAPACITY"]
    cfg.tpu.instance_budget = 0          # automatic: grow and retry
    cfg.logdir = logdir
    cfg.logdir_ckpt = ""
    return cfg


def build_trainer(frames, gt_xyz, sz, steps, logdir, device):
    train, held = split(frames)
    tds = common.FrameList(train, init_pcd=init_cloud(gt_xyz), radius=RADIUS)
    return common.Trainer(config(sz, steps, logdir), tds,
                           common.FrameList(held), device=device)


def curve_of(trainer, final: dict, steps: int) -> list:
    """The held-out PSNR at each validation, then the final one; a
    validation without it raises."""
    curve = [{"step": int(k), "psnr_held": round(m["hugs_psnr"], 2)}
             for k, m in sorted(trainer.eval_metrics.items())
             if k.isdigit()]
    return curve + [{"step": steps,
                     "psnr_held": round(final["hugs_psnr"], 2)}]


def main(argv=None) -> int:
    args = common.parse_args(NAME, __doc__.splitlines()[0], argv)
    dev = common.device_of(args)
    if dev is None:
        return 2
    sz = SMOKE if args.smoke else SIZES
    steps = sz["STEPS"]
    W, H = sz["W"], sz["H"]
    card = common.card_line(dev)
    print(f"# {NAME}: {W}x{H}, {sz['VIEWS']} views, {steps} steps [{card}]",
          flush=True)
    gt = tuple(a[::sz.get("THIN", 1)] for a in gt_surface_scene())
    n0 = common.launches()
    frames, demands = build_gt(gt, W, H, sz["VIEWS"], dev)
    gt_launches = common.since(n0)
    print(f"# GT: {len(frames)} views, {gt[0].shape[0]} Gaussians, slot "
          f"demand {min(demands)}-{max(demands)}, each rendered at its own",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="surface_") as logdir:
        trainer = build_trainer(frames, gt[0], sz, steps, logdir, dev)
        print(f"# starting budget {trainer._ibudget} (automatic)",
              flush=True)
        n0 = common.launches()
        t0 = common.wall(dev)
        log = trainer.train()
        wall = common.wall(dev) - t0
        train_launches = common.since(n0)
        final = trainer.validate()
    record = {
        "workload": f"surface scene (sphere+floor, {gt[0].shape[0]} GT), "
                    f"{len(split(frames)[0])} views {W}x{H}, "
                    f"{'cuda K1/K2' if dev.type == 'cuda' else 'plain'}, "
                    f"budget AUTO",
        "steps_per_s": steps / wall,
        "wall_s": wall,
        "final_alive": int(trainer.scene.gs.n_alive),
        "final_instance_budget": trainer._ibudget,
        "psnr_curve": curve_of(trainer, final, steps),
        "device": dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "card": card,
        "steps": steps,
        "gt_slot_demand": [min(demands), max(demands)],
        "retries": trainer.retries,
        "overflow_persisted": trainer.overflow_persisted,
        "eval_retries": trainer.eval_retries,
        "final_loss": log[-1]["loss"] if log else None,
        "losses_finite": bool(all(np.isfinite(r["loss"]) for r in log)),
        "launches": {"gt": gt_launches, "train_and_validate": train_launches},
    }
    common.write_record(args.out, NAME, record)
    held = split(frames)[1]
    pkg = trainer.render_frame(held[0], bg=torch.zeros(3, device=dev))
    common.write_png(args.out, "surface_fit_final.png", pkg["render"])
    common.write_png(args.out, "surface_gt.png", held[0]["rgb"])
    return 0 if trainer.overflow_persisted == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
