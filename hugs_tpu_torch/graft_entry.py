"""The port's driver hooks (the counterpart of the repository's
__graft_entry__.py, which stays the JAX package's):

  entry()             -> (fn, example_args): the forward step on the
                         flagship model, the avatar posed and merged
                         with the scene in one render;
  dryrun_multichip(n) -> two steps on n ranks (parallel/launch.py::
                         run_ranks; NCCL with one card each, gloo on the
                         CPU): the data x tile joint step with the release
                         loss at 256x256 on a factor_devices(n) mesh, then
                         one Gaussian-sharded scene step on a ('gauss',)
                         mesh of the n ranks; asserts both losses finite
                         and the parameters moved.

  python -m hugs_tpu_torch.graft_entry [--device cuda|cpu] [-n N]

runs entry()'s fn once and dryrun_multichip(N) (N the cards, default).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.losses.lpips import LPIPS
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.parallel.collectives import pmax
from hugs_tpu_torch.parallel.gauss_train import (
    make_gauss_scene_train_step, shard_scene_state,
)
from hugs_tpu_torch.parallel.launch import run_ranks
from hugs_tpu_torch.parallel.mesh import (
    factor_devices, make_gauss_mesh, make_mesh,
)
from hugs_tpu_torch.parallel.train_dp_tile import make_dp_tile_train_step
from hugs_tpu_torch.render import make_camera
from hugs_tpu_torch.render.renderer import render_human_scene
from hugs_tpu_torch.train.human_step import (
    init_human_train_state, make_human_lrs,
)
from hugs_tpu_torch.train.joint_step import JointTrainState
from hugs_tpu_torch.train.scene_step import (
    init_scene_train_state, make_scene_lrs,
)

DRYRUN_TIMEOUT = 600.0


def _build_models(seed: int, verts_per_bone: int, human_capacity: int,
                  scene_n: int, scene_capacity: int, triplane_res: int,
                  n_features: int, device, n_frames: int = 4):
    """The avatar on synthetic_smpl and a uniform scene cloud in
    [-3, 3]^3 + 4 z, from `seed`: (cfg, params, state, fixed, scene)."""
    smpl = synthetic_smpl(verts_per_bone, device=device)
    cfg = hgs.HumanGSConfig(n_features=n_features, triplane_res=triplane_res,
                            use_deformer=True, disable_posedirs=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, state, fixed, _ = hgs.init_human_gs(
        gen, cfg, smpl, smpl, np.zeros(10, np.float32), n_frames,
        capacity=human_capacity)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-3.0, 3.0, (scene_n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    colors = rng.uniform(size=(scene_n, 3)).astype(np.float32)
    scene = sgs.create_from_pcd(pts, colors, scene_capacity, device=device)
    return cfg, params, state, fixed, scene


def entry(device: torch.device | str = "cuda"):
    """The forward step: pose the avatar, activate the scene, render the
    merged human + scene image at 480x270 (verts_per_bone 256, human
    capacity 8,192, 16,384 scene points, a 128^2 triplane of 32
    features). Returns (fn, example_args); fn(h_params, scene_gs,
    camera, smpl_scale, dataset_idx) gives the image (3, 270, 480)."""
    W, H = 480, 270
    cfg, h_params, h_state, fixed, scene = _build_models(
        0, verts_per_bone=256, human_capacity=8192, scene_n=16384,
        scene_capacity=16384, triplane_res=128, n_features=32,
        device=device)
    camera = make_camera(np.eye(3, dtype=np.float32),
                         np.array([0.0, 0.2, 2.5], np.float32), 0.9, 0.6,
                         device=device)
    black = torch.zeros(3, device=device)

    @torch.no_grad()
    def fn(h_params, scene_gs, camera, smpl_scale, dataset_idx):
        h_out = hgs.human_forward(h_params, h_state, fixed, cfg,
                                  smpl_scale=smpl_scale,
                                  dataset_idx=dataset_idx,
                                  compute_gt_lbs=False)
        s_out = sgs.scene_forward(scene_gs)
        pkg = render_human_scene(
            {"camera": camera, "width": W, "height": H}, h_out, s_out,
            bg_color=black,
            render_mode="human_scene", instance_budget=1 << 17)
        return pkg["render"]

    example_args = (h_params, scene, camera,
                    torch.tensor(1.0, device=device), 0)
    return fn, example_args


def dryrun_rank(rank: int, world: int, device_type: str = "cuda") -> dict:
    """dryrun_multichip's two steps on this rank of `world` (the process
    group joined). Returns the losses and the largest moves."""
    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    n_data, n_tile = factor_devices(world)
    mesh = make_mesh(n_data, n_tile)
    W, H = 256, 256
    cfg, h_params, h_state, fixed, scene = _build_models(
        0, verts_per_bone=16, human_capacity=512, scene_n=512,
        scene_capacity=512, triplane_res=32, n_features=8, device=dev,
        n_frames=n_data)
    xyz0 = h_params.xyz.detach().clone()
    jstate = JointTrainState(human=init_human_train_state(h_params, h_state),
                             scene=init_scene_train_state(scene))
    # the release loss (cfg_files/neuman/hugs_human_scene.yaml)
    loss_fn = HumanSceneLoss(l_l1_w=0.8, l_ssim_w=0.2, l_lpips_w=1.0,
                             l_lbs_w=1000.0, l_humansep_w=1.0,
                             use_patches=True, num_patches=4, patch_size=128)
    step = make_dp_tile_train_step(mesh, fixed, cfg, width=W, height=H,
                                   loss_fn=loss_fn,
                                   lpips=LPIPS.create(None, device=dev),
                                   instance_budget=1 << 14)
    dcfg = load_config(None)
    h_static, h_sched = make_human_lrs(dcfg.human.lr)
    s_static, s_sched = make_scene_lrs(dcfg.scene.lr, 1.0)
    rng = np.random.RandomState(1)
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = []
    for i in range(n_data):
        frames.append(dict(
            camera=make_camera(np.eye(3, dtype=np.float32),
                               np.array([0.1 * i, 0.2, 2.5], np.float32),
                               0.9, 0.9, device=dev),
            rgb=torch.as_tensor(rng.uniform(size=(3, H, W)).astype(
                np.float32), device=dev),
            mask=torch.as_tensor((rng.uniform(size=(H, W)) > 0.3).astype(
                np.float32), device=dev),
            bg=torch.ones(3, device=dev), human_bg=torch.ones(3, device=dev),
            smpl_scale=torch.tensor(1.0, device=dev), dataset_idx=i,
            draws=loss_fn.draws(gen, H, W, "human_scene", device=dev)))
    _, aux = step(jstate, frames, h_sched(0), h_static, s_sched(0), s_static)
    loss = float(aux["loss"])
    delta = float((jstate.human.params.xyz.detach() - xyz0).abs().max())

    # the second axis: one Gaussian-sharded scene step over the ranks
    # (the scene's rows padded to a multiple of the ranks)
    gmesh = make_gauss_mesh(world)
    gscene = sgs.compact(scene, bucket=-(-512 // world) * world)
    gstate = shard_scene_state(init_scene_train_state(gscene), gmesh)
    gxyz0 = gstate.gs.xyz.detach().clone()
    gstep = make_gauss_scene_train_step(gmesh, width=128, height=128,
                                        local_budget=1024)
    gstate, gaux = gstep(gstate, frames[0]["camera"],
                         frames[0]["rgb"][:, :128, :128], frames[0]["bg"],
                         s_sched(0), s_static)
    gdelta = pmax((gstate.gs.xyz.detach() - gxyz0).abs().max(), gmesh,
                  "gauss")
    return {"mesh": (n_data, n_tile), "loss": loss, "delta": delta,
            "gauss_ranks": world, "gauss_loss": float(gaux["loss"]),
            "gauss_delta": float(gdelta),
            "frag_counts": gaux["frag_counts"].cpu().numpy()}


def check_dryrun(result: dict) -> dict:
    """Raises AssertionError unless both losses are finite and both
    steps moved their parameters. Returns result."""
    for k in ("loss", "gauss_loss"):
        if not np.isfinite(result[k]):
            raise AssertionError(f"dryrun {k} not finite: {result[k]}")
    for k in ("delta", "gauss_delta"):
        if not (np.isfinite(result[k]) and result[k] > 0):
            raise AssertionError(f"dryrun: the parameters did not move "
                                 f"({k} {result[k]})")
    return result


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     timeout: float = DRYRUN_TIMEOUT) -> list:
    """Both steps on n_devices ranks (NCCL with one card each for cuda,
    gloo for cpu), checked on every rank. Returns each rank's result."""
    results = run_ranks(dryrun_rank, n_devices, (device_type,),
                        backend="nccl" if device_type == "cuda" else "gloo",
                        timeout=timeout)
    for r in results:
        check_dryrun(r)
    r = results[0]
    print(f"dryrun_multichip({n_devices}): mesh={r['mesh']} 256x256 "
          f"release-loss loss={r['loss']:.5f} max|dxyz|={r['delta']:.2e}; "
          f"gauss-shard({r['gauss_ranks']}) scene step "
          f"loss={r['gauss_loss']:.5f} OK")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("-n", type=int, default=0,
                    help="ranks of the dryrun (default: the cards, or 1)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry:", tuple(out.shape), float(out.mean()))
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 1)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
