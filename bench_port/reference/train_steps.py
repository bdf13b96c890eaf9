"""The reference of the trainer's first steps: the frozen plain copy
(reference/plain) driven as GaussianTrainer._train_step drives the port,
from the inputs that the benchmark made.

It works out again what the program derived from those inputs: the frame
order and split, the cameras, the scene's Gaussians from the point cloud,
the subdivided template, the avatar's rows, pose tables and distillation
targets, its nets drawn from the recipe's seed, the SH degree's one-ups,
the learning rates and the loss's draws.

The avatar's init distillation it runs itself and checks by itself: its
200 Adam steps carry round-off into a chaotic walk of the parameters
whose gradient is near zero, so that two runs of the reference on the
card already differ after them by as much as the TF32 control does
(PERF.md, section 2). The distillation loss, the reference's own, of the
program's distilled nets is held against that of its own distilled nets
(`distill`). The training steps then follow the program's state: they
start from the program's distilled nets (`nets`), which they read as the
distillation's output, and nothing else of the program's.

Everything runs in float32 with TF32 off; `tf32=True` runs the same in
TF32, the control.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_port.reference.plain.losses import basic
from bench_port.reference.plain.losses.loss import HumanSceneLoss
from bench_port.reference.plain.losses.lpips import LPIPS
from bench_port.reference.plain.models import human_gs as hgs
from bench_port.reference.plain.models import scene_gs as sgs
from bench_port.reference.plain.models.subdivide import subdivide_smpl_model
from bench_port.reference.plain.ops.graphics import camera_center
from bench_port.reference.plain.train import human_step as hst
from bench_port.reference.plain.train import joint_step as jst
from bench_port.reference.plain.train import scene_step as sst
from bench_port.reference.plain.train.budget import budget_bucket
from bench_port.reference.plain.train.optim import leaves


class Attrs(dict):
    """A dict whose keys read as attributes, nested: the learning-rate
    tables as the step modules read them."""

    def __getattr__(self, k):
        v = self[k]
        return Attrs(v) if isinstance(v, dict) else v


def data_splits(n_frames: int):
    """NeuMan's split rule (reference neuman.py:47-59): (train, val,
    test) frame lists."""
    num_val = n_frames // 5
    length = int(1 / num_val * n_frames)
    val = list(range(n_frames))[length // 2::length]
    train = sorted(set(range(n_frames)) - set(val))
    return train, val[len(val) // 2:], val[:len(val) // 2]


def dilate_mask(msk: np.ndarray, k: int = 20) -> np.ndarray:
    """k x k box dilation with cv2.dilate's anchor, the scene-mode mask
    (reference neuman.py:327)."""
    lo, hi = k // 2, k - 1 - k // 2
    out = msk
    for axis in (0, 1):
        n = out.shape[axis]
        padded = np.pad(out, [(lo, hi) if a == axis else (0, 0)
                              for a in range(2)], constant_values=-np.inf)
        acc = out
        for d in range(k):
            sl = tuple(slice(d, d + n) if a == axis else slice(None)
                       for a in range(2))
            acc = np.maximum(acc, padded[sl])
        out = acc
    return out


def frame_order(seed: int, n_train: int, n_steps: int) -> list[int]:
    """The train-split positions of the first n_steps steps, in the
    trainer's order: np.random.RandomState(seed)'s permutations."""
    rng = np.random.RandomState(seed)
    out, order, pos = [], rng.permutation(n_train), 0
    for _ in range(n_steps):
        if pos >= n_train:
            order, pos = rng.permutation(n_train), 0
        out.append(int(order[pos]))
        pos += 1
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off, or (the control) TF32 for every matrix
    product and convolution."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, basic.TF32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    basic.TF32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, basic.TF32) = flags


def leaf_tensors(human, scene) -> dict:
    """The optimizer's leaves by name, 'human.<group>[.<param>]' and
    'scene.<field>'."""
    out = {}
    if human is not None:
        for g, group in hgs.params_of(human.params).items():
            if isinstance(group, torch.nn.Module):
                for n, p in group.named_parameters():
                    out[f"human.{g}.{n}"] = p
            else:
                out[f"human.{g}"] = group
    if scene is not None:
        for k, p in sgs.params_of(scene.gs).items():
            out[f"scene.{k}"] = p
    return out


def grad_leaves(h_grads: dict | None, s_grads: dict | None, human) -> dict:
    """Gradients named as leaf_tensors names the leaves."""
    out = {}
    if h_grads is not None:
        for g, group in hgs.params_of(human.params).items():
            if isinstance(group, torch.nn.Module):
                for (n, _), t in zip(group.named_parameters(),
                                     leaves(h_grads[g])):
                    out[f"human.{g}.{n}"] = t
            else:
                out[f"human.{g}"] = h_grads[g]
    for k, t in (s_grads or {}).items():
        out[f"scene.{k}"] = t
    return out


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}


def distill_check(params, state, init_values: dict, hcfg, steps: int,
                  nets: dict, judged: tuple) -> dict:
    """The init distillation by itself: the reference's distillation
    loss of its nets as drawn ('init'), after its own `steps` steps
    ('own'), and of the program's distilled `nets` ('program') and of
    each of `judged` (name -> tensor dicts); its own distilled nets on
    the host ('own_nets'). Leaves `nets` in params."""
    targets = {k: v for k, v in init_values.items() if k != "edges"}
    named = {n: p for n, p in params.named_parameters()
             if n.split(".")[0] in hgs.NET_FIELDS}

    @torch.no_grad()
    def loss(values=None):
        for n, p in named.items():
            if values is not None:
                p.copy_(values[n].to(p.device))
        return float(hst.distill_loss(params, state, targets, hcfg).double())
    out = {"init": loss()}
    hst.distill_init(params, state, init_values, hcfg, num_steps=steps)
    out["own"] = loss()
    out["own_nets"] = {n: p.detach().cpu().clone() for n, p in named.items()}
    out["judged"] = [loss(v) for v in judged]
    out["program"] = loss(nets)
    return out


def build(recipe: dict, seq, nets: dict | None, one_ups: int, device,
          judged: tuple = ()):
    """The reference's model at the first step: the avatar from the body
    and the frames' poses, its nets drawn from a generator seeded with
    the recipe's seed, the distillation checked by itself
    (distill_check), then the program's distilled `nets` (name -> tensor)
    loaded; the scene from the point cloud as written; the SH degrees
    raised `one_ups` times. Returns (human, fixed, hcfg, scene, extent,
    train frame list, the generator, which the steps' draws continue,
    the distillation's record or None)."""
    dev = torch.device(device)
    n_frames = len(seq.images)
    train, _, _ = data_splits(n_frames)
    c2w = np.stack([camera_center(torch.as_tensor(wv)).numpy()
                    for wv in seq.world_view])
    center = c2w.mean(0, keepdims=True)
    extent = float(1.1 * np.linalg.norm(c2w - center, axis=1).max())
    mode = recipe["mode"]
    human = fixed = hcfg = scene = None
    tpu = recipe["tpu"]
    gen = torch.Generator(device=dev).manual_seed(int(recipe["seed"]))
    distill = None
    if mode in ("human", "human_scene"):
        h = recipe["human"]
        body = seq.body
        template = subdivide_smpl_model(body, smoothing=True,
                                        n_iter=h["n_subdivision"]) \
            if h["n_subdivision"] > 0 else body
        hcfg = hgs.HumanGSConfig(
            triplane_res=h["triplane_res"], use_deformer=h["use_deformer"],
            disable_posedirs=h["disable_posedirs"],
            use_surface=h["use_surface"], init_2d=h["init_2d"],
            isotropic=h["isotropic"],
            init_scale_multiplier=h["init_scale_multiplier"])
        cap = max(tpu["human_capacity"] or int(h["max_n_gaussians"]),
                  template.n_verts)
        poses = {"init_body_pose": seq.body_pose[train],
                 "init_global_orient": seq.global_orient[train],
                 "init_transl": np.zeros((len(train), 3), np.float32)}
        params, state, fixed, init_values = hgs.init_human_gs(
            gen, hcfg, body, template, np.zeros(10, np.float32), len(train),
            capacity=cap, **poses)
        if h["run_init"]:
            distill = distill_check(params, state, init_values, hcfg,
                                    h["init_steps"], nets, judged)
        for _ in range(one_ups):
            hgs.one_up_sh_degree(state, h["sh_degree"])
        human = hst.init_human_train_state(params, state)
    if mode in ("scene", "human_scene"):
        cols = np.round(seq.colors * 255).astype(np.float32) / 255.0
        cap = max(tpu["scene_capacity"] or int(recipe["scene"]
                                                ["max_n_gaussians"]),
                  seq.noisy_points.shape[0])
        degree = recipe["scene"]["sh_degree"]
        gs = sgs.create_from_pcd(seq.noisy_points, cols, cap,
                                 max_sh_degree=degree, device=dev)
        for _ in range(one_ups):
            sgs.one_up_sh_degree(gs, degree)
        scene = sst.init_scene_train_state(gs)
    return human, fixed, hcfg, scene, extent, train, gen, distill


def frame_data(seq, f: int, mode: str, device) -> dict:
    """Frame f as the trainer reads it: its camera, image and mask."""
    from bench_port.gen.neuman_sequence import camera
    dev = torch.device(device)
    msk = seq.masks[f].astype(np.float32) / 255.0
    if mode == "scene":
        msk = dilate_mask(msk, 20)
    return {"camera": camera(seq.world_view[f], seq.fov, dev),
            "width": seq.width, "height": seq.height,
            "rgb": torch.as_tensor(seq.images[f].transpose(2, 0, 1)
                                   .astype(np.float32) / 255.0, device=dev),
            "mask": torch.as_tensor(msk, device=dev)}


def reference_steps(recipe: dict, seq, lpips_arrays: dict | None,
                    n_steps: int, one_ups: int, device, nets: dict | None,
                    tf32: bool = False, judged: tuple = ()) -> dict:
    """The first n_steps steps of the trainer on the reference, the SH
    degrees raised `one_ups` times before them, from the program's
    distilled `nets` where the recipe has an avatar. Returns
    {'losses': [...], 'grad_norms': {leaf: norm of step 1's gradient},
    'change_norms': {leaf: norm of the change over the steps}, and with
    an avatar 'distill' (distill_check's record)}."""
    dev = torch.device(device)
    with precision(tf32):
        human, fixed, hcfg, scene, extent, train, gen, distill = build(
            recipe, seq, nets, one_ups, dev, judged)
        mode = recipe["mode"]
        loss_cfg = recipe["human"]["loss"] if mode != "scene" \
            else recipe["scene"]["loss"]
        loss_fn = HumanSceneLoss(
            l_ssim_w=loss_cfg["ssim_w"], l_l1_w=loss_cfg["l1_w"],
            l_lpips_w=loss_cfg.get("lpips_w", 0.0),
            l_lbs_w=loss_cfg.get("lbs_w", 0.0),
            l_humansep_w=loss_cfg.get("humansep_w", 0.0),
            num_patches=loss_cfg.get("num_patches", 4),
            patch_size=loss_cfg.get("patch_size", 128),
            use_patches=bool(loss_cfg.get("use_patches", True)))
        lpips = (LPIPS.from_arrays(lpips_arrays, True, dev)
                 if loss_fn.l_lpips_w > 0 and mode != "scene" else None)
        if human is not None:
            h = recipe["human"]
            h_static, h_sched = hst.make_human_lrs(
                Attrs(h["lr"]), optim_pose=h["optim_pose"],
                optim_betas=h["optim_betas"], optim_trans=h["optim_trans"])
        if scene is not None:
            s_static, s_sched = sst.make_scene_lrs(
                Attrs(recipe["scene"]["lr"]), extent)
        h_cap = human.params.xyz.shape[0] if human is not None else 0
        s_cap = scene.gs.capacity if scene is not None else 0
        budget = int(recipe["tpu"]["instance_budget"]) or budget_bucket(
            4 * (h_cap + s_cap))
        start = {k: v.detach().clone()
                 for k, v in leaf_tensors(human, scene).items()}
        losses, grad_norms = [], {}
        order = frame_order(int(recipe["seed"]), len(train), n_steps)
        for t_iter, idx in enumerate(order):
            data = frame_data(seq, train[idx], mode, dev)
            W, H = data["width"], data["height"]
            bg = torch.rand(3, generator=gen, device=gen.device).to(dev)
            human_bg = (torch.rand(3, generator=gen, device=gen.device)
                        .to(dev) if mode == "human_scene" else None)
            draws = loss_fn.draws(gen, H, W, mode, device=dev)
            cam, gt, mask = data["camera"], data["rgb"], data["mask"]
            if mode == "scene":
                hook = torch.zeros((s_cap, 2), device=dev,
                                   requires_grad=True)
                pkg = sst.scene_render(scene.gs, cam, bg, hook, width=W,
                                       height=H, instance_budget=budget)
                l_ = recipe["scene"]["loss"]
                loss = sst.scene_loss(pkg["render"], gt, l_["l1_w"],
                                      l_["ssim_w"])
                s_grads, hook_grad = sst.scene_grads(loss, scene.gs, hook)
                h_grads = None
                sst.scene_update(scene, s_grads, hook_grad, pkg,
                                 s_sched(t_iter), s_static, width=W,
                                 height=H)
            elif mode == "human_scene":
                js = jst.JointTrainState(human=human, scene=scene)
                hook = torch.zeros((h_cap + s_cap, 2), device=dev,
                                   requires_grad=True)
                pkg, out = jst.joint_render(
                    js, fixed, cam, bg, human_bg, hook,
                    torch.tensor(1.0, device=dev), idx, cfg=hcfg, width=W,
                    height=H, instance_budget=budget,
                    render_human_separate=loss_fn.l_humansep_w > 0)
                loss, _ = jst.joint_loss(loss_fn, draws, gt, mask, bg,
                                         human_bg, pkg, out, lpips)
                h_grads, s_grads, hook_grad = jst.joint_grads(
                    loss, js, hook, recipe["train"]["optim_scene"])
                jst.joint_update(js, h_grads, s_grads, hook_grad, pkg,
                                 h_sched(t_iter), h_static, s_sched(t_iter),
                                 s_static, width=W, height=H)
            else:
                raise ValueError(f"no reference for mode {mode!r}")
            if bool(pkg["overflowed"]):
                raise RuntimeError(f"the reference's step {t_iter} overflowed "
                                   f"its instance budget {budget}")
            losses.append(float(loss.detach().double()))
            if t_iter == 0:
                grad_norms = norms(grad_leaves(h_grads, s_grads, human))
        change = {k: v.detach() - start[k]
                  for k, v in leaf_tensors(human, scene).items()}
        out = {"losses": losses, "grad_norms": grad_norms,
               "change_norms": norms(change)}
        if distill is not None:
            out["distill"] = distill
        return out
