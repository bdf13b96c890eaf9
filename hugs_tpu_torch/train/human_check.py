"""One human training step's, or one joint human + scene step's, forward
and gradients on a small avatar, on any device, and the comparison of
two such runs: the card's (K1 and K2) against the CPU's (the plain
blend), from the same avatar, state and draws.

The avatar is the parity tests' size: synthetic_smpl(12) in capacity 512,
n_features 8, a 32^2 triplane, rendered at 64x48 on white, with LPIPS
patches of 32 and config[2]'s loss weights; the joint step adds a scene
of 300 points in a radius-1.5 ball (capacity 512), the humansep terms at
weight 1 and a human pass on its own background (config[3]). The bars:
the loss and each term atol 2e-5 plus rtol 2e-6, each gradient (and the
mean2d hook's) atol 1e-6 plus rtol 1e-4.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.losses.lpips import LPIPS
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.train import human_step as hst
from hugs_tpu_torch.train import joint_step as jst
from hugs_tpu_torch.train import scene_step as sst
from hugs_tpu_torch.train.optim import leaves

WIDTH, HEIGHT, CAPACITY, PATCH = 64, 48, 512, 32
LOSS_KW = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=1.0, l_lbs_w=1000.0,
               num_patches=4, patch_size=PATCH)
LOSS_ATOL, LOSS_RTOL = 2e-5, 2e-6
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _small_inputs(seed: int, joint: bool):
    """The small avatar, its draws, target, mask and camera, built on the
    CPU from `seed`: (cfg, params, state, fixed, loss_fn, draws, gt,
    mask, camera, LPIPS, scene or None)."""
    rng = np.random.default_rng(seed)
    smpl = synthetic_smpl(12, device="cpu")
    cfg = hgs.HumanGSConfig(n_features=8, triplane_res=32)
    params, state, fixed, _ = hgs.init_human_gs(
        torch.Generator().manual_seed(seed), cfg, smpl, smpl,
        np.zeros(10, np.float32), n_frames=1, capacity=CAPACITY,
        init_body_pose=(rng.normal(size=(1, 69)) * 0.2).astype(np.float32))
    loss_fn = HumanSceneLoss(**LOSS_KW,
                             l_humansep_w=1.0 if joint else 0.0)
    draws = loss_fn.draws(torch.Generator().manual_seed(seed), HEIGHT, WIDTH,
                          "human_scene" if joint else "human", device="cpu")
    gt = torch.as_tensor(rng.uniform(size=(3, HEIGHT, WIDTH))
                         .astype(np.float32))
    mask = torch.zeros((HEIGHT, WIDTH))
    mask[6:44, 16:48] = 1.0
    cam = get_rotating_camera(img_size=(HEIGHT, WIDTH), fov=0.95, dist=2.6,
                              nframes=2, device="cpu")[0]["camera"]
    scene = None
    if joint:
        pts = rng.normal(size=(300, 3))
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) \
            * rng.uniform(0.4, 1.5, (300, 1))
        scene = sgs.create_from_pcd(pts, rng.uniform(size=(300, 3)),
                                    CAPACITY, device="cpu")
    return (cfg, params, state, fixed, loss_fn, draws, gt, mask, cam,
            LPIPS.create(device="cpu"), scene)


def _host(grads: dict, hook_grad: torch.Tensor, loss, terms) -> dict:
    grads = {k: [g.cpu() for g in leaves(v)] for k, v in grads.items()}
    grads["hook"] = [hook_grad.cpu()]
    return {"loss": float(loss.detach()),
            "terms": {k: float(v.detach()) for k, v in terms.items()},
            "grads": grads}


def small_step(device, seed: int = 0) -> dict:
    """Builds the small avatar on the CPU from `seed`, moves it to
    `device` and runs human_render, human_loss and human_grads there.
    Returns the loss, the terms and the gradients ({group: [leaf]}, and
    "hook") on the CPU."""
    device = torch.device(device)
    cfg, params, state, fixed, loss_fn, draws, gt, mask, cam, lp, _ = \
        _small_inputs(seed, joint=False)
    p, s, fx, lp, cam, draws = (hgs.to_device(x, device) for x in (
        params, state, fixed, lp, cam, draws))
    ts = hst.init_human_train_state(p, s)
    hook = torch.zeros((CAPACITY, 2), device=device, requires_grad=True)
    bg = torch.ones(3, device=device)
    pkg, out = hst.human_render(ts, fx, cam, bg, hook,
                                torch.tensor(1.0, device=device), 0, cfg=cfg,
                                width=WIDTH, height=HEIGHT,
                                instance_budget=1 << 14)
    loss, terms = hst.human_loss(loss_fn, draws, gt.to(device),
                                 mask.to(device), bg, pkg, out, lp)
    grads, hook_grad = hst.human_grads(loss, p, hook)
    return _host(grads, hook_grad, loss, terms)


def small_joint_step(device, seed: int = 0) -> dict:
    """small_step's avatar with a 300-point scene, through joint_render
    (the merged frame and the human alone), joint_loss and joint_grads
    on `device`. Returns small_step's layout, the scene's parameters
    among the groups as "scene.<name>"."""
    device = torch.device(device)
    cfg, params, state, fixed, loss_fn, draws, gt, mask, cam, lp, scene = \
        _small_inputs(seed, joint=True)
    p, s, fx, lp, cam, draws, gs = (hgs.to_device(x, device) for x in (
        params, state, fixed, lp, cam, draws, scene))
    js = jst.JointTrainState(human=hst.init_human_train_state(p, s),
                             scene=sst.init_scene_train_state(gs))
    hook = torch.zeros((2 * CAPACITY, 2), device=device, requires_grad=True)
    bg = torch.ones(3, device=device)
    human_bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    pkg, out = jst.joint_render(js, fx, cam, bg, human_bg, hook,
                                torch.tensor(1.0, device=device), 0, cfg=cfg,
                                width=WIDTH, height=HEIGHT,
                                instance_budget=1 << 14,
                                render_human_separate=True)
    loss, terms = jst.joint_loss(loss_fn, draws, gt.to(device),
                                 mask.to(device), bg, human_bg, pkg, out, lp)
    h_grads, s_grads, hook_grad = jst.joint_grads(loss, js, hook)
    h_grads.update({f"scene.{k}": v for k, v in s_grads.items()})
    return _host(h_grads, hook_grad, loss, terms)


def compare_steps(got: dict, want: dict) -> dict:
    """Holds small_step's `got` to `want` at the module's bars; raises
    AssertionError naming the first value outside them. Returns the
    largest |difference| of the total, each term and each group."""
    worst = {}
    pairs = [("total", got["loss"], want["loss"])] + [
        (k, got["terms"][k], want["terms"][k]) for k in want["terms"]]
    for k, a, b in pairs:
        if not abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b):
            raise AssertionError(f"step: {k} {a} against {b}")
        worst[k] = abs(a - b)
    for k, gs in want["grads"].items():
        d = 0.0
        for a, b in zip(got["grads"][k], gs, strict=True):
            bad = ~((a - b).abs() <= GRAD_ATOL + GRAD_RTOL * b.abs())
            if bool(bad.any()):
                raise AssertionError(f"step: the gradient of {k} "
                                     f"differs in {int(bad.sum())} entries")
            d = max(d, float((a - b).abs().max()))
        worst[f"grad {k}"] = d
    return worst
