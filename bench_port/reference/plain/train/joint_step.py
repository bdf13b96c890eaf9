"""Joint human + scene training step (cfg_files/neuman/hugs_human_scene.yaml).

Both Gaussian sets train through one merged render (reference
gs_trainer.py:218-351 in the human_scene mode): the human set first,
then the scene's, in one depth-sorted blend (K1 forward, K2 backward on
the card), an optional second render of the human alone for the
humansep terms, HumanSceneLoss in the human_scene mode, Adam over both
sets' groups, and the merged mean2d hook's gradient split back, human
rows first, into each set's densification statistics.

The stages are separate functions (`joint_render`, `joint_loss`,
`joint_grads`, `joint_update`), which the caller runs in order, in place
on both states. The loss's random
draws (`LossDraws`) come from the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference.plain.losses.loss import HumanSceneLoss, LossDraws
from bench_port.reference.plain.models import human_gs as hgs
from bench_port.reference.plain.models import scene_gs as sgs
from bench_port.reference.plain.render.camera import Camera
from bench_port.reference.plain.render.renderer import render_human_scene
from bench_port.reference.plain.train.human_step import HumanTrainState
from bench_port.reference.plain.train.optim import group_adam_update, leaves, pack
from bench_port.reference.plain.train.scene_step import SceneTrainState


class JointTrainState(NamedTuple):
    human: HumanTrainState
    scene: SceneTrainState


def joint_render(jstate: JointTrainState, fixed: hgs.HumanGSFixed,
                 camera: Camera, bg: torch.Tensor, human_bg: torch.Tensor,
                 hook: torch.Tensor, smpl_scale, dataset_idx, *,
                 cfg: hgs.HumanGSConfig, width: int, height: int,
                 instance_budget: int = 0,
                 render_human_separate: bool = False, between=None):
    """human_forward, scene_forward, then the merged render with the
    (h_cap + s_cap, 2) mean2d hook and, with render_human_separate, the
    human alone on human_bg (half the budget); the budget defaults to 4x
    both capacities. `between`, where given, is called after
    human_forward (a timing mark). Returns (pkg, human_forward's dict)."""
    h_out = hgs.human_forward(jstate.human.params, jstate.human.state, fixed,
                              cfg, smpl_scale=smpl_scale,
                              dataset_idx=dataset_idx)
    if between is not None:
        between()
    s_out = sgs.scene_forward(jstate.scene.gs)
    pkg = render_human_scene(
        {"camera": camera, "width": width, "height": height}, h_out, s_out,
        bg_color=bg, human_bg_color=human_bg, render_mode="human_scene",
        render_human_separate=render_human_separate, mean2d_grad_hook=hook,
        instance_budget=instance_budget or 4 * hook.shape[0])
    return pkg, h_out


def joint_loss(loss_fn: HumanSceneLoss, draws: LossDraws,
               gt_image: torch.Tensor, gt_mask: torch.Tensor,
               bg: torch.Tensor, human_bg: torch.Tensor, pkg: dict,
               h_out: dict, lpips=None):
    """The loss in the human_scene mode; lpips (an LPIPS module)
    replaces the loss_fn's own where given. Returns (total, loss_dict)."""
    lf = loss_fn._replace(lpips=lpips) if lpips is not None else loss_fn
    total, loss_dict, _ = lf(draws, {"rgb": gt_image, "mask": gt_mask}, pkg,
                             h_out, render_mode="human_scene", bg_color=bg,
                             human_bg_color=human_bg)
    return total, loss_dict


def joint_grads(loss: torch.Tensor, jstate: JointTrainState,
                hook: torch.Tensor, optim_scene: bool = True):
    """d(loss)/d(each human group), d(loss)/d(each scene parameter) (None
    unless optim_scene) and d(loss)/d(hook). A parameter the loss does
    not reach gets zeros."""
    h_groups = hgs.params_of(jstate.human.params)
    s_params = sgs.params_of(jstate.scene.gs) if optim_scene else {}
    h_flat = leaves(h_groups)
    s_flat = list(s_params.values())
    got = torch.autograd.grad(loss, h_flat + s_flat + [hook],
                              allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(h_flat + s_flat, got[:-1])] + [got[-1]]
    h_grads = pack(h_groups, got[:len(h_flat)])
    s_grads = (dict(zip(s_params, got[len(h_flat):-1])) if optim_scene
               else None)
    return h_grads, s_grads, got[-1]


@torch.no_grad()
def joint_update(jstate: JointTrainState, h_grads: dict, s_grads: dict | None,
                 hook_grad: torch.Tensor, pkg: dict, human_xyz_lr,
                 human_static_lrs: dict, scene_xyz_lr, scene_static_lrs: dict,
                 *, width: int, height: int) -> JointTrainState:
    """Adam on every human group and, where s_grads is given, every scene
    parameter; then the densification statistics of both sets from the
    hook's gradient in viewspace units (x 0.5 W, 0.5 H; see
    scene_step.py), the first h_cap rows the human's."""
    hstate, sstate = jstate
    group_adam_update(h_grads, hstate.opt, hgs.params_of(hstate.params),
                      dict(human_static_lrs, xyz=human_xyz_lr))
    if s_grads is not None:
        group_adam_update(s_grads, sstate.opt, sgs.params_of(sstate.gs),
                          dict(scene_static_lrs, xyz=scene_xyz_lr))
    h_cap = hstate.params.xyz.shape[0]
    vs_grad = hook_grad * torch.tensor([0.5 * width, 0.5 * height],
                                       device=hook_grad.device)
    hgs.add_densification_stats(hstate.state, vs_grad[:h_cap],
                                pkg["human_radii"],
                                pkg["human_visibility_filter"])
    sgs.add_densification_stats(sstate.gs, vs_grad[h_cap:],
                                pkg["scene_radii"],
                                pkg["scene_visibility_filter"])
    return jstate
