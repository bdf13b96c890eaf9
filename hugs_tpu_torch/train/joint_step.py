"""Joint human + scene training step (cfg_files/neuman/hugs_human_scene.yaml).

Both Gaussian sets train through one merged render (reference
gs_trainer.py:218-351 in the human_scene mode): the human set first,
then the scene's, in one depth-sorted blend (K1 forward, K2 backward on
the card), an optional second render of the human alone for the
humansep terms, HumanSceneLoss in the human_scene mode, Adam over both
sets' groups, and the merged mean2d hook's gradient split back, human
rows first, into each set's densification statistics.

As in train/human_step.py the stages are separate functions
(`joint_render`, `joint_loss`, `joint_grads`, `joint_update`), so a
caller can time them or check the render before it updates anything
(the trainer's overflow retry does); `joint_train_step` runs them in
order, in place on both states. The loss's random draws (`LossDraws`)
come from the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.renderer import render_human_scene
from hugs_tpu_torch.train.budget import fit_budget
from hugs_tpu_torch.train.human_step import HumanTrainState
from hugs_tpu_torch.train.optim import group_adam_update, leaves, pack
from hugs_tpu_torch.train.scene_step import SceneTrainState, viewspace_scale
from hugs_tpu_torch.utils import profiling


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
    with profiling.span("step.human_forward", device=True):
        h_out = hgs.human_forward(jstate.human.params, jstate.human.state,
                                  fixed, cfg, smpl_scale=smpl_scale,
                                  dataset_idx=dataset_idx)
    if between is not None:
        between()
    with profiling.span("step.render", device=True):
        s_out = sgs.scene_forward(jstate.scene.gs)
        pkg = render_human_scene(
            {"camera": camera, "width": width, "height": height}, h_out,
            s_out, bg_color=bg, human_bg_color=human_bg,
            render_mode="human_scene",
            render_human_separate=render_human_separate,
            mean2d_grad_hook=hook,
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
    vs_grad = hook_grad * viewspace_scale(hook_grad, width, height)
    hgs.add_densification_stats(hstate.state, vs_grad[:h_cap],
                                pkg["human_radii"],
                                pkg["human_visibility_filter"])
    sgs.add_densification_stats(sstate.gs, vs_grad[h_cap:],
                                pkg["scene_radii"],
                                pkg["scene_visibility_filter"])
    return jstate


def step_aux(loss: torch.Tensor, loss_dict: dict, pkg: dict,
             h_out: dict) -> dict:
    """The step's diagnostics: the loss and its terms, the binning's
    overflow flag, instances and slots, the image, and the decoded
    opacity, canonical scales and rotations the human densify reads."""
    return {"loss": loss.detach(),
            "loss_dict": {k: v.detach() for k, v in loss_dict.items()},
            "overflowed": pkg["overflowed"],
            "n_instances": pkg["n_instances"],
            "n_slots": pkg["n_slots"],
            "render": pkg["render"].detach(),
            "opacity": h_out["opacity"].detach(),
            "scales_canon": h_out["scales_canon"].detach(),
            "rotmat_canon": h_out["rotmat_canon"].detach()}


def joint_train_step(
    jstate: JointTrainState,
    fixed: hgs.HumanGSFixed,
    camera: Camera,
    gt_image: torch.Tensor,      # (3, H, W)
    gt_mask: torch.Tensor,       # (H, W)
    bg: torch.Tensor,            # (3,) the step's random background
    human_bg: torch.Tensor,      # (3,) the human pass's background
    smpl_scale,                  # float or () tensor
    dataset_idx,                 # the frame's row of the pose tables
    draws: LossDraws,
    human_xyz_lr,                # float or () tensor, from the schedule
    human_static_lrs: dict,
    scene_xyz_lr,
    scene_static_lrs: dict,
    lpips=None,
    *,
    cfg: hgs.HumanGSConfig,
    loss_fn: HumanSceneLoss,
    width: int,
    height: int,
    instance_budget: int = 0,
    render_human_separate: bool = False,
    optim_scene: bool = True,
    grow_budget: bool = False,
):
    """One joint step, in place on jstate; with optim_scene False the
    scene's parameters and moments stay (its statistics still gather).
    With grow_budget, a forward that overflows the budget runs again at
    a grown one (train/budget.py; a second overflow raises). Returns
    (jstate, aux): step_aux's keys and the budget the forward used."""
    h_cap = jstate.human.params.xyz.shape[0]
    hook = torch.zeros((h_cap + jstate.scene.gs.capacity, 2),
                       device=jstate.human.params.xyz.device,
                       requires_grad=True)

    def forward(budget):
        return joint_render(
            jstate, fixed, camera, bg, human_bg, hook, smpl_scale,
            dataset_idx, cfg=cfg, width=width, height=height,
            instance_budget=budget,
            render_human_separate=render_human_separate)

    instance_budget = instance_budget or 4 * hook.shape[0]
    if grow_budget:
        (pkg, h_out), instance_budget = fit_budget(forward, instance_budget,
                                                   "joint step")
    else:
        pkg, h_out = forward(instance_budget)
    loss, loss_dict = joint_loss(loss_fn, draws, gt_image, gt_mask, bg,
                                 human_bg, pkg, h_out, lpips)
    h_grads, s_grads, hook_grad = joint_grads(loss, jstate, hook, optim_scene)
    joint_update(jstate, h_grads, s_grads, hook_grad, pkg, human_xyz_lr,
                 human_static_lrs, scene_xyz_lr, scene_static_lrs,
                 width=width, height=height)
    return jstate, {**step_aux(loss, loss_dict, pkg, h_out),
                    "instance_budget": instance_budget}
