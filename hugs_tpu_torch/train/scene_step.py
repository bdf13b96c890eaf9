"""Scene-only 3DGS training step (vanilla 3DGS on a SceneGS).

  - `scene_train_step`: forward render -> L1 + SSIM loss -> gradients
    (through K2 on the card) -> group-Adam update -> densification
    statistics. Run every step.
  - `scene_densify_step`: densify / clone / split / prune and, on
    request, the opacity reset, at fixed capacity. Run every
    densification interval.

Both update the model and the optimizer state in place and return the
state with a dict of diagnostics. The screen-space gradient the
densifier reads is the gradient of a zero `mean2d_grad_hook` added to
the projected means.

The stages of a step are separate functions (`scene_render`,
`scene_loss`, `scene_grads`, `scene_update`), so a caller can time or
inspect each one; `scene_train_step` runs them in order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.losses.basic import l1_loss, ssim
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.train.optim import (
    GroupAdamState, expon_lr, group_adam_init, group_adam_update,
)
from hugs_tpu_torch.utils import profiling


class SceneTrainState(NamedTuple):
    gs: sgs.SceneGS
    opt: GroupAdamState


def make_scene_lrs(cfg_lr, spatial_lr_scale: float):
    """Per-group learning rates of 3DGS from any object with the
    attributes position_init, position_final, position_delay_mult,
    position_max_steps, feature, opacity, scaling and rotation. Returns
    (dict of the fixed rates, the xyz schedule: step -> lr)."""
    sched = expon_lr(
        lr_init=cfg_lr.position_init * spatial_lr_scale,
        lr_final=cfg_lr.position_final * spatial_lr_scale,
        lr_delay_mult=cfg_lr.position_delay_mult,
        max_steps=cfg_lr.position_max_steps,
    )
    static = {
        "features_dc": cfg_lr.feature,
        "features_rest": cfg_lr.feature / 20.0,
        "opacity": cfg_lr.opacity,
        "scaling": cfg_lr.scaling,
        "rotation": cfg_lr.rotation,
    }
    return static, sched


def viewspace_scale(like: torch.Tensor, width: int,
                    height: int) -> torch.Tensor:
    """(0.5 W, 0.5 H), float32 on like's device, filled there: a tensor
    from host memory would wait for the card, and a captured step
    (train/graph_step.py) cannot copy one."""
    scale = torch.empty(2, dtype=torch.float32, device=like.device)
    scale[0:1].fill_(0.5 * width)
    scale[1:2].fill_(0.5 * height)
    return scale


def init_scene_train_state(gs: sgs.SceneGS) -> SceneTrainState:
    return SceneTrainState(gs=gs, opt=group_adam_init(sgs.params_of(gs)))


def scene_render(gs: sgs.SceneGS, camera: Camera, bg: torch.Tensor,
                 hook: torch.Tensor, *, width: int, height: int,
                 instance_budget: int = 0) -> dict:
    """The forward: activation, projection, binning and blend, with the
    mean2d hook; the budget defaults to 4x the capacity."""
    with profiling.span("step.render", device=True):
        out = sgs.scene_forward(gs)
        return render(out["xyz"], out["scales"], out["rotq"], out["opacity"],
                      out["shs"], camera, width, height, bg=bg,
                      active_sh_degree=out["active_sh_degree"],
                      alive=out["alive"], mean2d_grad_hook=hook,
                      instance_budget=instance_budget or 4 * gs.capacity)


def scene_loss(img: torch.Tensor, gt_image: torch.Tensor, l1_w: float = 0.8,
               ssim_w: float = 0.2) -> torch.Tensor:
    """l1_w * L1 + ssim_w * (1 - SSIM) over the whole image (unmasked)."""
    return l1_w * l1_loss(img, gt_image) + ssim_w * (1.0 - ssim(img,
                                                                gt_image))


def scene_grads(loss: torch.Tensor, gs: sgs.SceneGS, hook: torch.Tensor):
    """d(loss)/d(each parameter) and d(loss)/d(hook), the pixel-space
    mean2d gradient. A parameter the loss does not reach gets zeros."""
    params = sgs.params_of(gs)
    got = torch.autograd.grad(loss, list(params.values()) + [hook],
                              allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), got[:-1])}
    return grads, got[-1]


@torch.no_grad()
def scene_update(state: SceneTrainState, grads: dict,
                 hook_grad: torch.Tensor, pkg: dict, xyz_lr, static_lrs: dict,
                 *, width: int, height: int) -> SceneTrainState:
    """Adam on the parameters, then the densification statistics."""
    gs = state.gs
    group_adam_update(grads, state.opt, sgs.params_of(gs),
                      dict(static_lrs, xyz=xyz_lr))
    # The hook's gradient is d(loss)/d(pixel-space mean2d); 3DGS's CUDA
    # backward returns viewspace gradients scaled by 0.5 W (0.5 H for y),
    # and densify_grad_threshold is calibrated to those units.
    scale = viewspace_scale(hook_grad, width, height)
    sgs.add_densification_stats(gs, hook_grad * scale, pkg["radii"],
                                pkg["visibility_filter"])
    return state


def scene_train_step(
    state: SceneTrainState,
    camera: Camera,
    gt_image: torch.Tensor,       # (3, H, W)
    bg: torch.Tensor,             # (3,)
    xyz_lr,                       # float or () tensor, from the schedule
    static_lrs: dict,
    *,
    width: int,
    height: int,
    l1_w: float = 0.8,
    ssim_w: float = 0.2,
    instance_budget: int = 0,
):
    """One training step, in place on state. Returns (state, aux)."""
    gs = state.gs
    hook = torch.zeros((gs.capacity, 2), device=gs.xyz.device,
                       requires_grad=True)
    pkg = scene_render(gs, camera, bg, hook, width=width, height=height,
                       instance_budget=instance_budget)
    img = pkg["render"]
    loss = scene_loss(img, gt_image, l1_w, ssim_w)
    grads, hook_grad = scene_grads(loss, gs, hook)
    scene_update(state, grads, hook_grad, pkg, xyz_lr, static_lrs,
                 width=width, height=height)
    with torch.no_grad():
        aux = {"loss": loss.detach(),
               "psnr_mse": torch.mean((img - gt_image) ** 2),
               "overflowed": pkg["overflowed"],
               "n_instances": pkg["n_instances"],
               "n_slots": pkg["n_slots"],
               "n_visible": torch.sum(pkg["visibility_filter"])}
    return state, aux


def scene_densify_step(
    state: SceneTrainState,
    noise: torch.Tensor,
    extent: float,
    *,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    max_screen_size: float | None = None,
    percent_dense: float = 0.01,
    do_reset_opacity: bool = False,
    max_n_gaussians: int | None = None,
):
    """Densify and prune, then optionally reset opacity, in place on
    state. noise: (2, C, 3) standard normal draws for the two samples of
    each split, drawn by the caller (hugs_tpu draws them from its key).
    Returns (state, info)."""
    moments = [state.opt.mu, state.opt.nu]
    info = sgs.densify_and_prune(
        state.gs, moments, noise, grad_threshold, min_opacity, extent,
        max_screen_size, percent_dense, max_n_gaussians=max_n_gaussians)
    if do_reset_opacity:
        sgs.reset_opacity(state.gs, moments)
    return state, info
