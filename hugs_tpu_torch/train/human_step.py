"""Human-avatar training: the init distillation and the training step.

  - `distill_init`: the MSE pre-fit of the triplane and decoders to the
    mesh-derived initial attributes (reference hugs/utils/init_opt.py:
    12-70), with ReduceLROnPlateau(patience 1000, factor 0.5) carried as
    device tensors (`plateau_update`), so that a step reads nothing back
    to the host.
  - `human_train_step`: human_forward -> render (K1 forward, K2 backward
    on the card) -> HumanSceneLoss in "human" mode (L1, SSIM, patch
    LPIPS, LBS) -> gradients -> group Adam -> densification statistics
    (reference gs_trainer.py:218-351, the human branch).
  - `human_densify_step`: densify / clone / split / prune at fixed
    capacity, every densification interval.

All update the model and the optimizer state in place. The stages of a
step are separate functions (`human_render`, `human_loss`,
`human_grads`, `human_update`), so a caller can time or inspect each
one; `human_train_step` runs them in order. The random draws of the
loss (`LossDraws`) and of the densify's splits come from the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.train.budget import fit_budget
from hugs_tpu_torch.train.optim import (
    GroupAdamState, expon_lr, group_adam_init, group_adam_update, leaves,
    pack,
)

# ReduceLROnPlateau of the distillation (init_opt.py)
PLATEAU_THRESHOLD = 1e-9
PLATEAU_PATIENCE = 1000
PLATEAU_FACTOR = 0.5
DISTILL_KEYS = ("xyz_offsets", "scales", "rot6d_canon", "shs", "opacity")


class HumanLR:
    """The human learning rates of config[2]'s recipe
    (cfg_files/neuman/hugs_human.yaml, hugs_tpu/cfg/config.py:137-148,
    human.lr), in the form make_human_lrs reads."""
    position_init = 0.00016
    position_final = 0.0000016
    position_delay_mult = 0.01
    position_max_steps = 30_000
    smpl_spatial = 2.0
    smpl_pose = 0.0001
    smpl_betas = 0.0001
    smpl_trans = 0.0001
    appearance = 1e-3
    geometry = 1e-3
    vembed = 1e-3
    deformation = 1e-4


class HumanTrainState(NamedTuple):
    params: hgs.HumanGS
    state: hgs.HumanGSState
    opt: GroupAdamState


def make_human_lrs(cfg_lr=HumanLR, optim_pose: bool = False,
                   optim_betas: bool = False, optim_trans: bool = False):
    """Group learning rates (reference setup_optimizer, hugs_trimlp.py:
    667-707) from any object with the attributes position_init,
    position_final, position_delay_mult, position_max_steps,
    smpl_spatial, vembed, geometry, appearance, deformation, smpl_pose,
    smpl_betas and smpl_trans. Returns (dict of the fixed rates, the xyz
    schedule: step -> lr)."""
    sched = expon_lr(
        lr_init=cfg_lr.position_init * cfg_lr.smpl_spatial,
        lr_final=cfg_lr.position_final * cfg_lr.smpl_spatial,
        lr_delay_mult=cfg_lr.position_delay_mult,
        max_steps=cfg_lr.position_max_steps)
    static = {
        "triplane": cfg_lr.vembed,
        "geometry_dec": cfg_lr.geometry,
        "appearance_dec": cfg_lr.appearance,
        "deformation_dec": cfg_lr.deformation,
        "global_orient": cfg_lr.smpl_pose if optim_pose else 0.0,
        "body_pose": cfg_lr.smpl_pose if optim_pose else 0.0,
        "betas": cfg_lr.smpl_betas if optim_betas else 0.0,
        "transl": cfg_lr.smpl_trans if optim_trans else 0.0,
    }
    return static, sched


def init_human_train_state(params: hgs.HumanGS,
                           state: hgs.HumanGSState) -> HumanTrainState:
    return HumanTrainState(params=params, state=state,
                           opt=group_adam_init(hgs.params_of(params)))


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               alive: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the rows where alive (the leading dim)."""
    m = alive.reshape((-1,) + (1,) * (pred.dim() - 1)).to(pred.dtype)
    per_elem = torch.sum(((pred - target) ** 2) * m)
    n_elem = torch.clamp(torch.sum(alive).to(pred.dtype), min=1.0) * (
        pred.numel() // pred.shape[0])
    return per_elem / n_elem


# ------------------------------------------------------------ distillation

def _nets(params: hgs.HumanGS) -> dict:
    return {f: getattr(params, f) for f in hgs.NET_FIELDS}


def distill_loss(params: hgs.HumanGS, state: hgs.HumanGSState,
                 targets: dict, cfg: hgs.HumanGSConfig) -> torch.Tensor:
    """The distillation's loss: the masked MSE of each decoded attribute
    to its mesh-derived target, and of the pose blend-shapes where the
    decoder has them."""
    out = hgs.canon_forward(params, state, cfg)
    keys = DISTILL_KEYS + (("lbs_weights",) if cfg.use_deformer else ())
    loss = 0.0
    for k in keys:
        if out.get(k) is not None:
            loss = loss + masked_mse(out[k], targets[k], state.alive)
    if cfg.use_deformer and out.get("posedirs") is not None:
        loss = loss + torch.mean((out["posedirs"] - targets["posedirs"]) ** 2)
    return loss


def distill_step(params: hgs.HumanGS, state: hgs.HumanGSState,
                 opt: GroupAdamState, targets: dict, lr: torch.Tensor,
                 cfg: hgs.HumanGSConfig) -> torch.Tensor:
    """One distillation step, in place on the nets and on `opt` (the
    group Adam of the four nets): lr for the triplane and the appearance
    and geometry decoders, lr / 2 for the deformation decoder. Returns
    the loss before the step, detached."""
    nets = _nets(params)
    loss = distill_loss(params, state, targets, cfg)
    flat = leaves(nets)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = pack(nets, [torch.zeros_like(p) if g is None else g
                        for p, g in zip(flat, got)])
    lrs = {"triplane": lr, "appearance_dec": lr, "geometry_dec": lr,
           "deformation_dec": lr * 0.5}
    group_adam_update(grads, opt, nets, lrs)
    return loss.detach()


def plateau_update(best: torch.Tensor, patience: torch.Tensor,
                   lr: torch.Tensor, loss: torch.Tensor):
    """ReduceLROnPlateau(mode min, threshold 1e-9 absolute, patience
    1000, factor 0.5) on device tensors: best and lr float32, patience
    int32. Returns the new (best, patience, lr)."""
    improved = loss < best - PLATEAU_THRESHOLD
    best = torch.minimum(best, loss)
    patience = torch.where(improved, 0, patience + 1).to(torch.int32)
    drop = patience > PLATEAU_PATIENCE
    lr = torch.where(drop, lr * PLATEAU_FACTOR, lr)
    patience = torch.where(drop, 0, patience).to(torch.int32)
    return best, patience, lr


def distill_init(params: hgs.HumanGS, state: hgs.HumanGSState,
                 init_values: dict, cfg: hgs.HumanGSConfig,
                 num_steps: int = 7000, lr: float = 1e-3,
                 log_every: int = 0) -> hgs.HumanGS:
    """The init distillation (reference optimize_init, init_opt.py:12-70,
    with its plateau decay), in place on params' nets. Returns params."""
    targets = {k: v for k, v in init_values.items() if k != "edges"}
    dev = params.xyz.device
    opt = group_adam_init(_nets(params))
    best = torch.tensor(float("inf"), device=dev)
    patience = torch.zeros((), dtype=torch.int32, device=dev)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    for i in range(num_steps):
        loss = distill_step(params, state, opt, targets, lr_t, cfg)
        best, patience, lr_t = plateau_update(best, patience, lr_t, loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"distill {i + 1:05d}: loss {float(loss):.6f} "
                  f"lr {float(lr_t):.2e}")
    return params


# ------------------------------------------------------------ training

def human_render(tstate: HumanTrainState, fixed: hgs.HumanGSFixed,
                 camera: Camera, bg: torch.Tensor, hook: torch.Tensor,
                 smpl_scale, dataset_idx, *, cfg: hgs.HumanGSConfig,
                 width: int, height: int, instance_budget: int = 0,
                 between=None):
    """The forward: human_forward (triplane, decoders, SMPL, LBS and the
    kNN skinning targets), then projection, binning and blend with the
    mean2d hook; the budget defaults to 4x the capacity. `between`, where
    given, is called with no arguments after human_forward (a timing
    mark). Returns (the render's dict, human_forward's dict)."""
    out = hgs.human_forward(tstate.params, tstate.state, fixed, cfg,
                            smpl_scale=smpl_scale, dataset_idx=dataset_idx)
    if between is not None:
        between()
    pkg = render(out["xyz"], out["scales"], out["rotq"], out["opacity"],
                 out["shs"], camera, width, height, bg=bg,
                 active_sh_degree=out["active_sh_degree"],
                 alive=out["alive"], mean2d_grad_hook=hook,
                 instance_budget=instance_budget or 4 * hook.shape[0])
    return pkg, out


def human_loss(loss_fn: HumanSceneLoss, draws: LossDraws,
               gt_image: torch.Tensor, gt_mask: torch.Tensor,
               bg: torch.Tensor, pkg: dict, out: dict | None,
               lpips=None):
    """The loss in "human" mode, the background bg on both sides; lpips
    (an LPIPS module) replaces the loss_fn's own where given. Returns
    (total, loss_dict)."""
    lf = loss_fn._replace(lpips=lpips) if lpips is not None else loss_fn
    total, loss_dict, _ = lf(draws, {"rgb": gt_image, "mask": gt_mask}, pkg,
                             out, render_mode="human", bg_color=bg,
                             human_bg_color=bg)
    return total, loss_dict


def human_grads(loss: torch.Tensor, params: hgs.HumanGS,
                hook: torch.Tensor):
    """d(loss)/d(each group), shaped like the Adam moments, and
    d(loss)/d(hook), the pixel-space mean2d gradient. A parameter the
    loss does not reach gets zeros."""
    groups = hgs.params_of(params)
    flat = leaves(groups)
    got = torch.autograd.grad(loss, flat + [hook], allow_unused=True)
    grads = pack(groups, [torch.zeros_like(p) if g is None else g
                          for p, g in zip(flat, got[:-1])])
    return grads, got[-1]


@torch.no_grad()
def human_update(tstate: HumanTrainState, grads: dict,
                 hook_grad: torch.Tensor, pkg: dict, xyz_lr,
                 static_lrs: dict, *, width: int,
                 height: int) -> HumanTrainState:
    """Adam on every group, then the densification statistics. The
    hook's pixel-space gradient is scaled by 0.5 W (0.5 H for y) to the
    viewspace units densify's threshold is calibrated to (see
    scene_step.py)."""
    group_adam_update(grads, tstate.opt, hgs.params_of(tstate.params),
                      dict(static_lrs, xyz=xyz_lr))
    scale = torch.tensor([0.5 * width, 0.5 * height],
                         device=hook_grad.device)
    hgs.add_densification_stats(tstate.state, hook_grad * scale,
                                pkg["radii"], pkg["visibility_filter"])
    return tstate


def human_train_step(
    tstate: HumanTrainState,
    fixed: hgs.HumanGSFixed,
    camera: Camera,
    gt_image: torch.Tensor,     # (3, H, W)
    gt_mask: torch.Tensor,      # (H, W)
    bg: torch.Tensor,           # (3,)
    smpl_scale,                 # float or () tensor
    dataset_idx,                # the frame's row of the pose tables
    draws: LossDraws,
    xyz_lr,                     # float or () tensor, from the schedule
    static_lrs: dict,
    lpips=None,
    *,
    cfg: hgs.HumanGSConfig,
    loss_fn: HumanSceneLoss,
    width: int,
    height: int,
    instance_budget: int = 0,
    grow_budget: bool = False,
):
    """One training step, in place on tstate. With grow_budget, a forward
    that overflows the budget runs again at a grown one (train/budget.py;
    a second overflow raises). Returns (tstate, aux): the loss and its
    terms, the binning diagnostics, the budget the forward used, the
    visible count, and the decoded opacity, canonical scales and
    rotations that human_densify_step reads."""
    cap = tstate.params.xyz.shape[0]
    hook = torch.zeros((cap, 2), device=tstate.params.xyz.device,
                       requires_grad=True)

    def forward(budget):
        return human_render(tstate, fixed, camera, bg, hook, smpl_scale,
                            dataset_idx, cfg=cfg, width=width, height=height,
                            instance_budget=budget)

    instance_budget = instance_budget or 4 * cap
    if grow_budget:
        (pkg, out), instance_budget = fit_budget(forward, instance_budget,
                                                 "human step")
    else:
        pkg, out = forward(instance_budget)
    loss, loss_dict = human_loss(loss_fn, draws, gt_image, gt_mask, bg, pkg,
                                 out, lpips)
    grads, hook_grad = human_grads(loss, tstate.params, hook)
    human_update(tstate, grads, hook_grad, pkg, xyz_lr, static_lrs,
                 width=width, height=height)
    aux = {"loss": loss.detach(),
           "loss_dict": {k: v.detach() for k, v in loss_dict.items()},
           "overflowed": pkg["overflowed"],
           "n_instances": pkg["n_instances"],
           "n_slots": pkg["n_slots"],
           "instance_budget": instance_budget,
           "n_visible": torch.sum(pkg["visibility_filter"]),
           "opacity": out["opacity"].detach(),
           "scales_canon": out["scales_canon"].detach(),
           "rotmat_canon": out["rotmat_canon"].detach()}
    return tstate, aux


def human_densify_step(
    tstate: HumanTrainState,
    human_gs_out: dict,
    noise: torch.Tensor,
    extent: float,
    *,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    max_screen_size: float | None = 20.0,
    percent_dense: float = 0.01,
    max_n_gaussians: int | None = None,
):
    """Densify and prune in place on tstate; human_gs_out holds the
    opacity, scales_canon and rotmat_canon of the last step's aux.
    noise: (2, C, 3) standard normal draws for the two samples of each
    split, drawn by the caller. Returns (tstate, info)."""
    info = hgs.densify_and_prune(
        tstate.params, tstate.state,
        [tstate.opt.mu["xyz"], tstate.opt.nu["xyz"]], human_gs_out, noise,
        grad_threshold, min_opacity, extent, max_screen_size, percent_dense,
        max_n_gaussians=max_n_gaussians)
    return tstate, info
