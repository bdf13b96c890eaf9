"""Human-avatar training: the state, the learning rates and the init
distillation.

  - `distill_init`: the MSE pre-fit of the triplane and decoders to the
    mesh-derived initial attributes (reference hugs/utils/init_opt.py:
    12-70), with ReduceLROnPlateau(patience 1000, factor 0.5) carried as
    device tensors (`plateau_update`), so that a step reads nothing back
    to the host. It updates the nets and their optimizer state in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference.plain.models import human_gs as hgs
from bench_port.reference.plain.train.optim import (
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
