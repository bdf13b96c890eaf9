"""Per-group Adam with schedulable learning rates, for densified models.

One Adam over named parameter groups with their own learning rates and
eps 1e-15, and the exponential position schedule of 3DGS. A group is a
tensor, a module (every parameter of it) or a nested dict of tensors,
and each of its leaves takes the group's rate. The state is a pair of
moment dicts shaped like the parameters (a module's moments are a dict
by parameter name) and a step count; densification zeroes moment rows
by index (models/scene_gs.py, models/human_gs.py), which is why this is
not torch.optim.Adam. The update keeps the JAX package's
operation order, p - lr * (m / bc1) / (sqrt(v / bc2) + eps);
torch.optim.Adam divides by sqrt(v) / sqrt(bc2) + eps instead, which
rounds differently.

Dead (padding) Gaussians get exactly zero gradient from the renderer, so
their moments stay zero and their parameters never move.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class GroupAdamState(NamedTuple):
    mu: dict             # first moments, like the parameters
    nu: dict             # second moments, like the parameters
    step: torch.Tensor   # () int32, updated in place


def expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> Callable:
    """Log-linear decay from lr_init to lr_final over max_steps, with an
    optional sine-eased delay (Plenoxels / JaxNeRF). Returns a function
    of the step that gives a float32 () tensor."""
    log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32))
    log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32))

    def helper(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0, 1)
        log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
        return torch.where(step < 0, 0.0, delay * log_lerp)
    return helper


def _zeros_like(group):
    """Moments shaped like a group: a tensor's zeros, a module's by
    parameter name, a dict's by key."""
    if isinstance(group, torch.nn.Module):
        return {n: torch.zeros_like(p) for n, p in group.named_parameters()}
    if isinstance(group, dict):
        return {k: _zeros_like(v) for k, v in group.items()}
    return torch.zeros_like(group)


def leaves(group) -> list[torch.Tensor]:
    """A group's tensors in a fixed order: a module's parameters in
    named_parameters order, a dict's values in key order (nested). The
    moments of `_zeros_like(group)` and gradients packed by `pack` list
    in the same order."""
    if isinstance(group, torch.nn.Module):
        return [p for _, p in group.named_parameters()]
    if isinstance(group, dict):
        return [x for v in group.values() for x in leaves(v)]
    return [group]


def pack(group, flat: list[torch.Tensor]):
    """Tensors listed in `leaves(group)` order, packed like the group's
    moments; consumes them from the front of `flat`."""
    if isinstance(group, torch.nn.Module):
        return {n: flat.pop(0) for n, _ in group.named_parameters()}
    if isinstance(group, dict):
        return {k: pack(v, flat) for k, v in group.items()}
    return flat.pop(0)


def group_adam_init(params: dict) -> GroupAdamState:
    dev = leaves(params)[0].device
    return GroupAdamState(
        mu={k: _zeros_like(v) for k, v in params.items()},
        nu={k: _zeros_like(v) for k, v in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def group_adam_update(grads: dict, state: GroupAdamState, params: dict,
                      lrs: dict, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-15) -> GroupAdamState:
    """One Adam step, in place on params and on state's moments and
    step. `grads` is shaped like the moments. `lrs` maps each group's
    name to a float or a () tensor (e.g. from expon_lr); a name it lacks
    gets lr 0 (frozen). Returns state."""
    state.step.add_(1)
    step = state.step.to(torch.float32)
    # the betas as float32 tensors made on the device (a tensor from host
    # memory would wait for the card, and a captured step cannot copy one)
    bc1 = 1.0 - torch.full_like(step, b1) ** step
    bc2 = 1.0 - torch.full_like(step, b2) ** step
    for k, group in params.items():
        lr = lrs.get(k, 0.0)
        for p, g, m, v in zip(leaves(group), leaves(grads[k]),
                              leaves(state.mu[k]), leaves(state.nu[k]),
                              strict=True):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return state
