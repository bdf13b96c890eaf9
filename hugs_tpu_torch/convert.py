"""Carries weights, optimizer state and cameras from the JAX package into
the port.

Both sides meet at numpy: the caller passes a JAX SceneGS as
{field: np.asarray(getattr(gs, field))} and a Camera likewise, so this
module imports nothing of the JAX package. The port's render of a
converted scene equals the JAX package's render of the original.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch.models.scene_gs import BUFFER_FIELDS, PARAM_FIELDS, SceneGS
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.train.optim import GroupAdamState


def scene_gs_from_numpy(arrays: dict[str, np.ndarray],
                        device: torch.device | str = "cuda") -> SceneGS:
    """SceneGS from the numpy arrays of every SceneGS field."""
    fields = {}
    for f in PARAM_FIELDS + BUFFER_FIELDS:
        a = np.asarray(arrays[f])
        if f == "alive":
            a = a.astype(bool)
        elif f == "active_sh_degree":
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        fields[f] = torch.as_tensor(a, device=device)
    return SceneGS(**fields)


def camera_from_numpy(arrays: dict[str, np.ndarray],
                      device: torch.device | str = "cuda") -> Camera:
    """Camera from the numpy arrays of every Camera field."""
    return Camera(**{f: torch.as_tensor(np.array(arrays[f], np.float32),
                                        device=device)
                     for f in Camera._fields})


def adam_state_from_numpy(mu: dict[str, np.ndarray], nu: dict[str, np.ndarray],
                          step, device: torch.device | str = "cuda"
                          ) -> GroupAdamState:
    """GroupAdamState from the numpy arrays of a JAX GroupAdamState's
    moment dicts and its step count."""
    def moments(d):
        return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in d.items()}
    return GroupAdamState(
        mu=moments(mu), nu=moments(nu),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device))
