"""Carries weights, optimizer state, cameras and the human avatar from
the JAX package into the port.

Both sides meet at numpy: the caller passes a JAX SceneGS as
{field: np.asarray(getattr(gs, field))}, a Camera likewise, the human
model's parameter tree as nested dicts of arrays, and an LPIPS's weight
lists as numpy arrays, so this module
imports nothing of the JAX package. The port's render of a converted
scene or avatar equals the JAX package's render of the original, a
converted joint training state (`joint_state_from_numpy`) trains on as
the original does, and a converted per-Gaussian avatar
(`human_pergs_from_numpy`) poses as the original does.
`save_checkpoint_from_numpy` writes a joint state in the port's
checkpoint layout, so that a run trained by the JAX package resumes,
evaluates and serves in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from hugs_tpu_torch.losses.lpips import LPIPS, N_CONVS, VGG_BLOCKS
from hugs_tpu_torch.models import nets
from hugs_tpu_torch.models.human_gs import HumanGS, HumanGSState
from hugs_tpu_torch.models.human_gs import params_of as human_params_of
from hugs_tpu_torch.models.human_gs_pergs import HumanPerGS
from hugs_tpu_torch.models.scene_gs import BUFFER_FIELDS, PARAM_FIELDS, SceneGS
from hugs_tpu_torch.models.scene_gs import params_of as scene_params_of
from hugs_tpu_torch.models.smpl import (
    TENSOR_FIELDS, SMPLModel, make_smpl_model,
)
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train.human_step import HumanTrainState
from hugs_tpu_torch.train.joint_step import JointTrainState
from hugs_tpu_torch.train.optim import GroupAdamState
from hugs_tpu_torch.train.scene_step import SceneTrainState


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


def human_pergs_from_numpy(arrays: dict,
                           device: torch.device | str = "cuda") -> HumanPerGS:
    """HumanPerGS from the numpy arrays of a JAX HumanPerGS: 'gs' (every
    SceneGS field) and the pose tables 'global_orient', 'body_pose',
    'transl' and 'betas'."""
    return HumanPerGS(
        gs=scene_gs_from_numpy(arrays["gs"], device),
        **{f: _f32(arrays[f], device) for f in HumanPerGS._fields[1:]})


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


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def smpl_model_from_numpy(arrays: dict, device: torch.device | str = "cuda"
                          ) -> SMPLModel:
    """SMPLModel from the numpy arrays of every SMPLModel field (a JAX
    model's `faces` property gives the triangles)."""
    return make_smpl_model(*(arrays[f] for f in TENSOR_FIELDS),
                           arrays["parents"], arrays["faces"], device=device)


def _layer(tree: dict, device):
    """nets.Linear from {'w', 'b'}, nets.WeightNormLinear from
    {'v', 'g', 'b'}; weights keep the (fan_in, fan_out) layout."""
    if "v" in tree:
        return nets.WeightNormLinear(_f32(tree["v"], device),
                                     _f32(tree["g"], device),
                                     _f32(tree["b"], device))
    return nets.Linear(_f32(tree["w"], device), _f32(tree["b"], device))


def human_gs_from_numpy(arrays: dict, device: torch.device | str = "cuda"
                        ) -> HumanGS:
    """HumanGS from the numpy arrays of a JAX HumanGS: its array fields
    and the nested dicts of the triplane and the three decoders."""
    def layers(name):
        return {k: _layer(v, device) for k, v in arrays[name].items()}

    return HumanGS(
        xyz=_f32(arrays["xyz"], device),
        triplane=nets.TriPlane(*(_f32(arrays["triplane"][k], device)
                                 for k in ("plane_xy", "plane_xz",
                                           "plane_yz"))),
        appearance_dec=nets.AppearanceDecoder(**layers("appearance_dec")),
        geometry_dec=nets.GeometryDecoder(**layers("geometry_dec")),
        deformation_dec=nets.DeformationDecoder(**layers("deformation_dec")),
        **{f: _f32(arrays[f], device)
           for f in ("global_orient", "body_pose", "transl", "betas")})


def human_state_from_numpy(arrays: dict, device: torch.device | str = "cuda"
                           ) -> HumanGSState:
    """HumanGSState from the numpy arrays of every HumanGSState field."""
    fields = {}
    for f in HumanGSState._fields:
        a = np.asarray(arrays[f])
        if f == "alive":
            a = a.astype(bool)
        elif f == "active_sh_degree":
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        fields[f] = torch.as_tensor(a, device=device)
    return HumanGSState(**fields)


def _flat_names(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {dotted name: array}: the layout of a
    module's moments (named_parameters names) in train/optim.py."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_names(v, f"{prefix}{k}."))
    return out


def _moment(tree, group, device):
    """One group's moment, laid out as train/optim.py lays out the
    moments of `group` (the port's parameter, or module: a dict in its
    named_parameters order, which a JAX tree's sorted keys need not
    follow)."""
    if isinstance(group, torch.nn.Module):
        flat = _flat_names(tree)
        return {n: _f32(flat[n], device) for n, _ in group.named_parameters()}
    return _f32(tree, device)


def joint_state_from_numpy(human: dict, scene: dict,
                           device: torch.device | str = "cuda"
                           ) -> JointTrainState:
    """The port's JointTrainState of a JAX JointTrainState given as numpy:
    human = {"params": a HumanGS's fields (the nets as nested dicts),
    "state": a HumanGSState's fields, "opt": {"mu", "nu", "step"}} and
    scene = {"gs": a SceneGS's fields, "opt": {"mu", "nu", "step"}}, each
    moment tree shaped like its parameters."""
    def opt(tree, groups):
        return GroupAdamState(
            mu={k: _moment(tree["mu"][k], g, device)
                for k, g in groups.items()},
            nu={k: _moment(tree["nu"][k], g, device)
                for k, g in groups.items()},
            step=torch.tensor(int(np.asarray(tree["step"])),
                              dtype=torch.int32, device=device))

    params = human_gs_from_numpy(human["params"], device)
    gs = scene_gs_from_numpy(scene["gs"], device)
    return JointTrainState(
        human=HumanTrainState(
            params=params, state=human_state_from_numpy(human["state"],
                                                        device),
            opt=opt(human["opt"], human_params_of(params))),
        scene=SceneTrainState(gs=gs, opt=opt(scene["opt"],
                                             scene_params_of(gs))))


def save_checkpoint_from_numpy(ckpt_dir: str, iter_s: str, human: dict,
                               scene: dict,
                               device: torch.device | str = "cuda"
                               ) -> JointTrainState:
    """Writes a JAX JointTrainState given as numpy (joint_state_from_numpy's
    `human` and `scene`: a restored hugs_tpu checkpoint's train states)
    as the port's checkpoints human_{iter_s} and scene_{iter_s} under
    ckpt_dir, which GaussianTrainer.load_latest_ckpt restores. Returns
    the converted state."""
    js = joint_state_from_numpy(human, scene, device)
    ckpt_io.save(ckpt_dir, iter_s, human=js.human, scene=js.scene)
    return js


def lpips_from_numpy(conv_weights, conv_biases, lin_weights,
                     has_pretrained: bool = False,
                     device: torch.device | str = "cuda") -> LPIPS:
    """LPIPS from the numpy arrays of a JAX LPIPS's lists: 13 conv
    weights in HWIO (transposed to OIHW), their biases and the 5 heads
    as they are."""
    if len(conv_weights) != N_CONVS or len(lin_weights) != len(VGG_BLOCKS):
        raise ValueError("an LPIPS has 13 convs and 5 heads")
    arrays = {f"conv_{i}_w": w for i, w in enumerate(conv_weights)}
    arrays.update({f"conv_{i}_b": b for i, b in enumerate(conv_biases)})
    arrays.update({f"lin_{t}": w for t, w in enumerate(lin_weights)})
    return LPIPS.from_arrays(arrays, has_pretrained, device)
