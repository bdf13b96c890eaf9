"""Triplane field and MLP decoders of the human avatar, plain PyTorch.

  - TriPlane: three learned (res, res, F) feature planes, sampled
    bilinearly (align_corners) at pairs of normalised xyz and
    concatenated to 3F features.
  - AppearanceDecoder / GeometryDecoder / DeformationDecoder: a shared
    two-layer trunk and several heads, GELU activations, a
    weight-normalised skinning layer and a zero-initialised blend-shape
    head whose (N, 621) output is reshaped to the (207, 3N) posedirs
    layout.

Each module holds its parameters under the JAX package's names, with
linear weights stored (fan_in, fan_out) and applied as x @ w + b, so a
JAX parameter tree carries over name for name (convert.py). The modules
only hold parameters and have no forward: the JAX package's functional
entry points (`triplane_apply`, `appearance_decoder_apply`, ...) are
plain functions here too, taking the module, and the only way to apply
one. GELU is the tanh form, jax.nn.gelu's default; torch's
default (erf) differs by up to ~5e-4. Linear layers start from torch's
default bound, uniform +-1/sqrt(fan_in), drawn from the caller's
generator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hugs_tpu_torch.ops.grid_sample import grid_sample_2d


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _draw(generator: torch.Generator, shape, device, normal=False):
    """Standard normal or uniform [0, 1) draws from `generator` on its own
    device, moved to `device`: one generator state gives the same values
    on every device."""
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator,
              device=generator.device).to(device)


# ------------------------------------------------------------- primitives

class Linear(nn.Module):
    """x @ w + b; w is (fan_in, fan_out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w + p.b


def linear_init(generator, fan_in: int, fan_out: int,
                device="cuda") -> Linear:
    bound = 1.0 / fan_in ** 0.5
    w = (_draw(generator, (fan_in, fan_out), device) * 2.0 - 1.0) * bound
    b = (_draw(generator, (fan_out,), device) * 2.0 - 1.0) * bound
    return Linear(w, b)


class WeightNormLinear(nn.Module):
    """x @ (v / ||v||_col * g) + b, the norm taken per output column."""

    def __init__(self, v: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(g)
        self.b = nn.Parameter(b)


def weight_norm_init(generator, fan_in: int, fan_out: int,
                     device="cuda") -> WeightNormLinear:
    p = linear_init(generator, fan_in, fan_out, device)
    w = p.w.detach()
    return WeightNormLinear(w, torch.linalg.norm(w, dim=0), p.b.detach())


def weight_norm_linear(p: WeightNormLinear, x: torch.Tensor) -> torch.Tensor:
    # explicit, with the JAX package's clamp (torch's weight_norm has none)
    w = p.v / torch.clamp(torch.linalg.norm(p.v, dim=0, keepdim=True),
                          min=1e-12) * p.g
    return x @ w + p.b


# --------------------------------------------------------------- triplane

class TriPlane(nn.Module):
    def __init__(self, plane_xy, plane_xz, plane_yz):
        super().__init__()
        self.plane_xy = nn.Parameter(plane_xy)
        self.plane_xz = nn.Parameter(plane_xz)
        self.plane_yz = nn.Parameter(plane_yz)


def triplane_init(generator, features: int = 32, res: int = 256,
                  device="cuda") -> TriPlane:
    shape = (res, res, features)
    return TriPlane(*(_draw(generator, shape, device, normal=True)
                      for _ in range(3)))


def triplane_apply(p: TriPlane, x: torch.Tensor, center: float = 0.0,
                   scale: float = 2.0) -> torch.Tensor:
    """x: (N, 3) coordinates in about [-scale/2, scale/2] around center.
    Returns (N, 3F). A plane is indexed (H = second coordinate, W =
    first), F.grid_sample's (x -> W, y -> H) convention."""
    u = (x - center) / scale + 0.5            # [0, 1]
    u = u * 2.0 - 1.0                         # [-1, 1]
    # slices, not lists: a list index is a tensor copied from host memory
    f_xy = grid_sample_2d(p.plane_xy, u[:, 0:2])
    f_xz = grid_sample_2d(p.plane_xz, u[:, 0::2])
    f_yz = grid_sample_2d(p.plane_yz, u[:, 1:3])
    return torch.cat([f_xy, f_xz, f_yz], dim=-1)


# --------------------------------------------------------------- decoders

def _trunk(p, feats):
    return gelu(linear(p.net1, gelu(linear(p.net0, feats))))


class AppearanceDecoder(nn.Module):
    def __init__(self, net0, net1, opacity, shs):
        super().__init__()
        self.net0, self.net1, self.opacity, self.shs = net0, net1, opacity, shs


def appearance_decoder_init(generator, n_features: int, hidden: int = 64,
                            device="cuda") -> AppearanceDecoder:
    return AppearanceDecoder(
        linear_init(generator, n_features, hidden, device),
        linear_init(generator, hidden, hidden, device),
        linear_init(generator, hidden, 1, device),
        linear_init(generator, hidden, 16 * 3, device))


def appearance_decoder_apply(p: AppearanceDecoder, feats) -> dict:
    h = _trunk(p, feats)
    return {"shs": linear(p.shs, h),
            "opacity": torch.sigmoid(linear(p.opacity, h))}


class GeometryDecoder(nn.Module):
    def __init__(self, net0, net1, xyz, rotations, scales):
        super().__init__()
        self.net0, self.net1 = net0, net1
        self.xyz, self.rotations, self.scales = xyz, rotations, scales


def geometry_decoder_init(generator, n_features: int, hidden: int = 128,
                          use_surface: bool = False,
                          device="cuda") -> GeometryDecoder:
    return GeometryDecoder(
        linear_init(generator, n_features, hidden, device),
        linear_init(generator, hidden, hidden, device),
        linear_init(generator, hidden, 3, device),
        linear_init(generator, hidden, 6, device),
        linear_init(generator, hidden, 2 if use_surface else 3, device))


def geometry_decoder_apply(p: GeometryDecoder, feats) -> dict:
    h = _trunk(p, feats)
    return {"xyz": linear(p.xyz, h),
            "rotations": linear(p.rotations, h),
            "scales": gelu(linear(p.scales, h))}


class DeformationDecoder(nn.Module):
    """blendshapes is None when pose blend-shapes are disabled."""

    def __init__(self, net0, net1, skinning_linear, skinning,
                 blendshapes=None):
        super().__init__()
        self.net0, self.net1 = net0, net1
        self.skinning_linear, self.skinning = skinning_linear, skinning
        self.blendshapes = blendshapes


def deformation_decoder_init(generator, n_features: int, hidden: int = 128,
                             disable_posedirs: bool = False,
                             device="cuda") -> DeformationDecoder:
    net0 = linear_init(generator, n_features, hidden, device)
    net1 = linear_init(generator, hidden, hidden, device)
    skinning_linear = weight_norm_init(generator, hidden, hidden, device)
    skinning = linear_init(generator, hidden, 24, device)
    blendshapes = None
    if not disable_posedirs:
        # zero-initialised, so predicted posedirs start as a no-op
        blendshapes = Linear(torch.zeros((hidden, 3 * 207), device=device),
                             torch.zeros(3 * 207, device=device))
    return DeformationDecoder(net0, net1, skinning_linear, skinning,
                              blendshapes)


def deformation_decoder_apply(p: DeformationDecoder, feats) -> dict:
    h = _trunk(p, feats)
    lbs = linear(p.skinning, gelu(weight_norm_linear(p.skinning_linear, h)))
    out = {"lbs_weights": gelu(lbs), "posedirs": None}
    if p.blendshapes is not None:
        pd = linear(p.blendshapes, h)          # (N, 621)
        out["posedirs"] = pd.reshape(207, -1)  # (207, 3N), reference layout
    return out
