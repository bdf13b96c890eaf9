"""The port's rendering API as it stood when the benchmark was written,
frozen, on its plain path only.

`render` projects, bins into 16x16 tiles and composites through the plain
PyTorch blend (render/blend.py) on any device: the forward is
`plain_blend`, the backward `plain_blend_bwd`, so the reference computes
the function that the CUDA kernels K1 and K2 compute, in plain float32
PyTorch. `render_human_scene` merges the human and scene Gaussian sets,
human first, into one depth-sorted blend.
"""
from __future__ import annotations

from typing import Any

import torch

from bench_port.reference.plain.render.blend import (
    gauss_features, plain_blend, plain_blend_bwd,
)
from bench_port.reference.plain.render.camera import Camera
from bench_port.reference.plain.render.oracle import clip01
from bench_port.reference.plain.render.project import (
    project_gaussians, update_mean2d,
)
from bench_port.reference.plain.render.tiles import TILE, bin_gaussians


class _PlainBlend(torch.autograd.Function):
    """plain_blend forward, plain_blend_bwd backward; differentiable in
    feat and bg. The backward re-runs each batch of tiles, so memory
    holds one batch's intermediates."""

    @staticmethod
    def forward(ctx, feat, gauss_id, starts, ends, bg, width, height):
        img = plain_blend(feat, gauss_id, starts, ends, bg, width,
                          height)[0]
        ctx.save_for_backward(feat, gauss_id, starts, ends, bg)
        ctx.size = (width, height)
        return img

    @staticmethod
    def backward(ctx, grad_img):
        feat, gauss_id, starts, ends, bg = ctx.saved_tensors
        grad_feat, grad_bg = plain_blend_bwd(feat, gauss_id, starts, ends,
                                             bg, *ctx.size,
                                             grad_img.contiguous())
        return grad_feat, None, None, None, grad_bg, None, None


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotq: torch.Tensor,
    opacity: torch.Tensor,
    shs: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    bg: torch.Tensor | None = None,
    active_sh_degree: torch.Tensor | int = 0,
    scaling_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
    mean2d_grad_hook: torch.Tensor | None = None,
    instance_budget: int | None = None,
) -> dict[str, Any]:
    """Render one view. Returns a dict with 'render' (3, H, W), 'radii'
    (N,), 'visibility_filter' (N,) bool, and the binning diagnostics
    'overflowed' (() bool), 'n_instances' and 'n_slots' (() int)."""
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    pg = project_gaussians(means3d, scales, rotq, opacity, shs, camera,
                           width, height, active_sh_degree, scaling_modifier,
                           alive=alive)
    if mean2d_grad_hook is not None:
        pg = update_mean2d(pg, mean2d_grad_hook)
    budget = instance_budget or max(4 * means3d.shape[0], 1 << 16)
    bins = bin_gaussians(pg, width, height, budget, TILE)
    img = clip01(_PlainBlend.apply(
        gauss_features(pg), bins.gauss_id, bins.starts, bins.ends,
        bg.to(torch.float32), width, height))
    return {
        "render": img,
        "radii": pg.radius,
        "visibility_filter": pg.mask & (pg.radius > 0),
        "overflowed": bins.overflowed,
        "n_instances": bins.n_instances,
        "n_slots": bins.n_slots,
    }


def render_human_scene(
    data: dict[str, Any],
    human_gs_out: dict[str, Any] | None,
    scene_gs_out: dict[str, Any] | None,
    bg_color: torch.Tensor,
    human_bg_color: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
    render_mode: str = "human_scene",
    render_human_separate: bool = False,
    **render_kw,
) -> dict[str, Any]:
    """Merged human+scene rendering. `data` carries the camera and image
    size: {'camera': Camera, 'width': int, 'height': int}; the Gaussian
    sets are the dicts human_forward and scene_forward return.

    The merged set renders at the HUMAN's active SH degree, as the JAX
    package does: at a freshly built avatar (degree 0) a scene trained to
    degree 3 renders with its DC term only.
    """
    camera: Camera = data["camera"]
    width, height = data["width"], data["height"]
    keys = ("xyz", "scales", "rotq", "shs", "opacity")

    if render_mode == "human_scene":
        attrs = {k: torch.cat([human_gs_out[k], scene_gs_out[k]], dim=0)
                 for k in keys}
        alive = None
        if "alive" in human_gs_out or "alive" in scene_gs_out:
            def alive_of(out):
                return out.get("alive", torch.ones(
                    out["xyz"].shape[0], dtype=torch.bool,
                    device=out["xyz"].device))
            alive = torch.cat([alive_of(human_gs_out),
                               alive_of(scene_gs_out)])
        # the human's degree for both sets, as in the JAX package
        sh_deg = human_gs_out["active_sh_degree"]
    elif render_mode == "human":
        attrs = {k: human_gs_out[k] for k in keys}
        alive = human_gs_out.get("alive")
        sh_deg = human_gs_out["active_sh_degree"]
    elif render_mode == "scene":
        attrs = {k: scene_gs_out[k] for k in keys}
        alive = scene_gs_out.get("alive")
        sh_deg = scene_gs_out["active_sh_degree"]
    else:
        raise ValueError(f"Unknown render mode: {render_mode}")

    pkg = render(attrs["xyz"], attrs["scales"], attrs["rotq"],
                 attrs["opacity"], attrs["shs"], camera, width, height,
                 bg=bg_color, active_sh_degree=sh_deg,
                 scaling_modifier=scaling_modifier, alive=alive,
                 **render_kw)

    if render_human_separate and render_mode == "human_scene":
        # the densification hook is sized for the merged set, and the
        # viewspace gradients come from the main pass only
        sep_kw = {k: v for k, v in render_kw.items()
                  if k != "mean2d_grad_hook"}
        if sep_kw.get("instance_budget"):
            sep_kw["instance_budget"] = max(
                4096, sep_kw["instance_budget"] // 2)
        hpkg = render(human_gs_out["xyz"], human_gs_out["scales"],
                      human_gs_out["rotq"], human_gs_out["opacity"],
                      human_gs_out["shs"], camera, width, height,
                      bg=(human_bg_color if human_bg_color is not None
                          else bg_color),
                      active_sh_degree=human_gs_out["active_sh_degree"],
                      scaling_modifier=scaling_modifier,
                      alive=human_gs_out.get("alive"),
                      **sep_kw)
        pkg["human_img"] = hpkg["render"]
        pkg["human_visibility_filter"] = hpkg["visibility_filter"]
        pkg["human_radii"] = hpkg["radii"]
        # an overflowing human pass triggers the same grow-and-retry;
        # 2x its demand, since its budget is half the merged one
        pkg["overflowed"] = pkg["overflowed"] | hpkg["overflowed"]
        pkg["n_instances"] = torch.maximum(pkg["n_instances"],
                                           2 * hpkg["n_instances"])
        pkg["n_slots"] = torch.maximum(pkg["n_slots"], 2 * hpkg["n_slots"])

    if render_mode == "human":
        pkg["human_visibility_filter"] = pkg["visibility_filter"]
        pkg["human_radii"] = pkg["radii"]
    elif render_mode == "human_scene":
        n_h = human_gs_out["xyz"].shape[0]
        pkg["scene_visibility_filter"] = pkg["visibility_filter"][n_h:]
        pkg["scene_radii"] = pkg["radii"][n_h:]
        if "human_visibility_filter" not in pkg:
            pkg["human_visibility_filter"] = pkg["visibility_filter"][:n_h]
            pkg["human_radii"] = pkg["radii"][:n_h]
    elif render_mode == "scene":
        pkg["scene_visibility_filter"] = pkg["visibility_filter"]
        pkg["scene_radii"] = pkg["radii"]
    return pkg
