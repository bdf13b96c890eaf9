"""Public rendering API.

`render` takes flat Gaussian attributes and a camera and returns
{render, radii, visibility_filter, overflowed, n_instances, n_slots};
`render_human_scene` merges the human and scene Gaussian sets, human
first, into one depth-sorted blend (the ml-hugs gs_renderer contract).

A ('gauss',) mesh routes the render through the Gaussian-sharded
renderer (parallel/gauss_shard.py), which every rank of the mesh calls.

Backends: 'tiled' (default) bins into 16x16 tiles and blends through
cuda_blend.blend_tiles, which launches the CUDA kernels for CUDA tensors
(K1 forward, K2 backward) and runs the plain PyTorch blend under autograd
for CPU tensors, in the POWER_MXU mode where `power_mxu` (default
cuda_blend.POWER_MXU, from HUGS_POWER_MXU) says so; 'oracle' is the dense
reference. Inputs may carry an `alive` capacity mask; culled or dead
Gaussians render with radius 0.
"""
from __future__ import annotations

from typing import Any

import torch

from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.render.oracle import render_oracle
from hugs_tpu_torch.render.project import project_gaussians, update_mean2d
from hugs_tpu_torch.render.tiles import TILE, bin_gaussians
from hugs_tpu_torch.utils import profiling


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
    backend: str = "tiled",
    instance_budget: int | None = None,
    gauss_mesh=None,
    gauss_frag_cap: int | None = None,
    bin_only: bool = False,
    power_mxu: bool | None = None,
) -> dict[str, Any]:
    """Render one view. Returns a dict with 'render' (3, H, W), 'radii'
    (N,), 'visibility_filter' (N,) bool, and the binning diagnostics
    'overflowed' (() bool), 'n_instances' and 'n_slots' (() int).

    mean2d_grad_hook: an (N, 2) zero tensor added to the projected means;
    d(loss)/d(hook) is the pixel-space mean2d gradient.
    instance_budget: the binning's slot budget (default max(4N, 65536)).
    bin_only: stop after the binning (the 'tiled' backend): the dict has
    no 'render' and no blend kernel is launched; a slot-demand probe.
    gauss_mesh: a ('gauss',) mesh (parallel/mesh.py::make_gauss_mesh)
    renders through the Gaussian-sharded renderer on every rank of it,
    N divisible by its D ranks: instance_budget is then the global
    budget, max(budget // D, 4096) a rank; gauss_frag_cap bounds one
    (sender, band) packet; the dict adds 'frag_counts' (D, D), and
    'n_instances' and 'n_slots' are 0 (hugs_tpu/render/renderer.py:
    67-89). Not with bin_only.
    power_mxu: the blend kernels' POWER_MXU mode (the exponent on the
    tensor cores, render/cuda_blend.py); None takes cuda_blend.POWER_MXU.
    The 'tiled' backend's; the Gaussian-sharded route ignores it, as
    hugs_tpu's does."""
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    if gauss_mesh is not None:
        if bin_only or backend != "tiled":
            raise ValueError("the Gaussian-sharded renderer blends with the "
                             "'tiled' backend and has no bin_only probe")
        from hugs_tpu_torch.parallel.gauss_shard import render_gauss_sharded
        n_dev = gauss_mesh.axis_size("gauss")
        out = render_gauss_sharded(
            means3d, scales, rotq, opacity, shs, camera, width, height,
            gauss_mesh, bg=bg, active_sh_degree=active_sh_degree,
            scaling_modifier=scaling_modifier, alive=alive,
            local_budget=(max(instance_budget // n_dev, 1 << 12)
                          if instance_budget else None),
            frag_cap=gauss_frag_cap, mean2d_grad_hook=mean2d_grad_hook)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return dict(out, n_instances=zero, n_slots=zero)
    pg = project_gaussians(means3d, scales, rotq, opacity, shs, camera,
                           width, height, active_sh_degree, scaling_modifier,
                           alive=alive)
    if mean2d_grad_hook is not None:
        pg = update_mean2d(pg, mean2d_grad_hook)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_instances = n_slots = zero
    if backend == "oracle":
        img = render_oracle(pg, width, height, bg).permute(2, 0, 1)
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    elif backend == "tiled":
        budget = instance_budget or max(4 * means3d.shape[0], 1 << 16)
        with profiling.span("render.bin", device=True):
            bins = bin_gaussians(pg, width, height, budget, TILE)
        mxu = cuda_blend.POWER_MXU if power_mxu is None else power_mxu
        img = None if bin_only else cuda_blend.blend_tiles(
            pg, bins, width, height, bg, bool(mxu))
        overflowed = bins.overflowed
        n_instances = bins.n_instances
        n_slots = bins.n_slots
    else:
        raise ValueError(f"unknown backend: {backend}")

    out = {
        "radii": pg.radius,
        "visibility_filter": pg.mask & (pg.radius > 0),
        "overflowed": overflowed,
        "n_instances": n_instances,
        "n_slots": n_slots,
    }
    if img is not None:
        out["render"] = img
    return out


def render_human_scene(
    data: dict[str, Any],
    human_gs_out: dict[str, Any] | None,
    scene_gs_out: dict[str, Any] | None,
    bg_color: torch.Tensor,
    human_bg_color: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
    render_mode: str = "human_scene",
    render_human_separate: bool = False,
    backend: str = "tiled",
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
                 backend=backend, **render_kw)

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
                      backend=backend, **sep_kw)
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
