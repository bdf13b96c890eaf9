"""Gaussian-sharded scene training: the scene's rows owned by the ranks of
a ('gauss',) mesh, rendered through the fragment exchange (the
counterpart of hugs_tpu/parallel/gauss_train.py).

  - Ownership: rank d keeps rows [d N/D, (d+1) N/D) of every
    per-Gaussian tensor, the parameters, the densification statistics
    and the Adam moments (shard_scene_state). Projection, binning and
    Adam run on the owner's rows only.
  - The step (make_gauss_scene_train_step) takes scene_train_step's
    arguments and gives its aux plus 'frag_counts' and 'n_visible'. L1 +
    SSIM is computed on the gathered frame, identically on every rank;
    the gather's backward sums the D ranks' equal cotangents, so each
    rank differentiates loss / D (as train_dp_tile.py divides by n_tile).
    The fragments' gradients reach their owners through the exchange's
    transpose.
  - The densification statistics come from the hook's gradient x
    (W/2, H/2), on the owner's rows.
  - The densify (gauss_densify_step) equals the single-device densify
    given the same split noise: every rank gathers the rows, runs
    scene_densify_step on the whole set identically, and keeps its own
    rows. It holds a whole copy of the state for the call: the
    parameters, both moments and the statistics, (59 x 3 + 3) float32
    and one bool a row at SH degree 3, 721 B a row (1.51 GB at
    2,097,152 rows). A densify on the owner's rows alone is later work
    (ROADMAP Queue 4).
"""
from __future__ import annotations

import torch

from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.parallel.collectives import all_gather, psum_
from hugs_tpu_torch.parallel.gauss_shard import local_rows, render_gauss_local
from hugs_tpu_torch.parallel.mesh import GAUSS, Mesh
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.train.optim import GroupAdamState
from hugs_tpu_torch.train.scene_step import (
    SceneTrainState, scene_densify_step, scene_grads, scene_loss,
    scene_update,
)

ROW_FIELDS = sgs.PARAM_FIELDS + ("alive", "max_radii2d",
                                 "xyz_gradient_accum", "denom")


def _map_state(state: SceneTrainState, rows_fn) -> SceneTrainState:
    """A new state of rows_fn(x) for every per-Gaussian tensor x; the
    scalars copied."""
    gs = state.gs
    fields = {f: rows_fn(getattr(gs, f).detach()) for f in ROW_FIELDS}
    fields["active_sh_degree"] = gs.active_sh_degree.clone()
    opt = state.opt
    return SceneTrainState(
        gs=sgs.SceneGS(**fields),
        opt=GroupAdamState(mu={k: rows_fn(v) for k, v in opt.mu.items()},
                           nu={k: rows_fn(v) for k, v in opt.nu.items()},
                           step=opt.step.clone()))


@torch.no_grad()
def shard_scene_state(state: SceneTrainState, mesh: Mesh,
                      axis: str = GAUSS) -> SceneTrainState:
    """This rank's rows of every per-Gaussian tensor of `state` (the same
    whole state on every rank), as a state of its own."""
    rows = local_rows(state.gs.capacity, mesh, axis)
    return _map_state(state, lambda x: x[rows].clone())


@torch.no_grad()
def gather_scene_state(state: SceneTrainState, mesh: Mesh,
                       axis: str = GAUSS) -> SceneTrainState:
    """The whole state from every rank's rows, on every rank (a
    collective)."""
    def gather(x):
        if x.dtype == torch.bool:
            return all_gather(x.to(torch.uint8), mesh, axis).bool()
        return all_gather(x.contiguous(), mesh, axis)
    return _map_state(state, gather)


@torch.no_grad()
def gauss_densify_step(state: SceneTrainState, mesh: Mesh,
                       noise: torch.Tensor, extent: float,
                       axis: str = GAUSS, **densify_kw):
    """scene_densify_step on the whole set, in place on this rank's rows
    (a collective). noise: (2, N, 3) for the whole capacity, the same on
    every rank. Returns (state, info)."""
    full = gather_scene_state(state, mesh, axis)
    _, info = scene_densify_step(full, noise, extent, **densify_kw)
    rows = local_rows(full.gs.capacity, mesh, axis)
    for f in ROW_FIELDS:
        getattr(state.gs, f).copy_(getattr(full.gs, f)[rows])
    for mine, whole in ((state.opt.mu, full.opt.mu),
                        (state.opt.nu, full.opt.nu)):
        for k, v in mine.items():
            v.copy_(whole[k][rows])
    return state, info


class GaussSceneStep:
    """The Gaussian-sharded scene step on `mesh`, for frames of width x
    height; call it on every rank of the mesh with this rank's state
    (shard_scene_state). Its stages are methods, so that a caller can
    time them: render, loss, grads, update."""

    def __init__(self, mesh: Mesh, *, width: int, height: int,
                 l1_w: float = 0.8, ssim_w: float = 0.2,
                 local_budget: int | None = None,
                 frag_cap: int | None = None, axis: str = GAUSS):
        self.mesh, self.axis = mesh, axis
        self.width, self.height = width, height
        self.l1_w, self.ssim_w = l1_w, ssim_w
        self.local_budget, self.frag_cap = local_budget, frag_cap

    def render(self, state: SceneTrainState, camera: Camera,
               bg: torch.Tensor):
        """The gathered frame of this rank's rows, with the hook: (pkg,
        hook) as render_gauss_local gives it."""
        gs = state.gs
        hook = torch.zeros((gs.capacity, 2), device=gs.xyz.device,
                           requires_grad=True)
        out = sgs.scene_forward(gs)
        pkg = render_gauss_local(
            out["xyz"], out["scales"], out["rotq"], out["opacity"],
            out["shs"], camera, self.width, self.height, self.mesh, bg=bg,
            active_sh_degree=out["active_sh_degree"], alive=out["alive"],
            local_budget=self.local_budget, frag_cap=self.frag_cap,
            mean2d_grad_hook=hook, axis=self.axis)
        return pkg, hook

    def loss(self, img: torch.Tensor, gt_image: torch.Tensor):
        return scene_loss(img, gt_image, self.l1_w, self.ssim_w)

    def grads(self, loss: torch.Tensor, state: SceneTrainState,
              hook: torch.Tensor):
        """This rank's gradients of its rows and of its hook (a
        collective: every rank's backward exchanges)."""
        return scene_grads(loss / self.mesh.axis_size(self.axis), state.gs,
                           hook)

    def update(self, state, grads, hook_grad, pkg, xyz_lr, static_lrs):
        return scene_update(state, grads, hook_grad, pkg, xyz_lr, static_lrs,
                            width=self.width, height=self.height)

    def __call__(self, state: SceneTrainState, camera: Camera,
                 gt_image: torch.Tensor, bg: torch.Tensor, xyz_lr,
                 static_lrs: dict):
        """One step in place on this rank's rows. Returns (state, aux):
        loss, psnr_mse, overflowed, frag_counts (D, D) and n_visible (over
        every rank)."""
        pkg, hook = self.render(state, camera, bg)
        img = pkg["render"]
        loss = self.loss(img, gt_image)
        grads, hook_grad = self.grads(loss, state, hook)
        self.update(state, grads, hook_grad, pkg, xyz_lr, static_lrs)
        with torch.no_grad():
            n_vis = pkg["visibility_filter"].sum().to(torch.float32)
            psum_([n_vis], self.mesh, self.axis)
            aux = {"loss": loss.detach(),
                   "psnr_mse": torch.mean((img - gt_image) ** 2),
                   "overflowed": pkg["overflowed"],
                   "frag_counts": pkg["frag_counts"],
                   "n_visible": n_vis.to(torch.int64)}
        return state, aux


def make_gauss_scene_train_step(mesh: Mesh, *, width: int, height: int,
                                l1_w: float = 0.8, ssim_w: float = 0.2,
                                local_budget: int | None = None,
                                frag_cap: int | None = None,
                                axis: str = GAUSS) -> GaussSceneStep:
    """The step, called as scene_train_step is: step(state, camera,
    gt_image, bg, xyz_lr, static_lrs) -> (state, aux)."""
    return GaussSceneStep(mesh, width=width, height=height, l1_w=l1_w,
                          ssim_w=ssim_w, local_budget=local_budget,
                          frag_cap=frag_cap, axis=axis)
