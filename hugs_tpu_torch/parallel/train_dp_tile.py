"""The joint training step over a ('data', 'tile') Mesh (the counterpart
of hugs_tpu/parallel/train_dp_tile.py), with the single-device step's
loss.

- 'data': each data rank trains on its share of the batch's frames
  (camera, pose row, target, mask, backgrounds and loss draws);
- 'tile': within a data rank's row, each tile rank projects the whole
  merged Gaussian set and blends one horizontal band of each frame (K1
  forward, K2 backward on the card); the bands are gathered over 'tile'
  and the loss (L1, SSIM, patch LPIPS, the humansep pass, LBS) runs on
  the gathered frame, identically on every tile rank;
- gradients are summed over both axes in one all-reduce. The gather's
  backward sums the n_tile identical cotangents of a pixel, so the
  pixel terms enter the objective divided by n_tile; the LBS term does
  not flow through pixels and enters on tile rank 0 only. The reported
  loss keeps its value;
- the densification statistics come from the summed mean2d hook
  gradient, the radii's maximum and the visibility's 'or' over 'data',
  split human rows first, as in the single-device step.

Each frame of the rank's share runs its forward and its backward before
the next frame's forward, the gradients accumulated: one frame's graph
in memory at a time (at config[3]'s capacities a frame's graph holds
gigabytes), at no cost in collectives (the gather's backward runs per
frame either way). Nothing is updated until `update`: a caller can read
the all-reduced overflow flag and run the step again at a grown budget,
on every rank alike, before any parameter moves.

mode='human' is the staged start before scene.opt_start_iter: the scene
is neither rendered nor differentiated, the loss runs in the human mode
and the scene's parameters and moments stay.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.parallel.collectives import all_gather, pany, pmax, psum_
from hugs_tpu_torch.parallel.mesh import Mesh
from hugs_tpu_torch.parallel.shard import blend_band
from hugs_tpu_torch.render.project import project_gaussians, update_mean2d
from hugs_tpu_torch.train import human_step as hst
from hugs_tpu_torch.train import joint_step as jst
from hugs_tpu_torch.train.optim import group_adam_update, leaves, pack

KEYS = ("xyz", "scales", "rotq", "opacity", "shs")


class DPGrads(NamedTuple):
    """A batch's gradients and diagnostics, reduced over the mesh."""
    h_grads: dict
    s_grads: dict | None
    hook_grad: torch.Tensor
    loss: torch.Tensor
    loss_dict: dict
    overflowed: torch.Tensor
    n_slots: torch.Tensor
    n_instances: torch.Tensor
    radii: torch.Tensor
    vis: torch.Tensor
    h_out: dict     # the canonical opacity, scales and rotations (frame 0)


class DPTileStep:
    """make_dp_tile_train_step's step: `grads` (forward and backward of
    the batch, reduced; nothing updated), `update` (Adam and the
    statistics) and, calling it, both."""

    def __init__(self, mesh: Mesh, fixed: hgs.HumanGSFixed,
                 cfg: hgs.HumanGSConfig, *, width: int, height: int,
                 loss_fn: HumanSceneLoss, lpips=None,
                 instance_budget: int = 1 << 14, optim_scene: bool = True,
                 mode: str = "human_scene"):
        if mode not in ("human_scene", "human"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mesh, self.fixed, self.cfg = mesh, fixed, cfg
        self.width, self.height = width, height
        self.loss_fn, self.lpips = loss_fn, lpips
        self.instance_budget = instance_budget
        self.human_only = mode == "human"
        self.optim_scene = optim_scene and not self.human_only
        self.separate = loss_fn.l_humansep_w > 0.0 and not self.human_only

    def _band(self, pg, bg, budget):
        """This rank's band of a projected set, gathered into the frame:
        (image (3, H, W), its band's bins)."""
        m = self.mesh
        img, bins = blend_band(pg, self.width, self.height, m.coords["tile"],
                               m.shape["tile"], budget, bg)
        return all_gather(img, m, "tile", dim=1)[:, :self.height], bins

    def _frame(self, jstate, fr: dict, hook: torch.Tensor, budget: int):
        """One frame's forward: (its objective, its diagnostics)."""
        W, H = self.width, self.height
        hs = jstate.human
        h_cap = hs.params.xyz.shape[0]
        h_out = hgs.human_forward(hs.params, hs.state, self.fixed, self.cfg,
                                  smpl_scale=fr["smpl_scale"],
                                  dataset_idx=fr["dataset_idx"])
        if self.human_only:
            attrs, alive = {k: h_out[k] for k in KEYS}, h_out["alive"]
            hook_used = hook[:h_cap]
        else:
            s_out = sgs.scene_forward(jstate.scene.gs)
            attrs = {k: torch.cat([h_out[k], s_out[k]]) for k in KEYS}
            alive = torch.cat([h_out["alive"], s_out["alive"]])
            hook_used = hook
        deg = h_out["active_sh_degree"]
        pg = project_gaussians(attrs["xyz"], attrs["scales"], attrs["rotq"],
                               attrs["opacity"], attrs["shs"], fr["camera"],
                               W, H, deg, alive=alive)
        pg = update_mean2d(pg, hook_used)
        img, bins = self._band(pg, fr["bg"], budget)
        pkg = {"render": img}
        overflowed, n_slots, n_inst = (bins.overflowed, bins.n_slots,
                                       bins.n_instances)
        radii, vis = pg.radius, pg.mask & (pg.radius > 0)
        h_radii, h_vis = radii[:h_cap], vis[:h_cap]
        if self.separate:
            # no hook on the human pass: the viewspace gradients come
            # from the merged pass only; half the budget, as
            # render_human_scene gives it, so its demand counts twice
            pg_h = project_gaussians(h_out["xyz"], h_out["scales"],
                                     h_out["rotq"], h_out["opacity"],
                                     h_out["shs"], fr["camera"], W, H, deg,
                                     alive=h_out["alive"])
            pkg["human_img"], bins_h = self._band(
                pg_h, fr["human_bg"], max(4096, budget // 2))
            overflowed = overflowed | bins_h.overflowed
            n_slots = torch.maximum(n_slots, 2 * bins_h.n_slots)
            n_inst = torch.maximum(n_inst, 2 * bins_h.n_instances)
            h_radii, h_vis = pg_h.radius, pg_h.mask & (pg_h.radius > 0)
        if self.human_only:
            s_cap = hook.shape[0] - h_cap
            radii = torch.cat([h_radii, h_radii.new_zeros(s_cap)])
            vis = torch.cat([h_vis, h_vis.new_zeros(s_cap)])
            total, loss_dict = hst.human_loss(
                self.loss_fn, fr["draws"], fr["rgb"], fr["mask"], fr["bg"],
                pkg, h_out, self.lpips)
        else:
            radii = torch.cat([h_radii, radii[h_cap:]])
            vis = torch.cat([h_vis, vis[h_cap:]])
            total, loss_dict = jst.joint_loss(
                self.loss_fn, fr["draws"], fr["rgb"], fr["mask"], fr["bg"],
                fr["human_bg"], pkg, h_out, self.lpips)
        lbs = loss_dict.get("lbs", torch.zeros_like(total))
        gate = float(self.mesh.coords["tile"] == 0)
        objective = (total - lbs) / self.mesh.shape["tile"] + gate * lbs
        return objective, dict(total=total.detach(), loss_dict={
            k: v.detach() for k, v in loss_dict.items()},
            overflowed=overflowed, n_slots=n_slots, n_instances=n_inst,
            radii=radii.detach(), vis=vis, h_out={
                k: h_out[k].detach() for k in ("opacity", "scales_canon",
                                               "rotmat_canon")})

    def grads(self, jstate, frames: list, budget: int | None = None
              ) -> DPGrads:
        """The batch's forward and backward on this rank's share of
        `frames`, one frame at a time, then the reductions over the mesh.
        `frames` is the whole batch, the same list on every rank, its
        length a multiple of n_data; a frame is a dict of the camera, the
        target 'rgb' (3, H, W) and its 'mask' (H, W), the step's 'bg' and
        the human pass's 'human_bg' (3,), the 'smpl_scale', the frame's
        row of the pose tables 'dataset_idx' and the loss's 'draws'.
        `budget` is each band's slot budget (default the step's). Updates
        nothing."""
        m = self.mesh
        local = frames[m.local_slice(len(frames))]
        budget = budget or self.instance_budget
        hs = jstate.human
        h_cap = hs.params.xyz.shape[0]
        n_rows = h_cap + jstate.scene.gs.capacity
        h_groups = hgs.params_of(hs.params)
        s_params = ({} if self.human_only
                    else sgs.params_of(jstate.scene.gs))
        flat = leaves(h_groups) + list(s_params.values())
        hook = torch.zeros((n_rows, 2), device=hs.params.xyz.device,
                           requires_grad=True)
        sums = [torch.zeros_like(p) for p in flat] + [torch.zeros_like(hook)]
        scale = 1.0 / (m.shape["data"] * len(local))
        auxs = []
        for fr in local:
            objective, aux = self._frame(jstate, fr, hook, budget)
            got = torch.autograd.grad(objective * scale, flat + [hook],
                                      allow_unused=True)
            for s, g in zip(sums, got):
                if g is not None:
                    s.add_(g)
            auxs.append(aux)
            del objective, got
        # the local batch: mean losses, any overflow, largest demand,
        # radii's maximum and visibility's 'or' over its frames
        names = sorted(auxs[0]["loss_dict"])
        terms = torch.stack([a["total"] for a in auxs]).mean()[None]
        terms = torch.cat([terms] + [torch.stack(
            [a["loss_dict"][k] for a in auxs]).mean()[None] for k in names])
        # one all-reduce: the gradients, the hook's and the loss terms
        psum_(sums + [terms], m)
        terms /= m.size
        flags = torch.stack([
            torch.stack([a["overflowed"] for a in auxs]).any().to(
                torch.int64),
            torch.stack([a["n_slots"] for a in auxs]).max(),
            torch.stack([a["n_instances"] for a in auxs]).max()])
        flags = pmax(flags, m)
        radii = pmax(torch.stack([a["radii"] for a in auxs]).amax(0), m,
                     "data")
        vis = pany(torch.stack([a["vis"] for a in auxs]).any(0), m, "data")
        n_h = len(leaves(h_groups))
        return DPGrads(
            h_grads=pack(h_groups, list(sums[:n_h])),
            s_grads=(None if self.human_only
                     else dict(zip(s_params, sums[n_h:-1]))),
            hook_grad=sums[-1], loss=terms[0],
            loss_dict={k: terms[i + 1] for i, k in enumerate(names)},
            overflowed=flags[0] > 0, n_slots=flags[1], n_instances=flags[2],
            radii=radii, vis=vis, h_out=auxs[0]["h_out"])

    @torch.no_grad()
    def update(self, jstate, g: DPGrads, human_xyz_lr, human_static_lrs,
               scene_xyz_lr, scene_static_lrs):
        """Adam on the human groups and, with optim_scene in the joint
        mode, the scene's parameters; then both sets' statistics. In
        place; identical on every rank, which all hold the same reduced
        gradients."""
        hs, ss = jstate
        group_adam_update(g.h_grads, hs.opt, hgs.params_of(hs.params),
                          dict(human_static_lrs, xyz=human_xyz_lr))
        if self.optim_scene:
            group_adam_update(g.s_grads, ss.opt, sgs.params_of(ss.gs),
                              dict(scene_static_lrs, xyz=scene_xyz_lr))
        h_cap = hs.params.xyz.shape[0]
        vs = g.hook_grad * torch.tensor([0.5 * self.width, 0.5 * self.height],
                                        device=g.hook_grad.device)
        hgs.add_densification_stats(hs.state, vs[:h_cap], g.radii[:h_cap],
                                    g.vis[:h_cap])
        sgs.add_densification_stats(ss.gs, vs[h_cap:], g.radii[h_cap:],
                                    g.vis[h_cap:])
        return jstate

    def __call__(self, jstate, frames: list, human_xyz_lr, human_static_lrs,
                 scene_xyz_lr, scene_static_lrs, budget: int | None = None):
        """grads then update, in place on jstate. Returns (jstate, aux)
        with the loss, its terms, the overflow flag, the slot and
        instance demand and the canonical quantities the human densify
        reads."""
        g = self.grads(jstate, frames, budget)
        self.update(jstate, g, human_xyz_lr, human_static_lrs, scene_xyz_lr,
                    scene_static_lrs)
        return jstate, dp_aux(g)


def dp_aux(g: DPGrads) -> dict:
    """The step's diagnostics in joint_step.step_aux's keys (no image)."""
    return {"loss": g.loss, "loss_dict": g.loss_dict,
            "overflowed": g.overflowed, "n_slots": g.n_slots,
            "n_instances": g.n_instances, **g.h_out}


def make_dp_tile_train_step(mesh: Mesh, fixed: hgs.HumanGSFixed,
                            cfg: hgs.HumanGSConfig, *, width: int,
                            height: int, loss_fn: HumanSceneLoss | None = None,
                            lpips=None, instance_budget: int = 1 << 14,
                            optim_scene: bool = True,
                            mode: str = "human_scene") -> DPTileStep:
    """The data x tile joint step on `mesh` at width x height:
    step(jstate, frames, h_xyz_lr, h_static_lrs, s_xyz_lr, s_static_lrs)
    -> (jstate, aux), in place; `frames` is the whole batch, the same on
    every rank. instance_budget is per band."""
    return DPTileStep(mesh, fixed, cfg, width=width, height=height,
                      loss_fn=loss_fn or HumanSceneLoss(), lpips=lpips,
                      instance_budget=instance_budget,
                      optim_scene=optim_scene, mode=mode)
