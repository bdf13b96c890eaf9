"""Training orchestration: the port's GaussianTrainer.

The host loop around the training steps, as the JAX package's trainer
runs it (reference hugs/trainer/gs_trainer.py:70-747) at batch size 1:
building the human and scene models (with the init distillation), the
train loop in the scene, human and human_scene modes (human until
scene.opt_start_iter, then joint), the instance budget grown on demand
with a retry of a step that overflowed it, the densify / opacity reset /
SH ramp / checkpoint / validation cadence, and the evaluation metrics
(PSNR, SSIM and LPIPS of the whole frame and of the human's box).

Random draws: the frame order is np.random.RandomState(cfg.seed)'s, so
the port visits frames in the JAX package's order; every other draw
(the per-step backgrounds, the loss's LPIPS background and patches, the
densify's split noise, the nets' initialisation) comes from one
torch.Generator on the trainer's device, seeded from cfg.seed.

A step that overflowed its instance budget (checked on sync steps, as
the JAX package does) is rendered again at the grown budget before
anything is updated: the forward is a separate stage from the update,
so no copy of the states is needed for the retry.

Not here yet: train.batch_size > 1 and the Gaussian-sharded renders
(the scale-out slice; cfg.check_supported refuses them), the progress
strip, the iteration-0 dumps, animate and render_canonical (the
animation slice).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from hugs_tpu_torch.cfg import Config, check_supported
from hugs_tpu_torch.losses.basic import psnr, ssim
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.losses.lpips import LPIPS
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.models.smpl import load_smpl, synthetic_smpl
from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
from hugs_tpu_torch.render.renderer import render_human_scene
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train import human_step as hst
from hugs_tpu_torch.train import joint_step as jst
from hugs_tpu_torch.train import scene_step as sst
from hugs_tpu_torch.utils.image import save_image_grid
from hugs_tpu_torch.utils.ply import save_gaussian_ply


def _budget_bucket(needed: int) -> int:
    """A required instance count rounded up to the next budget bucket:
    multiples of 32768 with 1.25x headroom, at least 65536, so that a
    growing population grows the budget O(log) times while wasting far
    less than power-of-two sizes (binning pays for the whole budget)."""
    step = 32768
    return max(1 << 16, -(-(needed * 5 // 4) // step) * step)


class GaussianTrainer:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 smpl_model=None, device: torch.device | str = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.eval_metrics: dict[str, Any] = {}
        self.rng = np.random.RandomState(cfg.seed)
        self.gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
        self._overflow_checked: set = set()
        self._budget_rehearsed = False
        self.retries = 0      # steps rendered again at a grown budget
        self.bg_color = (torch.ones(3, device=dev) if cfg.bg_color == "white"
                         else torch.zeros(3, device=dev))
        self.lpips = LPIPS.create(cfg.tpu.lpips_weights or None, device=dev)

        # ---- human model
        self.human = self.human_cfg = self.fixed = None
        self._h_cap = self._s_cap = 0
        if cfg.mode in ("human", "human_scene"):
            smpl = smpl_model
            if smpl is None:
                smpl_dir = os.path.join(cfg.dataset_path or "data", "smpl")
                smpl = (load_smpl(smpl_dir, device=dev)
                        if os.path.exists(smpl_dir) else synthetic_smpl(
                            int(cfg.tpu.get("smpl_vpb", 32) or 32),
                            device=dev))
            template = smpl
            if cfg.human.n_subdivision > 0:
                template = subdivide_smpl_model(
                    smpl, smoothing=True, n_iter=cfg.human.n_subdivision)
            h = cfg.human
            self.human_cfg = hgs.HumanGSConfig(
                triplane_res=h.triplane_res, use_deformer=h.use_deformer,
                disable_posedirs=h.disable_posedirs,
                use_surface=h.use_surface, init_2d=h.init_2d,
                isotropic=h.isotropic,
                init_scale_multiplier=h.init_scale_multiplier)
            ds = train_dataset or val_dataset
            n_frames = len(ds) if ds else 1
            betas = np.asarray(ds[0]["betas"]) if ds else np.zeros(10)
            cap = cfg.tpu.human_capacity or int(h.max_n_gaussians)
            self._h_cap = cap = max(cap, template.n_verts)
            poses = {}
            if train_dataset is not None:
                poses = {f"init_{k}": np.stack([np.asarray(d[k])
                                                for d in train_dataset])
                         for k in ("body_pose", "global_orient", "transl")}
            params, state, fixed, init_values = hgs.init_human_gs(
                self.gen, self.human_cfg, smpl, template, betas, n_frames,
                capacity=cap, **poses)
            self.fixed = fixed
            self.init_values = init_values
            if not cfg.eval and h.run_init:
                hst.distill_init(params, state, init_values, self.human_cfg,
                                 num_steps=h.get("init_steps", 7000))
            self.human = hst.init_human_train_state(params, state)
            self.h_static_lrs, self.h_xyz_sched = hst.make_human_lrs(
                h.lr, optim_pose=h.optim_pose, optim_betas=h.optim_betas,
                optim_trans=h.optim_trans)

        # ---- scene model
        self.scene = None
        if cfg.mode in ("scene", "human_scene"):
            pcd_src = train_dataset if train_dataset is not None else (
                val_dataset if val_dataset is not None
                and hasattr(val_dataset, "init_pcd") else None)
            if pcd_src is not None:
                pts, cols = pcd_src.init_pcd
                self.scene_extent = pcd_src.radius
            else:
                # no dataset (tests): a small placeholder cloud that does
                # not raise the capacity past the configuration's
                pts = np.random.RandomState(0).uniform(
                    -3, 3, (8, 3)).astype(np.float32) + [0, 0, 4]
                cols = np.full((8, 3), 0.5, np.float32)
                self.scene_extent = 4.0
            cap = cfg.tpu.scene_capacity or int(cfg.scene.max_n_gaussians)
            self._s_cap = cap = max(cap, pts.shape[0])
            self.scene = sst.init_scene_train_state(sgs.create_from_pcd(
                pts, cols, cap, max_sh_degree=cfg.scene.sh_degree,
                device=dev))
            self.s_static_lrs, self.s_xyz_sched = sst.make_scene_lrs(
                cfg.scene.lr, self.scene_extent)

        # the instance budget: fixed by the configuration, or sized from
        # the capacities and grown on demand (_check_budget)
        self._ibudget = int(cfg.tpu.instance_budget) or _budget_bucket(
            4 * (self._h_cap + self._s_cap))
        self._ibudget_fixed = bool(int(cfg.tpu.instance_budget))

        loss = cfg.human.loss if cfg.mode != "scene" else cfg.scene.loss
        self.loss_fn = HumanSceneLoss(
            l_ssim_w=loss.ssim_w, l_l1_w=loss.l1_w,
            l_lpips_w=loss.get("lpips_w", 0.0),
            l_lbs_w=loss.get("lbs_w", 0.0),
            l_humansep_w=loss.get("humansep_w", 0.0),
            num_patches=loss.get("num_patches", 4),
            patch_size=loss.get("patch_size", 128),
            use_patches=bool(loss.get("use_patches", True)))

        if cfg.logdir_ckpt and os.path.isdir(cfg.logdir_ckpt):
            self.load_latest_ckpt()

    # ------------------------------------------------------------ budget

    def _check_budget(self, ni: int, overflowed: bool, ninst: int) -> bool:
        """Grows the instance budget from the measured slot demand `ni`
        (instances plus alignment padding) when a step overflowed it or
        filled three quarters of it; returns whether it overflowed, in
        which case the caller renders the step again at the new budget.
        The headroom scales the instances, not the padding, which depends
        on the tile grid only."""
        if self._ibudget_fixed:
            return False
        if overflowed or ni * 4 >= self._ibudget * 3:
            waste = max(ni - ninst, 0)
            new = _budget_bucket(max(ninst * 3 // 2 + waste, self._ibudget))
            if new > self._ibudget:
                print(f"instance budget: {self._ibudget} -> {new} "
                      f"(n_slots={ni}"
                      f"{', overflowed — retrying step' if overflowed else ''})")
                self._ibudget = new
        return overflowed

    def _is_sync_step(self, t_iter: int) -> bool:
        """The steps whose loss and slot counts are read back: every 10th,
        and the steps right after either model's densify or opacity reset
        (the only jumps in the instance count)."""
        if t_iter % 10 == 0:
            return True
        cfg = self.cfg
        for prev in (t_iter - 1, t_iter):
            its = prev + 1
            if self.human is not None \
                    and its <= cfg.human.densify_until_iter \
                    and its % cfg.human.densification_interval == 0:
                return True
            if self.scene is not None:
                it = (prev - max(cfg.scene.opt_start_iter, 0)) + 1
                if it <= cfg.scene.densify_until_iter and (
                        it % cfg.scene.densification_interval == 0
                        or it % cfg.scene.opacity_reset_interval == 0):
                    return True
        return False

    # ------------------------------------------------------------- train

    def train(self):
        cfg = self.cfg
        n = len(self.train_dataset)
        order = self.rng.permutation(n)
        pos = 0
        log = []
        t_start = time.time()
        for t_iter in range(cfg.train.num_steps + 1):
            if pos >= n:
                order = self.rng.permutation(n)
                pos = 0
            idx = int(order[pos])
            pos += 1
            data = self.train_dataset[idx]
            aux, vals = self._train_step(t_iter, idx, data,
                                         self._is_sync_step(t_iter))
            if t_iter % 10 == 0 and vals is not None:
                rec = {"iter": t_iter, "loss": vals[0],
                       "elapsed_s": time.time() - t_start}
                log.append(rec)
                self._log_jsonl(rec)
                if vals[2] and self._ibudget_fixed:
                    print(f"WARNING: tile-instance budget overflow at iter "
                          f"{t_iter}: raise tpu.instance_budget (dropped "
                          f"Gaussian instances degrade quality)")
            self._periodic(t_iter, aux, data)
        # the final checkpoint: the interval ones miss the last steps
        if cfg.logdir and cfg.train.num_steps % \
                cfg.train.save_ckpt_interval != 0:
            self.save_ckpt(cfg.train.num_steps)
        return log

    def _mode(self, t_iter: int) -> str:
        """human_scene trains the human alone until scene.opt_start_iter
        (reference gs_trainer.py:248-252)."""
        mode = self.cfg.mode
        if mode == "human_scene" and t_iter < self.cfg.scene.opt_start_iter:
            return "human"
        return mode

    def _step_draws(self, mode: str, height: int, width: int):
        """The step's draws from the trainer's generator: the background,
        the human pass's background (human_scene) and the loss's."""
        gen, dev = self.gen, self.device
        bg = torch.rand(3, generator=gen, device=gen.device).to(dev)
        human_bg = (torch.rand(3, generator=gen, device=gen.device).to(dev)
                    if mode == "human_scene" else None)
        draws = self.loss_fn.draws(gen, height, width, mode, device=dev)
        return bg, human_bg, draws

    def _forward(self, mode, t_iter, idx, data, bg, human_bg, draws):
        """The step's render and loss, nothing updated: (loss, a dict of
        what the update reads)."""
        W, H = data["width"], data["height"]
        cam, gt, mask = data["camera"], data["rgb"], data["mask"]
        scale = torch.as_tensor(data["smpl_scale"], dtype=torch.float32,
                                device=self.device).reshape(())
        budget = self._ibudget
        lpips = self.lpips if self.loss_fn.l_lpips_w > 0 else None
        if mode == "scene":
            hook = torch.zeros((self._s_cap, 2), device=self.device,
                               requires_grad=True)
            pkg = sst.scene_render(self.scene.gs, cam, bg, hook, width=W,
                                   height=H, instance_budget=budget)
            l = self.cfg.scene.loss
            loss = sst.scene_loss(pkg["render"], gt, l.l1_w, l.ssim_w)
            return loss, dict(pkg=pkg, hook=hook, loss_dict={})
        if mode == "human":
            hook = torch.zeros((self._h_cap, 2), device=self.device,
                               requires_grad=True)
            pkg, out = hst.human_render(
                self.human, self.fixed, cam, bg, hook, scale, idx,
                cfg=self.human_cfg, width=W, height=H, instance_budget=budget)
            loss, loss_dict = hst.human_loss(self.loss_fn, draws, gt, mask,
                                             bg, pkg, out, lpips)
            return loss, dict(pkg=pkg, hook=hook, out=out,
                              loss_dict=loss_dict)
        jstate = jst.JointTrainState(human=self.human, scene=self.scene)
        hook = torch.zeros((self._h_cap + self._s_cap, 2),
                           device=self.device, requires_grad=True)
        pkg, out = jst.joint_render(
            jstate, self.fixed, cam, bg, human_bg, hook, scale, idx,
            cfg=self.human_cfg, width=W, height=H, instance_budget=budget,
            render_human_separate=self.loss_fn.l_humansep_w > 0)
        loss, loss_dict = jst.joint_loss(self.loss_fn, draws, gt, mask, bg,
                                         human_bg, pkg, out, lpips)
        return loss, dict(pkg=pkg, hook=hook, out=out, loss_dict=loss_dict)

    def _train_step(self, t_iter, idx, data, sync: bool):
        """One step in place: draws, forward (again at a grown budget if
        a sync step overflowed), gradients, Adam and statistics, then the
        densify where due. Returns (aux, the sync step's (loss, slots,
        overflowed, instances) or None)."""
        cfg = self.cfg
        mode = self._mode(t_iter)
        W, H = data["width"], data["height"]
        bg, human_bg, draws = self._step_draws(mode, H, W)
        vals = None
        for attempt in range(3):
            self.retries += attempt > 0
            loss, fw = self._forward(mode, t_iter, idx, data, bg, human_bg,
                                     draws)
            if not sync:
                break
            pkg = fw["pkg"]
            v = torch.stack([loss.detach().double()] + [
                pkg[k].double() for k in ("n_slots", "overflowed",
                                          "n_instances")]).tolist()
            vals = (v[0], int(v[1]), bool(v[2]), int(v[3]))
            if not self._check_budget(vals[1], vals[2], vals[3]):
                break
        else:
            print(f"WARNING: tile-instance budget overflow persists at iter "
                  f"{t_iter} (budget={self._ibudget})")
        pkg, hook = fw["pkg"], fw["hook"]
        if mode == "scene":
            grads, hook_grad = sst.scene_grads(loss, self.scene.gs, hook)
            sst.scene_update(self.scene, grads, hook_grad, pkg,
                             self.s_xyz_sched(t_iter), self.s_static_lrs,
                             width=W, height=H)
            aux = {"loss": loss.detach(), "overflowed": pkg["overflowed"],
                   "n_instances": pkg["n_instances"],
                   "n_slots": pkg["n_slots"]}
            self._maybe_densify_scene(t_iter)
        elif mode == "human":
            grads, hook_grad = hst.human_grads(loss, self.human.params, hook)
            hst.human_update(self.human, grads, hook_grad, pkg,
                             self.h_xyz_sched(t_iter), self.h_static_lrs,
                             width=W, height=H)
            aux = jst.step_aux(loss, fw["loss_dict"], pkg, fw["out"])
            self._maybe_densify_human(t_iter, aux)
        else:
            jstate = jst.JointTrainState(human=self.human, scene=self.scene)
            h_grads, s_grads, hook_grad = jst.joint_grads(
                loss, jstate, hook, cfg.train.optim_scene)
            jst.joint_update(
                jstate, h_grads, s_grads, hook_grad, pkg,
                self.h_xyz_sched(t_iter), self.h_static_lrs,
                self.s_xyz_sched(t_iter), self.s_static_lrs, width=W,
                height=H)
            aux = jst.step_aux(loss, fw["loss_dict"], pkg, fw["out"])
            self._maybe_densify_human(t_iter, aux)
            self._maybe_densify_scene(t_iter)
        return aux, vals

    def _split_noise(self, capacity: int) -> torch.Tensor:
        """A densify's split noise, (2, capacity, 3) standard normal."""
        return torch.randn((2, capacity, 3), generator=self.gen,
                           device=self.gen.device).to(self.device)

    def _maybe_densify_scene(self, t_iter: int):
        cfg = self.cfg
        it = (t_iter - max(cfg.scene.opt_start_iter, 0)) + 1
        if self.scene is None or it > cfg.scene.densify_until_iter:
            return
        if it > cfg.scene.densify_from_iter \
                and it % cfg.scene.densification_interval == 0:
            size_thresh = 20.0 if it > cfg.scene.opacity_reset_interval \
                else None
            sst.scene_densify_step(
                self.scene, self._split_noise(self._s_cap),
                float(self.scene_extent),
                grad_threshold=cfg.scene.densify_grad_threshold,
                min_opacity=cfg.scene.prune_min_opacity,
                max_screen_size=size_thresh,
                percent_dense=cfg.scene.percent_dense,
                max_n_gaussians=int(cfg.scene.max_n_gaussians))
        if it % cfg.scene.opacity_reset_interval == 0 or (
                cfg.bg_color == "white" and it == cfg.scene.densify_from_iter):
            # nothing is split at an infinite threshold: no noise is drawn
            sst.scene_densify_step(
                self.scene, torch.zeros((2, self._s_cap, 3),
                                        device=self.device),
                float(self.scene_extent), grad_threshold=np.inf,
                min_opacity=0.0, do_reset_opacity=True)

    def _maybe_densify_human(self, t_iter: int, aux: dict):
        cfg = self.cfg
        it = t_iter + 1
        if self.human is None or it > cfg.human.densify_until_iter:
            return
        if it > cfg.human.densify_from_iter \
                and it % cfg.human.densification_interval == 0:
            out = {k: aux[k] for k in ("opacity", "scales_canon",
                                       "rotmat_canon")}
            hst.human_densify_step(
                self.human, out, self._split_noise(self._h_cap),
                float(cfg.human.densify_extent),
                grad_threshold=cfg.human.densify_grad_threshold,
                min_opacity=cfg.human.prune_min_opacity,
                max_screen_size=20.0,
                percent_dense=cfg.human.lr.percent_dense,
                max_n_gaussians=int(cfg.human.max_n_gaussians))

    def _periodic(self, t_iter: int, aux: dict, data=None):
        """The SH one-up every 1000 steps; with a logdir, the train-view
        dump every 1000, the checkpoint and validation at their
        intervals."""
        cfg = self.cfg
        if t_iter % 1000 == 0 and t_iter > 0:
            if self.human is not None:
                hgs.one_up_sh_degree(self.human.state, cfg.human.sh_degree)
            if self.scene is not None:
                sgs.one_up_sh_degree(self.scene.gs, cfg.scene.sh_degree)
        if not cfg.logdir or t_iter == 0:
            return
        if t_iter % 1000 == 0 and data is not None:
            # the train view, target beside render (gs_trainer.py:307-314)
            pkg = self.render_frame(data)
            save_image_grid([data["rgb"], pkg["render"]],
                            f"{cfg.logdir}/train/{t_iter:06d}.png")
        if t_iter % cfg.train.save_ckpt_interval == 0:
            self.save_ckpt(t_iter)
        if t_iter % cfg.train.val_interval == 0 \
                and self.val_dataset is not None:
            self.validate(t_iter)

    def _log_jsonl(self, rec: dict):
        """One record appended to logdir/metrics.jsonl."""
        if not self.cfg.logdir:
            return
        with open(os.path.join(self.cfg.logdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # --------------------------------------------------------- rendering

    def _pose_kw(self, data) -> dict:
        """The frame's SMPL parameters as tensors on the device."""
        dev = self.device
        z3 = np.zeros(3, np.float32)
        return dict(
            global_orient=torch.as_tensor(
                np.asarray(data.get("global_orient", z3), np.float32),
                device=dev),
            body_pose=torch.as_tensor(np.asarray(
                data.get("body_pose", np.zeros(69)), np.float32), device=dev),
            betas=torch.as_tensor(np.asarray(
                data.get("betas", np.zeros(10)), np.float32), device=dev),
            transl=torch.as_tensor(np.asarray(data.get("transl", z3),
                                              np.float32), device=dev),
            smpl_scale=torch.as_tensor(
                np.asarray(data.get("smpl_scale", 1.0), np.float32),
                device=dev).reshape(()))

    @torch.no_grad()
    def forward_models(self, data):
        """(human_forward's dict, scene_forward's dict) for one frame,
        posed by the frame's SMPL parameters, without the skinning
        targets; None for a model the trainer lacks."""
        h_out = s_out = None
        if self.human is not None:
            h_out = hgs.human_forward(
                self.human.params, self.human.state, self.fixed,
                self.human_cfg, dataset_idx=0, compute_gt_lbs=False,
                **self._pose_kw(data))
        if self.scene is not None:
            s_out = sgs.scene_forward(self.scene.gs)
        return h_out, s_out

    @torch.no_grad()
    def render_frame(self, data, render_mode: str | None = None, bg=None,
                     budget: int | None = None):
        """Renders one frame at the trainer's budget (or `budget`).
        After rehearse_budget, the first render of each (mode, size,
        budget) is checked for an overflow."""
        render_mode = render_mode or self.cfg.mode
        if render_mode == "human_scene" and self.scene is None:
            render_mode = "human"
        if self.human is None and render_mode != "scene":
            render_mode = "scene"
        budget = int(budget or self._ibudget)
        h_out, s_out = self.forward_models(data)
        W, H = data["width"], data["height"]
        out = render_human_scene(
            {"camera": data["camera"], "width": W, "height": H}, h_out,
            s_out, bg_color=self.bg_color if bg is None else bg,
            render_mode=render_mode, instance_budget=budget)
        key = (render_mode, W, H, budget)
        if self._budget_rehearsed and key not in self._overflow_checked:
            self._overflow_checked.add(key)
            if bool(out["overflowed"]):
                print(f"WARNING: instance budget {budget} overflowed on a "
                      f"render outside the rehearsal ({render_mode} {W}x{H})"
                      f": the image drops instances; rehearse with these "
                      f"frames included")
        return out

    # -------------------------------------------------------- validation

    @torch.no_grad()
    def _human_crop_metrics(self, img, gt, x0: int, y0: int, h: int,
                            w: int):
        """PSNR, SSIM and LPIPS of the human's box, rows x0 .. x0 + h,
        columns y0 .. y0 + w (reference gs_trainer.py:513-521). LPIPS runs
        through crop_call with the box at the origin of a zero canvas
        rounded up to 64 px (at most the frame), as the JAX package does:
        a tap that VALID pooling shrinks to nothing (a box under 16 px)
        then adds 0 where a network on the crop alone has no pixel."""
        a = img[:, x0:x0 + h, y0:y0 + w]
        b = gt[:, x0:x0 + h, y0:y0 + w]
        bh = min(-(-h // 64) * 64, img.shape[1])
        bw = min(-(-w // 64) * 64, img.shape[2])
        canvas = img.new_zeros((2, 3, bh, bw))
        canvas[0, :, :h, :w] = torch.minimum(a, a.new_ones(()))
        canvas[1, :, :h, :w] = b
        lp = self.lpips.crop_call(canvas[:1], canvas[1:], h, w)[0]
        return psnr(a, b), ssim(a, b), lp

    @torch.no_grad()
    def _val_frame(self, data, bg):
        """One evaluation frame: its render and the whole frame's PSNR,
        SSIM and LPIPS (the prediction clipped to at most 1 for LPIPS)."""
        mode = self.cfg.mode if (self.scene is not None
                                 or self.cfg.mode != "human_scene") \
            else "human"
        h_out, s_out = self.forward_models(data)
        pkg = render_human_scene(
            {"camera": data["camera"], "width": data["width"],
             "height": data["height"]}, h_out, s_out, bg_color=bg,
            render_mode=mode, instance_budget=self._ibudget)
        img, gt = pkg["render"], data["rgb"]
        lp = self.lpips(torch.minimum(img, img.new_ones(()))[None],
                        gt[None])[0]
        return img, psnr(img, gt), ssim(img, gt), lp

    def validate(self, t_iter: int | None = None) -> dict:
        cfg = self.cfg
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        bg = torch.zeros(3, device=self.device)
        metrics: dict[str, list] = {}
        # without pretrained VGG weights the LPIPS numbers are consistent
        # among themselves but not comparable to the reference's
        lp_key = "hugs_lpips" if self.lpips.has_pretrained \
            else "hugs_lpips_uncalibrated"
        for idx in range(len(self.val_dataset)):
            data = self.val_dataset[idx]
            img, p_full, s_full, l_full = self._val_frame(data, bg)
            metrics.setdefault("hugs_psnr", []).append(float(p_full))
            metrics.setdefault("hugs_ssim", []).append(float(s_full))
            metrics.setdefault(lp_key, []).append(float(l_full))
            if cfg.mode in ("human", "human_scene") and "bbox" in data:
                x0, y0, x1, y1 = [int(v) for v in np.asarray(data["bbox"])]
                h, w = x1 - x0 + 1, y1 - y0 + 1
                if min(h, w) >= 8:
                    p, s, lp = self._human_crop_metrics(img, data["rgb"], x0,
                                                        y0, h, w)
                    metrics.setdefault("hugs_human_psnr", []).append(
                        float(p))
                    metrics.setdefault("hugs_human_ssim", []).append(
                        float(s))
                    metrics.setdefault(lp_key.replace(
                        "hugs_", "hugs_human_"), []).append(float(lp))
            if cfg.logdir:
                save_image_grid([data["rgb"], img],
                                f"{cfg.logdir}/val/full_{iter_s}_{idx:03d}.png")
        out = {k: float(np.mean(v)) for k, v in metrics.items() if v}
        self.eval_metrics[iter_s] = out
        self._log_jsonl({"eval": iter_s, **out})
        if cfg.logdir:
            os.makedirs(f"{cfg.logdir}/val", exist_ok=True)
            with open(f"{cfg.logdir}/val/eval_{iter_s}.json", "w") as f:
                json.dump(out, f, indent=2)
        return out

    # ------------------------------------------------------- checkpoints

    def save_ckpt(self, t_iter: int | None = None):
        """Both train states under logdir_ckpt, and the scene's live
        Gaussians as a 3DGS PLY under logdir/meshes."""
        if not self.cfg.logdir_ckpt:
            return
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        ckpt_io.save(self.cfg.logdir_ckpt, iter_s, human=self.human,
                     scene=self.scene)
        if self.scene is not None and self.cfg.logdir:
            gs = self.scene.gs
            alive = gs.alive.cpu().numpy()

            def host(f):
                return getattr(gs, f).detach().cpu().numpy()[alive]
            save_gaussian_ply(
                f"{self.cfg.logdir}/meshes/scene_{iter_s}_splat.ply",
                host("xyz"), host("features_dc"), host("features_rest"),
                host("opacity"), host("scaling"), host("rotation"))

    def load_latest_ckpt(self) -> bool:
        """Restores the latest checkpoints into the states in place."""
        return ckpt_io.load_latest(self.cfg.logdir_ckpt, human=self.human,
                                   scene=self.scene) is not None

    def compact_for_eval(self):
        """Right-sizes the per-Gaussian rows to the live population for
        evaluation (2048-row buckets for the human, 4096 for the scene):
        the training capacity's padded rows cost every frame in
        projection, LBS and binning. Rebuilds the optimizer states at the
        new sizes, so it refuses to run unless cfg.eval."""
        if not self.cfg.eval:
            raise RuntimeError(
                "compact_for_eval rebuilds optimizer state and must not "
                "run mid-training (set cfg.eval)")
        if self.human is not None:
            n_h = int(self.human.state.alive.sum())
            params, state, _ = hgs.compact_for_inference(
                self.human.params, self.human.state, {},
                bucket=-(-max(n_h, 1) // 2048) * 2048)
            self.human = hst.init_human_train_state(params, state)
            self._h_cap = params.xyz.shape[0]
        if self.scene is not None:
            n_s = int(self.scene.gs.alive.sum())
            self.scene = sst.init_scene_train_state(sgs.compact(
                self.scene.gs, bucket=-(-max(n_s, 1) // 4096) * 4096))
            self._s_cap = self.scene.gs.capacity

    def rehearse_budget(self, frames=None, probe_cap: int = 1 << 18) -> int:
        """Evaluation only: sets the instance budget to the largest slot
        demand of `frames` (default the val split) x 1.15 in 8192-slot
        pages, probing each frame at a roomy budget that doubles until the
        probe itself fits (a clipped probe under-reports). Returns it."""
        if not self.cfg.eval:
            raise RuntimeError("rehearse_budget shrinks the densify "
                               "headroom and must not run mid-training "
                               "(set cfg.eval)")
        if frames is None:
            frames = [self.val_dataset[i]
                      for i in range(len(self.val_dataset))] \
                if self.val_dataset is not None else []
        cap = max(self._ibudget, probe_cap)
        demand = 0
        for data in frames:
            for _ in range(8):
                out = self.render_frame(data, budget=cap)
                n_slots = int(out["n_slots"])
                if not bool(out["overflowed"]):
                    break
                cap = max(cap * 2, -(-(n_slots * 3 // 2) // 8192) * 8192)
            else:
                raise RuntimeError(f"rehearse_budget: the probe still "
                                   f"overflowed at budget {cap}")
            demand = max(demand, n_slots)
        if demand:
            self._ibudget = min(
                max(1 << 14, -(-(demand * 23 // 20) // 8192) * 8192), cap)
            self._budget_rehearsed = True
        return self._ibudget
