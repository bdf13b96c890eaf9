"""Training orchestration: the port's GaussianTrainer.

The host loop around the training steps, as the JAX package's trainer
runs it (reference hugs/trainer/gs_trainer.py:70-747) at batch size 1:
building the human and scene models (with the init distillation), the
train loop in the scene, human and human_scene modes (human until
scene.opt_start_iter, then joint), the instance budget grown on demand
with a retry of a step that overflowed it, the densify / opacity reset /
SH ramp / checkpoint / validation cadence, and the evaluation metrics
(PSNR, SSIM and LPIPS of the whole frame and of the human's box).

The serving half: animate (the anim split's AMASS motion, aligned into
the scene by the split's manual transform), render_canonical (the
rotating-camera turntable of the canonical avatar), the iteration-0 and
anim_interval dumps (scene and human PLYs, the turntable, the
animation), the progress strip and its video, compact_for_eval and
rehearse_budget (a binning-only probe of the val and anim frames that
sizes the instance budget), and render_poses, the inference fast path.

Random draws: the frame order is np.random.RandomState(cfg.seed)'s, so
the port visits frames in the JAX package's order; every other draw
(the per-step backgrounds, the loss's LPIPS background and patches, the
densify's split noise, the nets' initialisation) comes from one
torch.Generator on the trainer's device, seeded from cfg.seed.

A step that overflowed its instance budget (checked on sync steps, as
the JAX package does) is rendered again at the grown budget before
anything is updated: the forward is a separate stage from the update,
so no copy of the states is needed for the retry.

On the card a one-frame step runs as replays of two CUDA graphs that
train/graph_step.py captures at the first step of each key (the mode,
the frame's size, the budget, the SH degrees, ...): the forward with
the loss, then the gradients, Adam and the statistics; an overflow's
retry and everything else (densify, the periodic work) run eagerly. A
replayed step costs the host about a millisecond, so the trainer keeps
at most STEPS_IN_FLIGHT steps queued on the card and waits for the
oldest in `train.wait`.

Scale-out (config[4]): train.batch_size B > 1, or a mesh of several
ranks, trains through the data x tile step of parallel/train_dp_tile.py
on the trainer's mesh, (world, 1) by default as hugs_tpu lays it out
(hugs_tpu/train/trainer.py:449-562; a mesh passed in with a tile axis
also bands each frame): n_data is the largest divisor of B not above the
mesh's data ranks, and a mesh the batch would leave partly idle is
refused (an idle rank cannot sit out a collective). Every rank draws the whole batch's frames and draws from
the same seeded streams and trains its share; the retry is decided from
the all-reduced overflow flag, so every rank grows its budget alike.
train.anim_batch_size B > 1 animates in batches of B frames split over
the mesh's data ranks, frame by frame on each. Rank 0 writes the logs,
checkpoints, validation and images; the other ranks wait at a barrier.

The Gaussian-sharded path (tpu.gauss_shard = n; hugs_tpu/train/
trainer.py:186-233): a ('gauss',) mesh of n ranks, the world under
torchrun or one rank with no group (parallel/mesh.py::make_gauss_mesh).
Scene-mode training runs through parallel/gauss_train.py's step: each
rank owns its rows of the scene (a copy, `_gscene`, made at the first
step from the whole state, rank 0's), its local budget is
max(budget // n, 4096), and an overflow is warned on sync steps, not
retried (no regrowth, as in hugs_tpu); the densify gathers the rows and
runs on the whole set. The trainer's `scene` stays the whole state and
is brought up to date from the ranks' rows (`_sync_scene`, a
collective) before anything reads it: the periodic writes that are due,
and the end of train(). The evaluation renders (render_frame, validate,
animate, the turntable) go through render(gauss_mesh=...) with the
global budget; the rehearsal's binning-only probe bins the whole set on
one device. With n > 1 every rank runs those renders (they exchange
fragments) and rank 0 alone writes. Human and joint training do not
change.
"""
from __future__ import annotations

import collections
import importlib
import json
import os
import shutil
import time
import traceback
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
from hugs_tpu_torch.parallel.collectives import broadcast_
from hugs_tpu_torch.parallel.gauss_train import (
    ROW_FIELDS, gather_scene_state, gauss_densify_step,
    make_gauss_scene_train_step, shard_scene_state,
)
from hugs_tpu_torch.parallel.mesh import Mesh, make_gauss_mesh, make_mesh
from hugs_tpu_torch.parallel.shard import batch_render_sharded
from hugs_tpu_torch.parallel.train_dp_tile import (
    dp_aux, make_dp_tile_train_step,
)
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.renderer import render_human_scene
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train import graph_step as gst
from hugs_tpu_torch.train import human_step as hst
from hugs_tpu_torch.train import joint_step as jst
from hugs_tpu_torch.train import scene_step as sst
from hugs_tpu_torch.train.budget import (
    budget_bucket, fit_budget, grown_budget,
)
from hugs_tpu_torch.utils import profiling
from hugs_tpu_torch.utils.image import create_video, save_image_grid, save_png
from hugs_tpu_torch.utils.ply import save_gaussian_ply

# the module: hugs_tpu_torch.ops exports the function `knn` under its name
knn_ops = importlib.import_module("hugs_tpu_torch.ops.knn")

# the steps a trainer on the card keeps queued on the device at most
STEPS_IN_FLIGHT = 2

# the pkg keys a binning-only render gives: render_frame stops after the
# binning when `outputs` asks for these alone
BIN_OUTPUTS = frozenset({"n_slots", "overflowed", "n_instances"})


class GaussianTrainer:
    # the mesh: (world, 1) over the process group, (1, 1) without one
    # (also for a trainer made without __init__)
    mesh: Mesh = Mesh()
    # this rank's rows of the scene while it trains Gaussian-sharded, and
    # whether `scene` lags behind them
    _gscene = None
    _scene_stale = False
    _gauss_mesh = None
    _gauss_key = None
    # the captured step (train/graph_step.py) and the SH degrees its key
    # holds, read from the card after each change (None: not yet)
    _graph = None
    _sh_key = None
    # the card's events at the ends of the steps still queued there
    _in_flight = None

    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 anim_dataset=None, smpl_model=None,
                 device: torch.device | str = "cuda", mesh: Mesh | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.mesh = make_mesh() if mesh is None else mesh
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.anim_dataset = anim_dataset
        self.eval_metrics: dict[str, Any] = {}
        self.rng = np.random.RandomState(cfg.seed)
        self.gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
        self._overflow_checked: set = set()
        self._budget_rehearsed = False
        self.retries = 0      # steps rendered again at a grown budget
        # steps that overflowed at every attempt (trained on a truncated
        # render), and evaluation frames rendered again at a grown budget
        self.overflow_persisted = 0
        self.eval_retries = 0
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
        self._ibudget = int(cfg.tpu.instance_budget) or budget_bucket(
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

    # ---------------------------------------------------- gauss shard

    def _gauss_n(self) -> int:
        return int(self.cfg.tpu.get("gauss_shard", 0) or 0)

    @property
    def gauss_collective(self) -> bool:
        """Whether the evaluation renders exchange fragments between
        ranks, so that every rank must run them."""
        return self._gauss_n() > 1

    def _get_gauss_mesh(self) -> Mesh:
        """The ('gauss',) mesh of tpu.gauss_shard ranks, built once."""
        n = self._gauss_n()
        if self._gauss_mesh is None or self._gauss_mesh.shape["gauss"] != n:
            self._gauss_mesh = make_gauss_mesh(n)
        return self._gauss_mesh

    def _eval_render_kw(self, budget: int | None = None) -> dict:
        """The evaluation renders' arguments: the budget, and with
        tpu.gauss_shard the ('gauss',) mesh and the packet cap
        (hugs_tpu/train/trainer.py:219-233)."""
        kw = {"instance_budget": int(budget or self._ibudget)}
        if self._gauss_n():
            kw.update(gauss_mesh=self._get_gauss_mesh(),
                      gauss_frag_cap=int(self.cfg.tpu.get(
                          "gauss_frag_cap", 0) or 0) or None)
        return kw

    def _get_gauss_step(self, W: int, H: int):
        """The Gaussian-sharded scene step for frames of W x H, cached;
        the first one takes this rank's rows of the scene (rank 0's)."""
        n = self._gauss_n()
        key = (W, H, n, self._ibudget)
        if self._gauss_key != key:
            mesh = self._get_gauss_mesh()
            if self._gscene is None:
                if mesh.distributed:
                    broadcast_([t.data for t in ckpt_io.flatten(
                        self.scene).values()], mesh)
                self._gscene = shard_scene_state(self.scene, mesh)
            loss = self.cfg.scene.loss
            self._gstep = make_gauss_scene_train_step(
                mesh, width=W, height=H, l1_w=loss.l1_w, ssim_w=loss.ssim_w,
                local_budget=max(self._ibudget // n, 1 << 12),
                frag_cap=int(self.cfg.tpu.get("gauss_frag_cap", 0) or 0)
                or None)
            self._gauss_key = key
        return self._gstep

    @torch.no_grad()
    def _sync_scene(self):
        """`scene` from the ranks' rows where it lags behind them (a
        collective: every rank calls it at the same points)."""
        if self._gscene is None or not self._scene_stale:
            return
        full = gather_scene_state(self._gscene, self._get_gauss_mesh())
        for f in ROW_FIELDS + ("active_sh_degree",):
            getattr(self.scene.gs, f).copy_(getattr(full.gs, f))
        for mine, whole in ((self.scene.opt.mu, full.opt.mu),
                            (self.scene.opt.nu, full.opt.nu)):
            for k, v in mine.items():
                v.copy_(whole[k])
        self.scene.opt.step.copy_(full.opt.step)
        self._scene_stale = False

    def _end_gauss_training(self):
        """`scene` up to date, and the ranks' rows dropped: a later
        train() takes them again."""
        self._sync_scene()
        self._gscene = self._gauss_key = None

    def _writes_due(self, t_iter: int) -> bool:
        """Whether _write_periodic reads the models at t_iter."""
        cfg = self.cfg
        if t_iter == 0:
            return True
        anim_every = int(cfg.train.get("anim_interval", 0) or 0)
        return (t_iter % 1000 == 0
                or t_iter % cfg.train.save_ckpt_interval == 0
                or (t_iter % cfg.train.val_interval == 0
                    and self.val_dataset is not None)
                or (anim_every > 0 and t_iter % anim_every == 0)
                or (cfg.train.save_progress_images
                    and t_iter % cfg.train.progress_save_interval == 0))

    def _gauss_train_step(self, t_iter, data, sync: bool):
        """One scene step through the Gaussian-sharded step, then the
        densify where due. Returns _train_step's (aux, vals)."""
        W, H = data["width"], data["height"]
        bg, _, _ = self._step_draws("scene", H, W)
        step = self._get_gauss_step(W, H)
        self._gscene, aux = step(self._gscene, data["camera"], data["rgb"],
                                 bg, self.s_xyz_sched(t_iter),
                                 self.s_static_lrs)
        self._scene_stale = True
        vals = None
        if sync:
            with profiling.span("step.sync_readback"):
                loss, over = torch.stack([aux["loss"].double(),
                                          aux["overflowed"].double()]).tolist()
            vals = (loss, 0, bool(over), 0)
            if vals[2]:
                print(f"WARNING: Gaussian-sharded instance budget overflow "
                      f"at iter {t_iter} (local budget "
                      f"{step.local_budget}, frag_cap {step.frag_cap}): "
                      f"raise tpu.instance_budget or tpu.gauss_frag_cap")
        self._maybe_densify_scene(t_iter)
        return aux, vals

    # ------------------------------------------------------------ budget

    def _check_budget(self, ni: int, overflowed: bool, ninst: int) -> bool:
        """Grows the instance budget from the measured slot demand `ni`
        (instances plus alignment padding) when a step overflowed it or
        filled three quarters of it; returns whether it overflowed, in
        which case the caller renders the step again at the new budget.
        The headroom scales the instances, not the padding, which depends
        on the tile grid only (train/budget.py)."""
        if self._ibudget_fixed:
            return False
        if overflowed or ni * 4 >= self._ibudget * 3:
            new = grown_budget(self._ibudget, ni, ninst)
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
        """The train loop: one frame a step, or with train.batch_size > 1
        or several ranks, a batch a step through the data x tile step."""
        cfg = self.cfg
        bsz = int(cfg.train.get("batch_size", 1) or 1)
        gauss = cfg.mode == "scene" and self._gauss_n() > 0
        batched = bsz > 1 or (self.mesh.size > 1 and not gauss)
        if batched:
            self._check_batch_layout(bsz)
            self._broadcast_states()
        n = len(self.train_dataset)
        order = self.rng.permutation(n)
        pos = 0
        log = []
        t_start = time.time()
        for t_iter in range(cfg.train.num_steps + 1):
            idxs = []
            for _ in range(bsz if batched else 1):
                if pos >= n:
                    order = self.rng.permutation(n)
                    pos = 0
                idxs.append(int(order[pos]))
                pos += 1
            data = self.train_dataset[idxs[0]]
            sync = self._is_sync_step(t_iter)
            aux, vals = (self._batched_step(t_iter, idxs, sync) if batched
                         else self._train_step(t_iter, idxs[0], data, sync))
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
        self._end_gauss_training()
        self._finish_progress_video()
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
        # a scene-only frame need not carry the SMPL scale
        scale = self._scale(data)
        budget = self._ibudget
        lpips = self.lpips if self.loss_fn.l_lpips_w > 0 else None
        if mode == "scene":
            hook = torch.zeros((self._s_cap, 2), device=self.device,
                               requires_grad=True)
            pkg = sst.scene_render(self.scene.gs, cam, bg, hook, width=W,
                                   height=H, instance_budget=budget)
            l = self.cfg.scene.loss
            with profiling.span("step.loss", device=True):
                loss = sst.scene_loss(pkg["render"], gt, l.l1_w, l.ssim_w)
            return loss, dict(pkg=pkg, hook=hook, loss_dict={})
        if mode == "human":
            hook = torch.zeros((self._h_cap, 2), device=self.device,
                               requires_grad=True)
            pkg, out = hst.human_render(
                self.human, self.fixed, cam, bg, hook, scale, idx,
                cfg=self.human_cfg, width=W, height=H, instance_budget=budget)
            with profiling.span("step.loss", device=True):
                loss, loss_dict = hst.human_loss(self.loss_fn, draws, gt,
                                                 mask, bg, pkg, out, lpips)
            return loss, dict(pkg=pkg, hook=hook, out=out,
                              loss_dict=loss_dict)
        jstate = jst.JointTrainState(human=self.human, scene=self.scene)
        hook = torch.zeros((self._h_cap + self._s_cap, 2),
                           device=self.device, requires_grad=True)
        pkg, out = jst.joint_render(
            jstate, self.fixed, cam, bg, human_bg, hook, scale, idx,
            cfg=self.human_cfg, width=W, height=H, instance_budget=budget,
            render_human_separate=self.loss_fn.l_humansep_w > 0)
        with profiling.span("step.loss", device=True):
            loss, loss_dict = jst.joint_loss(self.loss_fn, draws, gt, mask,
                                             bg, human_bg, pkg, out, lpips)
        return loss, dict(pkg=pkg, hook=hook, out=out, loss_dict=loss_dict)

    def _train_step(self, t_iter, idx, data, sync: bool):
        """One step in place: draws, forward (again at a grown budget if
        a sync step overflowed), gradients, Adam and statistics, then the
        densify where due. Returns (aux, the sync step's (loss, slots,
        overflowed, instances) or None). On the card it first waits, in
        a root span of its own (`train.wait`), until at most
        STEPS_IN_FLIGHT - 1 earlier steps are queued there: else the
        host fills CUDA's launch queue and waits inside a launch."""
        on_card = self.device.type == "cuda"
        if on_card:
            self._wait_in_flight(t_iter)
        with profiling.span("train.step", step=t_iter, device=True,
                            counters=self._counters):
            out = self._one_step(t_iter, idx, data, sync)
        if on_card:
            done = torch.cuda.Event()
            done.record()
            self._in_flight.append(done)
        return out

    def _wait_in_flight(self, t_iter: int) -> None:
        if self._in_flight is None:
            self._in_flight = collections.deque()
        if len(self._in_flight) >= STEPS_IN_FLIGHT:
            with profiling.span("train.wait", step=t_iter):
                self._in_flight.popleft().synchronize()

    def _counters(self) -> dict:
        """The counts whose change over a step its record takes: the
        blend kernels' and the kNN kernel's launches and the budget's
        retries."""
        return {"launches": cuda_blend.LAUNCHES,
                "k2_launches": cuda_blend.K2_LAUNCHES,
                "mxu_launches": cuda_blend.MXU_LAUNCHES,
                "k2_mxu_launches": cuda_blend.K2_MXU_LAUNCHES,
                "knn_launches": knn_ops.LAUNCHES,
                "retries": self.retries,
                "overflow_persisted": self.overflow_persisted}

    def _one_step(self, t_iter, idx, data, sync: bool):
        mode = self._mode(t_iter)
        if mode == "scene" and self._gauss_n():
            return self._gauss_train_step(t_iter, data, sync)
        W, H = data["width"], data["height"]
        bg, human_bg, draws = self._step_draws(mode, H, W)
        graph = self._step_graph(mode, data, human_bg, draws)
        lrs = self._xyz_lrs(mode, t_iter)
        vals = None
        for attempt in range(3):
            self.retries += attempt > 0
            budget = self._ibudget
            if graph is not None and attempt == 0:
                graph.load(idx, data, bg, human_bg, draws, *lrs)
                loss, fw = graph.forward()
            else:
                loss, fw = self._forward(mode, t_iter, idx, data, bg,
                                         human_bg, draws)
            if not sync:
                break
            pkg = fw["pkg"]
            with profiling.span("step.sync_readback"):
                v = torch.stack([loss.detach().double()] + [
                    pkg[k].double() for k in ("n_slots", "overflowed",
                                              "n_instances")]).tolist()
                vals = (v[0], int(v[1]), bool(v[2]), int(v[3]))
                over = self._check_budget(vals[1], vals[2], vals[3])
            if not over:
                break
        else:
            self.overflow_persisted += 1
            print(f"WARNING: tile-instance budget overflow persists at iter "
                  f"{t_iter} (budget={self._ibudget})")
        pkg = fw["pkg"]
        replayed = graph is not None and fw is graph.fw
        # every step the forward's slot demand (a 0-d tensor of its own,
        # read at the drain: a replay's is copied, the next replay
        # overwrites it) and budget; the instances where read back
        # (their tensor is a view that holds the binning's cumsum)
        if profiling.recording():
            profiling.count("n_slots", pkg["n_slots"].clone() if replayed
                            else pkg["n_slots"])
        profiling.count("budget", budget)
        if vals is not None:
            profiling.count("n_instances", vals[3])
        if replayed:
            graph.update()
        else:
            self._backward_update(mode, loss, fw, *lrs, W, H)
        profiling.count("graph_replays", int(replayed))
        aux = graph.aux if replayed else self._aux(mode, loss, fw)
        with profiling.span("step.optim", device=True):
            if mode != "scene":
                self._maybe_densify_human(t_iter, aux)
            if mode != "human":
                self._maybe_densify_scene(t_iter)
        return dict(aux), vals

    def _xyz_lrs(self, mode: str, t_iter: int) -> tuple:
        """The position learning rates of t_iter, the human's and the
        scene's (None for a model the mode does not train)."""
        return (None if mode == "scene" else self.h_xyz_sched(t_iter),
                None if mode == "human" else self.s_xyz_sched(t_iter))

    def _grads(self, mode: str, loss, fw: dict):
        """The step's gradients: the scene's or the human's (grads,
        hook_grad), or the joint (h_grads, s_grads, hook_grad)."""
        hook = fw["hook"]
        if mode == "scene":
            return sst.scene_grads(loss, self.scene.gs, hook)
        if mode == "human":
            return hst.human_grads(loss, self.human.params, hook)
        jstate = jst.JointTrainState(human=self.human, scene=self.scene)
        return jst.joint_grads(loss, jstate, hook,
                               self.cfg.train.optim_scene)

    def _backward_update(self, mode: str, loss, fw: dict, h_lr, s_lr,
                         W: int, H: int) -> None:
        """Gradients, then Adam and the densification statistics, at the
        position learning rates h_lr and s_lr (floats or 0-d tensors)."""
        pkg = fw["pkg"]
        with profiling.span("step.backward", device=True):
            grads = self._grads(mode, loss, fw)
        with profiling.span("step.optim", device=True):
            if mode == "scene":
                sst.scene_update(self.scene, *grads, pkg, s_lr,
                                 self.s_static_lrs, width=W, height=H)
            elif mode == "human":
                hst.human_update(self.human, *grads, pkg, h_lr,
                                 self.h_static_lrs, width=W, height=H)
            else:
                jst.joint_update(
                    jst.JointTrainState(human=self.human, scene=self.scene),
                    *grads, pkg, h_lr, self.h_static_lrs, s_lr,
                    self.s_static_lrs, width=W, height=H)

    @staticmethod
    def _aux(mode: str, loss, fw: dict) -> dict:
        """The step's diagnostics (joint_step.step_aux; the scene's the
        loss and the binning's counts)."""
        pkg = fw["pkg"]
        if mode == "scene":
            return {"loss": loss.detach(), "overflowed": pkg["overflowed"],
                    "n_instances": pkg["n_instances"],
                    "n_slots": pkg["n_slots"]}
        return jst.step_aux(loss, fw["loss_dict"], pkg, fw["out"])

    def _step_graph(self, mode: str, data: dict, human_bg, draws):
        """On the card, the captured step of this key (train/graph_step.py;
        captured at its first forward), made anew when the key changed;
        None elsewhere. One key's graphs are kept at a time."""
        if not gst.capturable(self.device):
            return None
        key = gst.graph_key(self, mode, data)
        if self._graph is None or self._graph.key != key:
            self._graph = None
            self._graph = gst.StepGraph(self, key, mode, data, human_bg,
                                        draws)
        return self._graph

    def _sh_degrees(self) -> tuple:
        """The active SH degrees, as the trainer last raised or loaded
        them (read from the card once after each change)."""
        if self._sh_key is None:
            self._sh_key = tuple(
                int(st.active_sh_degree) for st in (
                    self.human.state if self.human is not None else None,
                    self.scene.gs if self.scene is not None else None)
                if st is not None)
        return self._sh_key

    # ---------------------------------------------------- batched training

    def _check_batch_layout(self, bsz: int):
        """Raises ValueError unless a batch of bsz frames can train here:
        the joint mode with both models, and a mesh of exactly n_data
        data ranks, n_data the largest divisor of bsz not above their
        number (hugs_tpu/train/trainer.py:483-493)."""
        cfg = self.cfg
        if cfg.mode != "human_scene" or self.human is None \
                or self.scene is None:
            raise ValueError(
                "train.batch_size > 1 (or several ranks) runs the joint data "
                "x tile step and needs mode='human_scene' (got mode="
                f"'{cfg.mode}')")
        n = self.mesh.shape["data"]
        n_data = max(d for d in range(1, min(bsz, n) + 1) if bsz % d == 0)
        if n_data != n:
            raise ValueError(
                f"train.batch_size {bsz} splits over {n_data} data ranks, "
                f"which would leave {n - n_data} of the mesh's {n} data "
                f"ranks idle: launch {n_data} ranks or pick a batch size "
                f"that {n} divides")

    def _broadcast_states(self):
        """Rank 0's states on every rank before the first step (the
        distillation's atomics on the card need not agree bit for bit);
        from then on every rank applies the same reduced gradients."""
        if self.mesh.distributed:
            broadcast_([t.data for st in (self.human, self.scene)
                        for t in ckpt_io.flatten(st).values()], self.mesh)

    def _get_dp_step(self, W: int, H: int, mode: str):
        """The data x tile step for frames of W x H in `mode` (human
        before scene.opt_start_iter, else human_scene), cached."""
        key = (W, H, mode)
        if getattr(self, "_dp_key", None) != key:
            self._dp_step = make_dp_tile_train_step(
                self.mesh, self.fixed, self.human_cfg, width=W, height=H,
                loss_fn=self.loss_fn,
                lpips=self.lpips if self.loss_fn.l_lpips_w > 0 else None,
                instance_budget=self._ibudget,
                optim_scene=self.cfg.train.optim_scene, mode=mode)
            self._dp_key = key
        return self._dp_step

    def _batch_frames(self, t_iter: int, idxs: list) -> list:
        """The batch's frames with their draws, the same on every rank:
        each frame's background, human background and loss draws, in
        the order the one-frame loop draws them."""
        mode = self._mode(t_iter)
        frames = []
        for i in idxs:
            d = self.train_dataset[i]
            bg, human_bg, draws = self._step_draws(mode, d["height"],
                                                   d["width"])
            frames.append(dict(
                camera=d["camera"], rgb=d["rgb"], mask=d["mask"], bg=bg,
                human_bg=bg if human_bg is None else human_bg,
                smpl_scale=self._scale(d), dataset_idx=i, draws=draws))
        return frames

    def _batched_step(self, t_iter: int, idxs: list, sync: bool):
        """One batch in place: this rank's share of the frames through the
        data x tile step's forward and backward (again at a grown budget
        if a sync step overflowed on any rank), then Adam and the
        statistics, then the densify where due. Returns _train_step's
        (aux, vals)."""
        with profiling.span("train.step", step=t_iter, device=True,
                            counters=self._counters):
            return self._one_batch(t_iter, idxs, sync)

    def _one_batch(self, t_iter: int, idxs: list, sync: bool):
        mode = self._mode(t_iter)
        frames = self._batch_frames(t_iter, idxs)
        d0 = self.train_dataset[idxs[0]]
        step = self._get_dp_step(d0["width"], d0["height"], mode)
        jstate = jst.JointTrainState(human=self.human, scene=self.scene)
        vals = None
        for attempt in range(3):
            self.retries += attempt > 0
            g = step.grads(jstate, frames, self._ibudget)
            if not sync:
                break
            with profiling.span("step.sync_readback"):
                v = torch.stack([g.loss.double()] + [
                    x.double() for x in (g.n_slots, g.overflowed,
                                         g.n_instances)]).tolist()
                vals = (v[0], int(v[1]), bool(v[2]), int(v[3]))
                over = self._check_budget(vals[1], vals[2], vals[3])
            if not over:
                break
        else:
            print(f"WARNING: tile-instance budget overflow persists at iter "
                  f"{t_iter} (budget={self._ibudget})")
        step.update(jstate, g, self.h_xyz_sched(t_iter), self.h_static_lrs,
                    self.s_xyz_sched(t_iter), self.s_static_lrs)
        aux = dp_aux(g)
        self._maybe_densify_human(t_iter, aux)
        if mode == "human_scene":
            self._maybe_densify_scene(t_iter)
        return aux, vals

    def _split_noise(self, capacity: int) -> torch.Tensor:
        """A densify's split noise, (2, capacity, 3) standard normal."""
        return torch.randn((2, capacity, 3), generator=self.gen,
                           device=self.gen.device).to(self.device)

    def _scene_densify(self, noise: torch.Tensor, **kw):
        """scene_densify_step on the scene, or on the ranks' rows while it
        trains Gaussian-sharded (gauss_densify_step)."""
        extent = float(self.scene_extent)
        if self._gscene is None:
            sst.scene_densify_step(self.scene, noise, extent, **kw)
            return
        gauss_densify_step(self._gscene, self._get_gauss_mesh(), noise,
                           extent, **kw)
        self._scene_stale = True

    def _maybe_densify_scene(self, t_iter: int):
        cfg = self.cfg
        it = (t_iter - max(cfg.scene.opt_start_iter, 0)) + 1
        if self.scene is None or it > cfg.scene.densify_until_iter:
            return
        if it > cfg.scene.densify_from_iter \
                and it % cfg.scene.densification_interval == 0:
            size_thresh = 20.0 if it > cfg.scene.opacity_reset_interval \
                else None
            self._scene_densify(
                self._split_noise(self._s_cap),
                grad_threshold=cfg.scene.densify_grad_threshold,
                min_opacity=cfg.scene.prune_min_opacity,
                max_screen_size=size_thresh,
                percent_dense=cfg.scene.percent_dense,
                max_n_gaussians=int(cfg.scene.max_n_gaussians))
        if it % cfg.scene.opacity_reset_interval == 0 or (
                cfg.bg_color == "white" and it == cfg.scene.densify_from_iter):
            # nothing is split at an infinite threshold: no noise is drawn
            self._scene_densify(
                torch.zeros((2, self._s_cap, 3), device=self.device),
                grad_threshold=np.inf, min_opacity=0.0,
                do_reset_opacity=True)

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
        dump every 1000, the progress strip, the checkpoint and
        validation at their intervals, the iteration-0 dumps and, every
        anim_interval, the human PLY, animate and the turntable. The
        progress strip and the two dump hooks are observability: an
        error there is printed as a warning and training goes on. With
        several ranks rank 0 does all but the SH step, alone (animate on
        no mesh), while the others wait at a barrier; where the
        evaluation renders exchange fragments (gauss_collective) every
        rank renders and rank 0 alone writes."""
        with profiling.span("train.periodic", step=t_iter):
            cfg = self.cfg
            if t_iter % 1000 == 0 and t_iter > 0:
                if self.human is not None:
                    hgs.one_up_sh_degree(self.human.state,
                                         cfg.human.sh_degree)
                if self.scene is not None:
                    sgs.one_up_sh_degree(self.scene.gs, cfg.scene.sh_degree)
                if self._gscene is not None:
                    sgs.one_up_sh_degree(self._gscene.gs,
                                         cfg.scene.sh_degree)
                self._sh_key = None
            if not cfg.logdir:
                return
            if self._writes_due(t_iter):
                self._sync_scene()
            if self.mesh.is_writer or self.gauss_collective:
                self._write_periodic(t_iter, data)
            self.mesh.barrier()

    def _write_periodic(self, t_iter: int, data):
        cfg = self.cfg
        has_human = cfg.mode in ("human", "human_scene") \
            and self.human is not None
        if t_iter > 0 and t_iter % 1000 == 0 and data is not None:
            # the train view, target beside render (gs_trainer.py:307-314)
            pkg = self.render_frame(data)
            if self.mesh.is_writer:
                save_image_grid([data["rgb"], pkg["render"]],
                                f"{cfg.logdir}/train/{t_iter:06d}.png")
        if cfg.train.save_progress_images and t_iter > 0 and has_human \
                and t_iter % cfg.train.progress_save_interval == 0:
            self._observe(f"progress image({t_iter})",
                          lambda: self._save_progress_frame(t_iter))
        if t_iter > 0 and t_iter % cfg.train.save_ckpt_interval == 0:
            self.save_ckpt(t_iter)
        if t_iter > 0 and t_iter % cfg.train.val_interval == 0 \
                and self.val_dataset is not None:
            self.validate(t_iter)
        if t_iter == 0:
            self._observe("iter-0 dumps", self._iter0_dumps)
        anim_every = int(cfg.train.get("anim_interval", 0) or 0)
        if t_iter > 0 and anim_every > 0 and t_iter % anim_every == 0:
            def anim_dumps():
                # reference gs_trainer.py:371-378
                self._save_human_ply(t_iter)
                if self.anim_dataset is not None:
                    self.animate(t_iter, mesh=Mesh())
                if has_human:
                    self.render_canonical(t_iter,
                                          nframes=cfg.human.canon_nframes)
            self._observe(f"animate({t_iter})", anim_dumps)

    @staticmethod
    def _observe(what: str, fn):
        """Runs an observability hook; an error is printed as a warning,
        its traceback to stderr, so that a long run survives it."""
        try:
            fn()
        except Exception as e:          # noqa: BLE001
            traceback.print_exc()
            print(f"WARNING: {what} failed (continuing training): "
                  f"{type(e).__name__}: {e}")

    def _log_jsonl(self, rec: dict):
        """One record appended to logdir/metrics.jsonl (rank 0's)."""
        if not self.cfg.logdir or not self.mesh.is_writer:
            return
        with open(os.path.join(self.cfg.logdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # --------------------------------------------------------- rendering

    def _tensor(self, x, default) -> torch.Tensor:
        """A frame's field as a float32 tensor on the device: a tensor
        moved there, anything else through numpy; `default` where the
        frame lacks it."""
        x = default if x is None else x
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _pose_kw(self, data) -> dict:
        """The frame's SMPL parameters as tensors on the device."""
        z3 = np.zeros(3, np.float32)
        return dict(
            global_orient=self._tensor(data.get("global_orient"), z3),
            body_pose=self._tensor(data.get("body_pose"), np.zeros(69)),
            betas=self._tensor(data.get("betas"), np.zeros(10)),
            transl=self._tensor(data.get("transl"), z3))

    def _scale(self, data) -> torch.Tensor:
        """The frame's SMPL scale, a 0-d float32 tensor on the device; a
        host number is filled there (no copy from host memory, which
        would wait for the card)."""
        x = data.get("smpl_scale")
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32).reshape(())
        return torch.full((), float(np.asarray(1.0 if x is None else x,
                                               np.float32)),
                          dtype=torch.float32, device=self.device)

    def ext_tfs_of(self, data):
        """The anim split's alignment of a frame, (manual_trans,
        manual_rotmat, manual_scale) as tensors on the device; None for a
        frame without one."""
        if "manual_trans" not in data:
            return None
        return (self._tensor(data["manual_trans"], None),
                self._tensor(data["manual_rotmat"], None),
                self._tensor(data["manual_scale"], None).reshape(()))

    @torch.no_grad()
    def forward_models(self, data, dataset_idx: int = -1, ext_tfs=None,
                       use_dataset_pose: bool = True):
        """(human_forward's dict, scene_forward's dict) for one frame,
        without the skinning targets; None for a model the trainer lacks.
        The body takes the frame's SMPL parameters (use_dataset_pose) or
        the learned ones of frame max(dataset_idx, 0), then the frame's
        scale and the alignment `ext_tfs` (translation, rotation matrix,
        scale), if given."""
        h_out = s_out = None
        if self.human is not None:
            pose = self._pose_kw(data) if use_dataset_pose else {}
            if ext_tfs is not None:
                ext_tfs = tuple(self._tensor(x, None) for x in ext_tfs)
                ext_tfs = ext_tfs[:2] + (ext_tfs[2].reshape(()),)
            h_out = hgs.human_forward(
                self.human.params, self.human.state, self.fixed,
                self.human_cfg, smpl_scale=self._scale(data),
                dataset_idx=max(dataset_idx, 0), ext_tfs=ext_tfs,
                compute_gt_lbs=False, **pose)
        if self.scene is not None:
            s_out = sgs.scene_forward(self.scene.gs)
        return h_out, s_out

    @torch.no_grad()
    def render_frame(self, data, render_mode: str | None = None, bg=None,
                     ext_tfs=None, use_dataset_pose: bool = True,
                     outputs: tuple | None = None,
                     budget: int | None = None):
        """Renders one frame at the trainer's budget (or `budget`): the
        pkg dict, or with `outputs` the tuple of those keys. Outputs of
        the binning alone (BIN_OUTPUTS, e.g. ("n_slots", "overflowed"))
        stop after the binning and launch no blend: the rehearsal's
        probe. After rehearse_budget, the first full render of each
        (mode, size, budget) is checked for an overflow."""
        render_mode = render_mode or self.cfg.mode
        if render_mode == "human_scene" and self.scene is None:
            render_mode = "human"
        if self.human is None and render_mode != "scene":
            render_mode = "scene"
        budget = int(budget or self._ibudget)
        h_out, s_out = self.forward_models(data, ext_tfs=ext_tfs,
                                           use_dataset_pose=use_dataset_pose)
        W, H = data["width"], data["height"]
        bin_only = outputs is not None and set(outputs) <= BIN_OUTPUTS
        # the probe bins the whole set on one device
        kw = ({"instance_budget": budget, "bin_only": True} if bin_only
              else self._eval_render_kw(budget))
        out = render_human_scene(
            {"camera": data["camera"], "width": W, "height": H}, h_out,
            s_out, bg_color=self.bg_color if bg is None else bg,
            render_mode=render_mode, **kw)
        if outputs is not None:
            return tuple(out[k] for k in outputs)
        key = (render_mode, W, H, budget, self._gauss_n())
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

        def frame(budget):
            return render_human_scene(
                {"camera": data["camera"], "width": data["width"],
                 "height": data["height"]}, h_out, s_out, bg_color=bg,
                render_mode=mode, **self._eval_render_kw(budget))

        # an evaluation frame drops no instance unsaid: an automatic
        # budget grows for this frame alone (the training steps keep
        # theirs) and the frame renders again; a fixed one warns
        if self._ibudget_fixed or self._gauss_n():
            pkg = frame(self._ibudget)
            if bool(pkg["overflowed"]) and not self._gauss_n():
                print(f"WARNING: an evaluation frame overflowed the fixed "
                      f"instance budget {self._ibudget}: its image drops "
                      f"instances")
        else:
            pkg, budget = fit_budget(frame, self._ibudget, "evaluation frame")
            self.eval_retries += budget != self._ibudget
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
            if cfg.logdir and self.mesh.is_writer:
                save_image_grid([data["rgb"], img],
                                f"{cfg.logdir}/val/full_{iter_s}_{idx:03d}.png")
        out = {k: float(np.mean(v)) for k, v in metrics.items() if v}
        self.eval_metrics[iter_s] = out
        self._log_jsonl({"eval": iter_s, **out})
        if cfg.logdir and self.mesh.is_writer:
            os.makedirs(f"{cfg.logdir}/val", exist_ok=True)
            with open(f"{cfg.logdir}/val/eval_{iter_s}.json", "w") as f:
                json.dump(out, f, indent=2)
        return out

    # ------------------------------------------------------- checkpoints

    def save_ckpt(self, t_iter: int | None = None):
        """Both train states under logdir_ckpt, and the scene's live
        Gaussians as a 3DGS PLY under logdir/meshes; rank 0's only."""
        self._sync_scene()
        if not self.cfg.logdir_ckpt or not self.mesh.is_writer:
            return
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        ckpt_io.save(self.cfg.logdir_ckpt, iter_s, human=self.human,
                     scene=self.scene)
        if self.scene is not None and self.cfg.logdir:
            self._save_scene_ply(iter_s)

    def load_latest_ckpt(self) -> bool:
        """Restores the latest checkpoints into the states in place."""
        self._sh_key = None
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
        demand of `frames` (default the val and anim splits, what validate
        and animate render) x 1.15 in 8192-slot pages. Each frame is
        probed by a binning-only render (no blend launch) at a roomy
        budget that grows until the probe itself fits (a clipped probe
        under-reports). Returns the budget."""
        if not self.cfg.eval:
            raise RuntimeError("rehearse_budget shrinks the densify "
                               "headroom and must not run mid-training "
                               "(set cfg.eval)")
        if frames is None:
            frames = [ds[i] for ds in (self.val_dataset, self.anim_dataset)
                      if ds is not None for i in range(len(ds))]
        cap = max(self._ibudget, probe_cap)
        demand = 0
        for data in frames:
            ext = self.ext_tfs_of(data)
            for _ in range(8):
                n_slots, over = self.render_frame(
                    data, ext_tfs=ext, outputs=("n_slots", "overflowed"),
                    budget=cap)
                n_slots = int(n_slots)
                if not bool(over):
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

    # --------------------------------------------------------- animation

    def _out_dir(self, kind: str, iter_s: str) -> str | None:
        return f"{self.cfg.logdir}/{kind}/{iter_s}" if self.cfg.logdir \
            else None

    def _anim_frame(self, data) -> torch.Tensor:
        """One anim frame: render_frame with the split's alignment."""
        return self.render_frame(data, ext_tfs=self.ext_tfs_of(data))[
            "render"]

    def _animate_batched(self, batch_size: int, mesh: Mesh) -> list:
        """The anim split in batches (hugs_tpu/train/trainer.py:998-1050):
        padded by repeating the last frame to whole batches, each batch
        split over the mesh's data ranks (batch_size rounded up to a
        multiple of them) and rendered frame by frame on each, then
        gathered. The binning's shapes depend on the data, so frames are
        not vmapped."""
        ds = self.anim_dataset
        n = len(ds)
        datas = [ds[i] for i in range(n)]
        n_data = mesh.shape["data"]
        chunk = -(-batch_size // n_data) * n_data
        datas += datas[-1:] * ((-n) % chunk)
        frames = []
        for c0 in range(0, len(datas), chunk):
            frames += list(batch_render_sharded(
                self._anim_frame, datas[c0:c0 + chunk], mesh))
        return frames[:n]

    def animate(self, t_iter: int | None = None,
                batch_size: int | None = None,
                mesh: Mesh | None = None) -> list:
        """Renders the anim split, one render_frame per frame with the
        split's alignment, to logdir/anim/{iter}/{idx:05d}.png (rank 0),
        and a video of them when there is more than one. batch_size
        (default train.anim_batch_size) > 1 renders in batches split over
        the data ranks of `mesh` (default the trainer's; Mesh() renders
        alone), which every one of its ranks must call. Returns the
        images (3, H, W) on the device."""
        if self.anim_dataset is None:
            return []
        mesh = self.mesh if mesh is None else mesh
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        anim_dir = (self._out_dir("anim", iter_s)
                    if mesh.is_writer and self.mesh.is_writer else None)
        bsz = int(batch_size or self.cfg.train.get("anim_batch_size", 1)
                  or 1)
        n = len(self.anim_dataset)
        # frames that exchange fragments render on every rank, in turn
        if bsz > 1 and self.human is not None and n > 1 \
                and not self.gauss_collective:
            frames = self._animate_batched(bsz, mesh)
        else:
            frames = [self._anim_frame(self.anim_dataset[i])
                      for i in range(n)]
        if anim_dir:
            for idx, img in enumerate(frames):
                save_png(img, f"{anim_dir}/{idx:05d}.png")
        if anim_dir and len(frames) > 1:
            # the reference writes a video per animate() call
            # (gs_trainer.py:582-586, utils/general.py:86-92)
            create_video(anim_dir,
                         f"{self.cfg.logdir}/anim/anim_{iter_s}.mp4", fps=20)
        return frames

    def _canonical_frames(self, nframes: int, img_size: int = 128,
                          pose_type: str | None = None) -> list:
        """The canonical avatar alone (its betas, the static pose
        pose_type, default human.canon_pose_type) from `nframes` cameras
        on a circle of radius 5 about it."""
        from hugs_tpu_torch.data.cameras import (
            get_rotating_camera, get_smpl_static_params,
        )
        cams = get_rotating_camera(img_size=img_size, dist=5.0,
                                   nframes=nframes, device=self.device)
        sp = get_smpl_static_params(
            self.human.params.betas.detach(),
            pose_type or self.cfg.human.canon_pose_type, device=self.device)
        return [self.render_frame(dict(sp, **cp), render_mode="human")
                ["render"] for cp in cams]

    def render_canonical(self, t_iter: int | None = None, nframes: int = 8,
                         img_size: int = 128, pose_type: str | None = None
                         ) -> list:
        """The turntable of the canonical avatar (reference
        render_canonical, gs_trainer.py:588-684) to logdir/canon/{iter}/
        {n:05d}.png (n from 1) and a video. Returns the images."""
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        frames = self._canonical_frames(nframes, img_size, pose_type)
        out_dir = self._out_dir("canon", iter_s) if self.mesh.is_writer \
            else None
        if out_dir:
            for n, img in enumerate(frames, 1):
                save_png(img, f"{out_dir}/{n:05d}.png")
            if len(frames) > 1:
                create_video(out_dir,
                             f"{self.cfg.logdir}/canon/canon_{iter_s}.mp4",
                             fps=10)
        return frames

    def _save_progress_frame(self, t_iter: int, nframes: int = 2,
                             img_size: int = 128):
        """One strip of the canonical avatar from `nframes` orbit cameras
        into logdir/train_progress/ (reference render_canonical(...,
        is_train_progress=True), gs_trainer.py:588-684)."""
        frames = self._canonical_frames(nframes, img_size)
        if self.mesh.is_writer:
            save_image_grid(
                frames, f"{self.cfg.logdir}/train_progress/{t_iter:06d}.png")

    def _finish_progress_video(self):
        """The progress strips into one video, then the strips go
        (reference gs_trainer.py:388-391); rank 0's."""
        cfg = self.cfg
        if not (cfg.logdir and cfg.train.save_progress_images
                and self.mesh.is_writer):
            return
        pdir = os.path.join(cfg.logdir, "train_progress")
        if not os.path.isdir(pdir):
            return
        seq = cfg.dataset.get("seq", "")
        seq = seq if isinstance(seq, str) else "-".join(map(str, seq))
        create_video(pdir, os.path.join(
            cfg.logdir, f"train_{cfg.dataset.name}_{seq}.mp4"), fps=10)
        shutil.rmtree(pdir)

    def _save_scene_ply(self, iter_s: str):
        """The scene's live Gaussians as a 3DGS PLY under logdir/meshes
        (rank 0's)."""
        if not self.mesh.is_writer:
            return
        gs = self.scene.gs
        alive = gs.alive.cpu().numpy()

        def host(f):
            return getattr(gs, f).detach().cpu().numpy()[alive]
        save_gaussian_ply(
            f"{self.cfg.logdir}/meshes/scene_{iter_s}_splat.ply",
            host("xyz"), host("features_dc"), host("features_rest"),
            host("opacity"), host("scaling"), host("rotation"))

    def _iter0_dumps(self):
        """Iteration 0's dumps (reference gs_trainer.py:362-369): the
        scene's and the canonical human's PLYs and the turntable."""
        cfg = self.cfg
        if self.scene is not None:
            self._save_scene_ply("000000")
        self._save_human_ply(0)
        if cfg.mode in ("human", "human_scene") and self.human is not None:
            self.render_canonical(0, nframes=cfg.human.canon_nframes)

    @torch.no_grad()
    def _save_human_ply(self, t_iter: int | None):
        """The canonical human Gaussians as a 3DGS PLY, meshes/human_
        {iter}_splat.ply (reference gs_trainer.py:362-375): one
        human_forward at the zero pose, whose canonical attributes do
        not depend on the pose."""
        if self.human is None or not self.cfg.logdir \
                or not self.mesh.is_writer:
            return
        from hugs_tpu_torch.utils.vis import save_human_ply
        iter_s = "final" if t_iter is None else f"{t_iter:06d}"
        dev = self.device
        o = hgs.human_forward(
            self.human.params, self.human.state, self.fixed, self.human_cfg,
            global_orient=torch.zeros(3, device=dev),
            body_pose=torch.zeros(69, device=dev),
            betas=self.human.params.betas.detach(),
            transl=torch.zeros(3, device=dev),
            smpl_scale=torch.tensor(1.0, device=dev), compute_gt_lbs=False)
        save_human_ply(
            {k: o[k].detach().cpu().numpy() for k in
             ("xyz_canon", "shs", "opacity", "scales_canon", "rotq_canon",
              "alive")},
            f"{self.cfg.logdir}/meshes/human_{iter_s}_splat.ply")


class PoseRenderer:
    """The inference fast path's state (reference render_poses and
    forward_test, gs_trainer.py:686-747): the avatar alone, its
    canonical decode computed once and compacted to the live rows
    (compact_for_inference; the trainer's states are untouched), rendered
    under given cameras and poses at a budget a rehearsal sized.

    A frame is a dict of the camera ({'camera', 'width', 'height'}) and
    the body (global_orient, body_pose, betas, transl, smpl_scale), the
    body's keys taken from `smpl_params` where the frame lacks them."""

    def __init__(self, trainer: GaussianTrainer, smpl_params: dict,
                 bg_color: str = "white"):
        tr = self.trainer = trainer
        dev = tr.device
        self.smpl_params = smpl_params
        self.bg = (torch.ones(3, device=dev) if bg_color == "white"
                   else torch.zeros(3, device=dev))
        with torch.no_grad():
            canon = hgs.canon_forward(tr.human.params, tr.human.state,
                                      tr.human_cfg)
            self.params, self.state, self.canon = hgs.compact_for_inference(
                tr.human.params, tr.human.state, canon)
        self.budget = tr._ibudget

    @torch.no_grad()
    def human_forward(self, cp) -> dict:
        """The posed avatar of frame cp, from the cached decode."""
        tr = self.trainer
        data = dict(self.smpl_params, **cp)
        pose = tr._pose_kw(data)
        pose["body_pose"] = pose["body_pose"].reshape(-1)[:69]
        return hgs.human_forward(
            self.params, self.state, tr.fixed, tr.human_cfg,
            canon_out=self.canon, compute_gt_lbs=False,
            smpl_scale=tr._scale(data), **pose)

    @torch.no_grad()
    def frame(self, cp, budget: int | None = None,
              bin_only: bool = False) -> dict:
        """render_human_scene's pkg of frame cp, human alone, at `budget`
        (default the rehearsed one); bin_only stops after the binning."""
        return render_human_scene(
            {"camera": cp["camera"], "width": cp["width"],
             "height": cp["height"]}, self.human_forward(cp), None,
            bg_color=self.bg, render_mode="human",
            instance_budget=budget or self.budget, bin_only=bin_only)

    def rehearse(self, camera_params: list, probe_cap: int = 1 << 18) -> int:
        """Sets the budget to the frames' largest slot demand x 1.15 in
        8192-slot pages, each frame probed by a binning-only render at a
        budget of at least probe_cap. Returns it."""
        probe = max(self.trainer._ibudget, probe_cap)
        demand = max(int(self.frame(cp, probe, bin_only=True)["n_slots"])
                     for cp in camera_params)
        self.budget = min(max(1 << 14, -(-(demand * 23 // 20) // 8192)
                              * 8192), probe)
        return self.budget

    def render(self, cp, index: int = 0) -> torch.Tensor:
        """Frame cp's image (3, H, W). A frame that overflows the budget
        (a clipped probe under-reports) renders again at 1.5x its demand,
        up to 8 times, then is kept with a warning naming `index`."""
        b = self.budget
        for _ in range(8):
            pkg = self.frame(cp, b)
            if not bool(pkg["overflowed"]):
                return pkg["render"]
            b = -(-(int(pkg["n_slots"]) * 3 // 2) // 8192) * 8192
        print(f"WARNING: render_poses frame {index} still overflows the "
              f"instance budget after retries (budget {b}, demand > "
              f"{int(pkg['n_slots'])}): the image drops instances")
        return pkg["render"]


def render_poses(trainer: GaussianTrainer, camera_params: list,
                 smpl_params: dict, bg_color: str = "white",
                 probe_cap: int = 1 << 18) -> list:
    """The avatar alone under the given frames (camera dicts, each with
    its own body keys or smpl_params') with the canonical decode computed
    once: a PoseRenderer rehearsed on every frame. Returns the images
    (3, H, W)."""
    pr = PoseRenderer(trainer, smpl_params, bg_color)
    pr.rehearse(camera_params, probe_cap)
    return [pr.render(cp, i) for i, cp in enumerate(camera_params)]
