"""Traffic driver `trainer_steps`: the trainer's own loop, one frame a
step, in a closed loop.

Set-up makes the sequence from the seed (gen/neuman_sequence.py), writes
it in the NeuMan layout under the run's temporary directory, loads it
with the port's loader and builds one GaussianTrainer from the
configuration's recipe (the avatar's init distillation included), and
raises the SH degree by the program's own one-up as train() does at
iterations 1000, 2000 and 3000 (traffic key `sh_one_ups`), so that every
step runs at the recipe's degree. The
trainer's first steps, t_iter 0, 1, 2, go through the window's own call
(`Loop.step`, which is GaussianTrainer.train()'s loop body: _train_step,
then _periodic) on three different frames; their losses, step 1's
gradients (from Adam's first moments) and the parameters' change are
kept for the reference. Warm-up runs the same call until a sync step
shows the instance budget unchanged, then the window runs the same call,
steps dispatched ahead as train() dispatches them, for `seconds`; the
device's peak memory is taken from the window alone.

With trace 0 the window is timed; with trace 1 a short traced window
(the profiler, CUDA activity only) gives the kernels and the idle share,
then staged steps with CUDA events between the layers give the stages'
device times and, profiled, K1's and K2's, whose work the frozen plain
renderer counts from the staged steps' own Gaussians.

After the window, once the peak memory is read and the trainer freed,
the reference (reference/train_steps.py) runs the avatar's distillation
and then the first steps again, from the program's distilled nets, and
compare.py's numbers are held to the cell's limits.
"""
from __future__ import annotations

import copy
import os
import tempfile
import time

import numpy as np
import torch

from bench_port.gen.neuman_sequence import (
    camera, make_sequence, write_neuman,
)
from bench_port.reference import compare
from bench_port.reference.plain.models.human_gs import NET_FIELDS
from bench_port.reference.train_steps import reference_steps
from bench_port.trace import kernel_seconds, traced
from bench_port.work.blend import blend_work
from bench_port.work.step import step_least

CHECKED_STEPS = 3
WARMUP_MAX = 60          # steps: a budget still growing by then fails
STAGED_STEPS = 5
STAGES = ("human_forward", "render", "loss", "backward", "optim")
# the blend kernels' names in the trace (csrc/blend_fwd.cu, blend_bwd.cu),
# in both modes
K1_NAMES = ("blend_fwd_kernel", "blend_fwd_mxu_kernel")
K2_NAMES = ("blend_bwd_kernel", "blend_bwd_mxu_kernel")


def lpips_arrays(seed: int, device) -> dict:
    """LPIPS's VGG16 weights from the seed, in the .npz layout (HWIO
    convs, zero biases, heads 1 / c): He-initialised on the device in
    one call a layer."""
    from bench_port.reference.plain.losses.lpips import VGG_BLOCKS
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    out, cin, i = {}, 3, 0
    for t, (cout, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            w = torch.randn((3, 3, cin, cout), generator=gen, device=device)
            out[f"conv_{i}_w"] = (w * float(np.sqrt(2.0 / (9 * cin)))).cpu() \
                .numpy()
            out[f"conv_{i}_b"] = np.zeros(cout, np.float32)
            cin, i = cout, i + 1
        out[f"lin_{t}"] = np.full(cout, 1.0 / cout, np.float32)
    return out


class Loop:
    """GaussianTrainer.train()'s loop body, one step a call: the frame
    order from the trainer's RandomState, _train_step, then _periodic."""

    def __init__(self, trainer):
        self.tr = trainer
        self.n = len(trainer.train_dataset)
        self.order = trainer.rng.permutation(self.n)
        self.pos = 0
        self.t_iter = 0

    def next_frame(self):
        """The next step's (train position, frame), in train()'s order."""
        if self.pos >= self.n:
            self.order = self.tr.rng.permutation(self.n)
            self.pos = 0
        idx = int(self.order[self.pos])
        self.pos += 1
        return idx, self.tr.train_dataset[idx]

    def step(self):
        tr = self.tr
        idx, data = self.next_frame()
        t = self.t_iter
        sync = tr._is_sync_step(t)
        aux, vals = tr._train_step(t, idx, data, sync)
        if t % 10 == 0 and vals is not None and vals[2] \
                and tr._ibudget_fixed:
            print(f"WARNING: tile-instance budget overflow at iter {t}")
        tr._periodic(t, aux, data)
        self.t_iter += 1
        return aux


def program_leaves(trainer) -> dict:
    """The trainer's optimizer leaves, named as the reference names
    them, with their first moments: {name: (parameter, moment)}."""
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models import scene_gs as sgs
    out = {}
    if trainer.human is not None:
        mu = trainer.human.opt.mu
        for g, group in hgs.params_of(trainer.human.params).items():
            if isinstance(group, torch.nn.Module):
                for n, p in group.named_parameters():
                    out[f"human.{g}.{n}"] = (p, mu[g][n])
            else:
                out[f"human.{g}"] = (group, mu[g])
    if trainer.scene is not None:
        mu = trainer.scene.opt.mu
        for k, p in sgs.params_of(trainer.scene.gs).items():
            out[f"scene.{k}"] = (p, mu[k])
    return out


def snapshot(trainer) -> dict:
    """The trainer's parameters on the host, by leaf name."""
    return {k: p.detach().cpu().clone()
            for k, (p, _) in program_leaves(trainer).items()}


def checked_steps(loop: Loop, fault: str | None = None) -> dict:
    """The trainer's first CHECKED_STEPS steps through the window's call:
    {'losses', 'grad_norms' (from Adam's first moment after step 1, over
    1 - beta1), 'change_norms' (over the steps)}. `fault` breaks the step
    underneath, for the checks of the check: 'unchanged' returns the
    state unchanged, 'half' takes the loss over half of the frame
    ('undistilled' acts in Cell, before these steps)."""
    tr = loop.tr
    start = snapshot(tr)
    losses, grads = [], {}
    with _faulty(tr, fault):
        for i in range(CHECKED_STEPS):
            aux = loop.step()
            losses.append(float(aux["loss"].double()))
            if i == 0:
                grads = {k: float(torch.linalg.vector_norm(
                    m.double() / (1 - 0.9)))
                    for k, (_, m) in program_leaves(tr).items()}
    change = {k: float(torch.linalg.vector_norm(
        p.detach().double().cpu() - start[k].double()))
        for k, (p, _) in program_leaves(tr).items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


class _faulty:
    """Breaks the trainer's step for the checks of the check."""

    def __init__(self, trainer, fault):
        self.tr, self.fault, self.undo = trainer, fault, []

    def __enter__(self):
        from hugs_tpu_torch.train import joint_step as jst
        from hugs_tpu_torch.train import scene_step as sst
        if self.fault in (None, "undistilled"):
            return self
        if self.fault == "unchanged":
            tr = self.tr
            real = tr._train_step

            def no_update(t_iter, idx, data, sync):
                mode = tr._mode(t_iter)
                bg, human_bg, draws = tr._step_draws(mode, data["height"],
                                                     data["width"])
                loss, fw = tr._forward(mode, t_iter, idx, data, bg,
                                       human_bg, draws)
                return {"loss": loss.detach(), **{
                    k: fw["pkg"][k] for k in ("overflowed", "n_instances",
                                              "n_slots")}}, None
            tr._train_step = no_update
            self.undo.append(lambda: setattr(tr, "_train_step", real))
        elif self.fault == "half":
            real_s, real_j = sst.scene_loss, jst.joint_loss

            def top(x):
                return x[..., :x.shape[-2] // 2, :]

            def scene_half(img, gt, *a, **k):
                return real_s(top(img), top(gt), *a, **k)

            def joint_half(loss_fn, draws, gt, mask, bg, human_bg, pkg,
                           h_out, lpips=None):
                pkg = dict(pkg, render=top(pkg["render"]))
                if "human_img" in pkg:
                    pkg["human_img"] = top(pkg["human_img"])
                h = gt.shape[-2] // 2
                d = draws._replace(**{
                    k: getattr(draws, k)[..., :h, :] for k in
                    ("lpips_bg", "lpips_bg_human")
                    if getattr(draws, k) is not None})
                rows = max(h - loss_fn.patch_size, 1)
                d = d._replace(**{
                    k: getattr(d, k)._replace(
                        gumbel=getattr(d, k).gumbel[:h * gt.shape[-1]],
                        ux=getattr(d, k).ux % rows)
                    for k in ("patches", "patches_human")
                    if getattr(d, k) is not None})
                return real_j(loss_fn, d, top(gt), top(mask), bg, human_bg,
                              pkg, h_out, lpips)
            sst.scene_loss, jst.joint_loss = scene_half, joint_half
            self.undo.append(lambda: (setattr(sst, "scene_loss", real_s),
                                      setattr(jst, "joint_loss", real_j)))
        else:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self

    def __exit__(self, *exc):
        for f in self.undo:
            f()
        return False


def restore(trainer, start: dict, gen_state) -> None:
    """The trainer back at its first step: parameters from `start`,
    Adam's moments and count zero, the statistics cleared, the
    generator's state as it was. The caller makes a new Loop."""
    for k, (p, m) in program_leaves(trainer).items():
        with torch.no_grad():
            p.copy_(start[k].to(p.device))
    for st in (trainer.human, trainer.scene):
        if st is None:
            continue
        for moments in (st.opt.mu, st.opt.nu):
            for t in _tensors(moments):
                t.zero_()
        st.opt.step.zero_()
    if trainer.human is not None:
        s = trainer.human.state
        for t in (s.max_radii2d, s.xyz_gradient_accum, s.denom):
            t.zero_()
    if trainer.scene is not None:
        gs = trainer.scene.gs
        for t in (gs.max_radii2d, gs.xyz_gradient_accum, gs.denom):
            t.zero_()
    trainer.gen.set_state(gen_state)
    trainer.rng = np.random.RandomState(int(trainer.cfg.seed))


def _tensors(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    else:
        yield x


class Cell:
    """One cell's set-up: the sequence, the dataset, the trainer and its
    checked first steps, with the times of each part."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tmp: str, fault: str | None = None):
        from hugs_tpu_torch.cfg import Config
        from hugs_tpu_torch.data.neuman import NeumanDataset
        from hugs_tpu_torch.models.smpl import make_smpl_model
        from hugs_tpu_torch.train.trainer import GaussianTrainer
        self.split = {}
        t = time.perf_counter()
        dev = torch.device(device)
        self.seed = seed
        self.recipe = copy.deepcopy(config["recipe"])
        self.recipe["seed"] = seed % (1 << 32)
        self.seq = make_sequence(traffic, config["scene_points"],
                                 config["body_vpb"], seed, dev)
        t = self._mark("sequence_s", t, dev)
        write_neuman(self.seq, os.path.join(tmp, "neuman"),
                     traffic["sequence"])
        self.lpips = None
        human = self.recipe["mode"] != "scene"
        if human and self.recipe["human"]["loss"]["lpips_w"] > 0:
            self.lpips = lpips_arrays(seed, dev)
            path = os.path.join(tmp, "lpips.npz")
            np.savez(path, **self.lpips)
            self.recipe["tpu"]["lpips_weights"] = path
        self.recipe["dataset_path"] = os.path.join(tmp, "neuman")
        self.recipe["dataset"]["seq"] = traffic["sequence"]
        self.recipe["logdir"] = ""
        t = self._mark("write_s", t, dev)
        program = copy.deepcopy(self.recipe)
        if fault == "undistilled":    # the avatar's nets left as drawn
            program["human"]["init_steps"] = 0
        cfg = Config(program)
        s = cfg.scene
        ds = NeumanDataset(cfg.dataset_path, cfg.dataset.seq, "train",
                           render_mode=cfg.mode,
                           add_bg_points=s.add_bg_points,
                           num_bg_points=s.num_bg_points,
                           bg_sphere_dist=s.bg_sphere_dist,
                           clean_pcd=s.clean_pcd, device=dev)
        t = self._mark("load_s", t, dev)
        b = self.seq.body
        body = make_smpl_model(
            b.v_template.cpu().numpy(), b.shapedirs.cpu().numpy(),
            b.posedirs.cpu().numpy(), b.J_regressor.cpu().numpy(),
            b.lbs_weights.cpu().numpy(), b.parents, b.faces,
            device=dev) if human else None
        self.trainer = GaussianTrainer(cfg, train_dataset=ds,
                                       smpl_model=body, device=dev)
        self.one_ups = int(traffic["sh_one_ups"])
        for k in range(1, self.one_ups + 1):
            self.trainer._periodic(1000 * k, None)
        t = self._mark("trainer_s", t, dev)
        self.gen_state = self.trainer.gen.get_state()
        self.start = snapshot(self.trainer)
        self.loop = Loop(self.trainer)
        self.program = checked_steps(self.loop, fault)
        t = self._mark("checked_steps_s", t, dev)
        # the distillation's output, where the reference's steps start
        self.nets = {k.split(".", 1)[1]: v for k, v in self.start.items()
                     if k.split(".")[1] in NET_FIELDS} if human else None

    def _mark(self, name, t, dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.split[name] = now - t
        return now

    def warm_up(self):
        """Steps through the window's call until a sync step shows the
        instance budget unchanged since the previous one."""
        tr, loop = self.trainer, self.loop
        last = tr._ibudget     # as the first step, a sync step, left it
        while loop.t_iter < WARMUP_MAX:
            sync = tr._is_sync_step(loop.t_iter)
            loop.step()
            if sync:
                if last == tr._ibudget:
                    return
                last = tr._ibudget
        raise RuntimeError(f"the instance budget still grew after "
                           f"{WARMUP_MAX} warm-up steps")

    def reference(self, tf32: bool = False, judged: tuple = ()) -> dict:
        return reference_steps(self.recipe, self.seq, self.lpips,
                               CHECKED_STEPS, self.one_ups,
                               self.seq.body.v_template.device, self.nets,
                               tf32, judged)

    def again(self, fault: str | None = None) -> dict:
        """The checked steps again from the first step, with `fault`."""
        restore(self.trainer, self.start, self.gen_state)
        self.loop = Loop(self.trainer)
        return checked_steps(self.loop, fault)


def staged_step(loop: Loop, events: dict | None) -> dict:
    """One step of the window's loop through the trainer's stage
    functions, a CUDA event between stages where `events` is given (after
    GaussianTrainer._train_step's calls, without its retry). Returns the
    loss and the render's inputs for the work count."""
    from hugs_tpu_torch.models import scene_gs as sgs
    from hugs_tpu_torch.train import joint_step as jst
    from hugs_tpu_torch.train import scene_step as sst
    tr = loop.tr
    idx, data = loop.next_frame()
    t = loop.t_iter
    mode = tr._mode(t)
    W, H = data["width"], data["height"]

    def mark(name):
        if events is None:
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.setdefault(name, []).append(e)

    bg, human_bg, draws = tr._step_draws(mode, H, W)
    cam, gt, mask = data["camera"], data["rgb"], data["mask"]
    mark("start")
    if mode == "scene":
        hook = torch.zeros((tr._s_cap, 2), device=tr.device,
                           requires_grad=True)
        pkg = sst.scene_render(tr.scene.gs, cam, bg, hook, width=W, height=H,
                               instance_budget=tr._ibudget)
        mark("render")
        loss = sst.scene_loss(pkg["render"], gt, tr.cfg.scene.loss.l1_w,
                              tr.cfg.scene.loss.ssim_w)
        mark("loss")
        grads, hook_grad = sst.scene_grads(loss, tr.scene.gs, hook)
        mark("backward")
        sst.scene_update(tr.scene, grads, hook_grad, pkg, tr.s_xyz_sched(t),
                         tr.s_static_lrs, width=W, height=H)
        mark("optim")
        h_out = None
    else:
        js = jst.JointTrainState(human=tr.human, scene=tr.scene)
        hook = torch.zeros((tr._h_cap + tr._s_cap, 2), device=tr.device,
                           requires_grad=True)
        pkg, h_out = jst.joint_render(
            js, tr.fixed, cam, bg, human_bg, hook, tr._scale(data), idx,
            cfg=tr.human_cfg, width=W, height=H,
            instance_budget=tr._ibudget,
            render_human_separate=tr.loss_fn.l_humansep_w > 0,
            between=lambda: mark("human_forward"))
        mark("render")
        loss, _ = jst.joint_loss(tr.loss_fn, draws, gt, mask, bg, human_bg,
                                 pkg, h_out, tr.lpips
                                 if tr.loss_fn.l_lpips_w > 0 else None)
        mark("loss")
        h_grads, s_grads, hook_grad = jst.joint_grads(
            loss, js, hook, tr.cfg.train.optim_scene)
        mark("backward")
        jst.joint_update(js, h_grads, s_grads, hook_grad, pkg,
                         tr.h_xyz_sched(t), tr.h_static_lrs,
                         tr.s_xyz_sched(t), tr.s_static_lrs, width=W,
                         height=H)
        mark("optim")
    tr._periodic(t, None, data)
    loop.t_iter += 1
    with torch.no_grad():
        s_out = sgs.scene_forward(tr.scene.gs)
        sets = []
        keys = ("xyz", "scales", "rotq", "opacity", "shs")
        if h_out is None:
            sets.append(({k: s_out[k].detach().clone() for k in keys},
                         s_out["alive"].clone(), s_out["active_sh_degree"],
                         bg))
        else:
            merged = {k: torch.cat([h_out[k].detach(), s_out[k]]) for k in
                      keys}
            alive = torch.cat([h_out.get("alive", torch.ones(
                h_out["xyz"].shape[0], dtype=torch.bool, device=tr.device)),
                s_out["alive"]])
            sets.append((merged, alive, h_out["active_sh_degree"], bg))
            if tr.loss_fn.l_humansep_w > 0:
                sets.append(({k: h_out[k].detach().clone() for k in keys},
                             h_out.get("alive"), h_out["active_sh_degree"],
                             human_bg))
    return {"loss": loss.detach(), "sets": sets, "frame": idx,
            "width": W, "height": H,
            "world_view": cam.world_view.clone()}


def stage_ms(events: dict) -> dict:
    """Each stage's mean device ms over the staged steps."""
    order = ["start"] + [s for s in STAGES if s in events]
    out = {}
    for a, b in zip(order, order[1:]):
        out[b] = float(np.mean([x.elapsed_time(y) for x, y in
                                zip(events[a], events[b])]))
    return out


def run(config: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device="cuda",
        t_process: float | None = None, fault: str | None = None) -> dict:
    """One run of a cell. Returns the record run.py reads: 'setup_s',
    'setup_split', 'steps', 'window_s', 'memory_peak_bytes' (the
    window's), 'setup_peak_bytes', 'checks'
    [(name, value, limit, where)], and with trace the traced window's
    'device_trace', 'stage_ms', K1's and K2's device seconds ('k1_s',
    'k2_s') and work ('k1_work', 'k2_work': operations, bytes) over the
    staged steps, their 'step_least' and 'renders'. `fault` breaks the
    checked steps (checked_steps), for the benchmark's tests."""
    dev = torch.device(device)
    t_process = time.perf_counter() if t_process is None else t_process
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        t_cell = time.perf_counter()
        cell = Cell(config, traffic, seed, dev, tmp, fault)
        t_warm = time.perf_counter()
        cell.warm_up()
        _sync(dev)
        out["setup_s"] = time.perf_counter() - t_process
        out["setup_peak_bytes"] = _peak(dev, reset=True)
        out["setup_split"] = dict(
            start_s=t_cell - t_process, **cell.split,
            warmup_s=time.perf_counter() - t_warm,
            warmup_steps=cell.loop.t_iter - CHECKED_STEPS)
        loop = cell.loop
        if not trace:
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < seconds:
                loop.step()
                n += 1
            _sync(dev)
            out["window_s"] = time.perf_counter() - t0
            out["steps"] = n
        else:
            out.update(_traced(cell, traffic, dev))
        out["memory_peak_bytes"] = _peak(dev)
        out["budget"] = cell.trainer._ibudget
        program = cell.program
        cell.trainer = cell.loop = loop = None
        _free(dev)
        t_ref = time.perf_counter()
        ref = cell.reference()
        out["reference_s"] = time.perf_counter() - t_ref
    got = compare.gaps(program, ref)
    out["checks"] = [(k, v, float(limits[k]), where)
                     for k, (v, where) in got.items()]
    return out


def _traced(cell: Cell, traffic: dict, dev) -> dict:
    """The traced window, then the staged steps and their work."""
    loop = cell.loop
    t_trace = float(traffic["trace_seconds"])

    def window():
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < t_trace:
            loop.step()
            n += 1
        return n
    steps, dt = traced(window)
    events, staged = {}, []

    def stages():
        for _ in range(STAGED_STEPS):
            staged.append(staged_step(loop, events))
    _, st = traced(stages)
    rec = {"steps": steps, "device_trace": dt, "stage_ms": stage_ms(events),
           "k1_s": kernel_seconds(st, K1_NAMES),
           "k2_s": kernel_seconds(st, K2_NAMES)}
    tr = cell.trainer
    human_rows = int(tr.human.state.alive.sum()) if tr.human else 0
    scene_rows = int(tr.scene.gs.alive.sum()) if tr.scene else 0
    net_elems = (sum(p.numel() for name, p in tr.human.params
                     .named_parameters() if name.split(".")[0] in NET_FIELDS)
                 if tr.human else 0)
    body_verts = tr.fixed.vitruvian_verts.shape[0] if tr.human else 0
    k1 = [0.0, 0.0]
    k2 = [0.0, 0.0]
    least, renders = [], []
    for s in staged:
        cam = camera(s["world_view"].cpu().numpy(), cell.seq.fov, dev)
        works = []
        for attrs, alive, deg, bg in s["sets"]:
            works.append(blend_work(attrs["xyz"], attrs["scales"],
                                    attrs["rotq"], attrs["opacity"],
                                    attrs["shs"], alive, cam, s["width"],
                                    s["height"], bg, deg))
        renders += [w._asdict() for w in works]
        for w in works:
            for acc, (ops, nb) in ((k1, w.k1()), (k2, w.k2())):
                acc[0] += ops
                acc[1] += nb
        least.append(step_least(cell.recipe, works, human_rows, body_verts,
                                scene_rows, net_elems,
                                s["width"] * s["height"]))
    rec.update(k1_work=tuple(k1), k2_work=tuple(k2), step_least=least,
               renders=renders)
    return rec


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev, reset: bool = False) -> int:
    """The device's peak of allocated bytes since the last reset;
    `reset` starts a new count."""
    if dev.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
