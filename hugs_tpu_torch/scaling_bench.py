"""The multi-card scaling harness (the counterpart of
scripts/scaling_bench.py): the data x tile joint step
(parallel/train_dp_tile.py) timed over process counts under weak
scaling.

  worker    one process of a torch.distributed job: joins the group from
            torchrun's variables (NCCL on card LOCAL_RANK; gloo with
            --device cpu), builds the ('data', 'tile') mesh
            (multihost.make_hybrid_mesh), takes one warm-up step, times
            --iters steps and, apart, the step's gradient payload through
            --iters chained all-reduces; rank 0 prints one JSON line.
  launcher  for each N of --procs runs `python -m torch.distributed.run
            --standalone --nproc_per_node=N -m hugs_tpu_torch.scaling_bench
            worker ...`
            on this machine, reads rank 0's last JSON line and writes the
            list to --out/scaling.json.

  python -m hugs_tpu_torch.scaling_bench launcher --procs 1 2 4 \\
      [--device cpu] [--out DIR] [the worker's flags]
  python -m torch.distributed.run --nproc_per_node=N \\
      -m hugs_tpu_torch.scaling_bench worker [--device cpu] ...

Weak scaling: each data row of the mesh (its n_tile ranks; one rank with
the launcher's n_tile 1) is the script's process and trains its own
frame, frame d of row d, its target and mask from RandomState(1234 + d),
so ideal scaling is a flat step time; only the end-of-step gradient
all-reduce crosses ranks when n_tile is 1. Every rank builds the whole
batch (the step takes it whole, the same list on every rank) and trains
its share of it. The isolated all-reduce moves
the step's payload, n_grad float32 values (every trainable parameter and
the mean2d hook of both sets, as the script counts them), --iters times
between two CUDA events after a warm-up call; comm_fraction is its time
over the step's.

The models are graft_entry._build_models at the script's sizes
(synthetic_smpl(--verts_per_bone), human and scene capacity --capacity,
a --triplane_res^2 triplane of --n_features, seed 0), the loss L1 0.8 +
SSIM 0.2 + LBS 10 with no patches, LPIPS or humansep pass (one K1 and
one K2 launch per frame of a step), the rates step 0's of the default
config. --budget 0 sizes each band's slot budget from a binning-only
probe of the batch (the demand x 1.5 in train/budget.py's buckets).

The script's --local_devices, --tile, --tile_cap and --backend have no
counterpart: a process drives one card (one CPU process with --device
cpu), K1 and K2 take 16x16 tiles and truncate nothing, and the route
follows the device (the CUDA kernels on the card, the plain versions on
the CPU; `backend` in the JSON says which). A worker without a card
exits 2 unless --device cpu; the launcher refuses an N above the cards
(two ranks never share a card). With --device cpu the launcher gives its
ranks RANK_THREADS CPU threads each (OMP_NUM_THREADS, unless the caller
set it), as parallel/launch.py's ranks run: N ranks share one machine's
cores, and torchrun itself leaves one rank at every core.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.graft_entry import _build_models
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.micro import card, device_kernels
from hugs_tpu_torch.models import human_gs as hgs
from hugs_tpu_torch.models import scene_gs as sgs
from hugs_tpu_torch.parallel.collectives import pmax
from hugs_tpu_torch.parallel.launch import RANK_THREADS
from hugs_tpu_torch.parallel.mesh import Mesh, init_distributed
from hugs_tpu_torch.parallel.multihost import (
    global_batch, make_hybrid_mesh, sync_hosts,
)
from hugs_tpu_torch.parallel.shard import band_height
from hugs_tpu_torch.parallel.train_dp_tile import KEYS, make_dp_tile_train_step
from hugs_tpu_torch.render import cuda_blend, make_camera
from hugs_tpu_torch.render.project import project_gaussians, update_mean2d
from hugs_tpu_torch.render.tiles import TILE, bin_gaussians
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train.budget import grown_budget
from hugs_tpu_torch.train.human_step import (
    init_human_train_state, make_human_lrs,
)
from hugs_tpu_torch.train.joint_step import JointTrainState
from hugs_tpu_torch.train.optim import leaves
from hugs_tpu_torch.train.scene_step import (
    init_scene_train_state, make_scene_lrs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
TIMEOUT = 1200.0            # seconds for one launcher run (the script's)
PROBE_CAP = 1 << 18         # the binning-only probe's first budget
LOSS_KW = dict(l_l1_w=0.8, l_ssim_w=0.2, l_lbs_w=10.0, l_humansep_w=0.0,
               use_patches=False)
# the keys of the script's JSON line (scripts/scaling_bench.py:178-186)
SCRIPT_KEYS = ("procs", "mesh", "n_frames", "step_ms", "px_per_s",
               "backend", "grad_allreduce_ms", "grad_payload_mb",
               "comm_fraction", "loss")


def frame_np(rank: int, width: int, height: int) -> dict:
    """The frame of the script's process `rank` (:104-120, local_frames
    1): an identity rotation, the translation t = (0.1 rank, 0.2, 2.5);
    its target and mask from RandomState(1234 + rank)."""
    rng = np.random.RandomState(1234 + rank)
    target = rng.rand(1, 3, height, width).astype(np.float32)
    mask = (rng.rand(1, height, width) > 0.3).astype(np.float32)
    return {"t": np.array([0.1 * rank, 0.2, 2.5], np.float32),
            "rgb": target[0], "mask": mask[0], "dataset_idx": rank}


def whole_batch(n_procs: int, width: int, height: int, device) -> list:
    """The frames of the script's n_procs processes in order, the batch
    the step takes on each rank."""
    frames = []
    for f in global_batch([frame_np(r, width, height)
                           for r in range(n_procs)], device):
        frames.append(dict(
            camera=make_camera(np.eye(3, dtype=np.float32), f["t"], 0.9,
                               0.9, device=device),
            rgb=f["rgb"], mask=f["mask"], bg=torch.ones(3, device=device),
            human_bg=torch.ones(3, device=device),
            smpl_scale=torch.tensor(1.0, device=device),
            dataset_idx=int(f["dataset_idx"]), draws=LossDraws()))
    return frames


def n_grad_of(h_params, scene) -> int:
    """The step's gradient payload in floats, as the script counts it
    (:140-143): every trainable tensor of the avatar and the scene's six
    parameters, plus the mean2d hook (2 per row of both sets)."""
    h = sum(t.numel() for t in leaves(hgs.params_of(h_params)))
    s = sum(getattr(scene, f).numel() for f in sgs.PARAM_FIELDS)
    return h + s + 2 * (h_params.xyz.shape[0] + scene.capacity)


@torch.no_grad()
def probe_budget(jstate, fixed, cfg, frames, mesh: Mesh, width: int,
                 height: int) -> int:
    """Each band's slot budget from a binning-only probe (no blend) of
    this rank's share of the batch, at a roomy budget that grows until
    the probe fits: grown_budget of the largest demand over the mesh."""
    n_tile = mesh.shape["tile"]
    band_h = band_height(height, n_tile)
    cap, demand = PROBE_CAP, torch.zeros(2, dtype=torch.int64)
    s_out = sgs.scene_forward(jstate.scene.gs)
    for fr in frames[mesh.local_slice(len(frames))]:
        h_out = hgs.human_forward(jstate.human.params, jstate.human.state,
                                  fixed, cfg, smpl_scale=fr["smpl_scale"],
                                  dataset_idx=fr["dataset_idx"],
                                  compute_gt_lbs=False)
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in KEYS}
        pg = project_gaussians(a["xyz"], a["scales"], a["rotq"],
                               a["opacity"], a["shs"], fr["camera"], width,
                               height, h_out["active_sh_degree"],
                               alive=torch.cat([h_out["alive"],
                                                s_out["alive"]]))
        for t in range(n_tile):
            band = update_mean2d(pg, pg.mean2d.new_tensor(
                [0.0, -float(t * band_h)]))
            for _ in range(8):
                bins = bin_gaussians(band, width, band_h, cap, TILE)
                if not bool(bins.overflowed):
                    break
                cap = max(2 * cap, int(bins.n_slots) * 3 // 2)
            else:
                raise RuntimeError(f"the budget probe still overflowed at "
                                   f"{cap}")
            got = torch.tensor([int(bins.n_slots), int(bins.n_instances)])
            demand = torch.maximum(demand, got)
    demand = pmax(demand.to(frames[0]["rgb"].device), mesh).cpu()
    return grown_budget(0, int(demand[0]), int(demand[1]))


def state_digest(jstate) -> str:
    """sha256 over every tensor of both states (checkpoint.flatten's
    names and bytes)."""
    h = hashlib.sha256()
    for st in (jstate.human, jstate.scene):
        for k, v in sorted(ckpt_io.flatten(st).items()):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event_span(fn, device):
    """fn() and its CUDA-event time in ms (None off the card)."""
    if device.type != "cuda":
        fn()
        return None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def allreduce_ms(n_grad: int, mesh: Mesh, iters: int, device) -> float:
    """The step's payload through `iters` chained all-reduces over both
    axes (each scaled by 1 / the ranks, as the script's psum body), after
    one warm-up all-reduce: ms per all-reduce (CUDA events on the card,
    the host clock on the CPU)."""
    rank = dist.get_rank() if mesh.distributed else 0
    y = torch.arange(n_grad, dtype=torch.float32, device=device) * 1e-6 \
        + rank
    inv = 1.0 / mesh.size

    def chain(k):
        for _ in range(k):
            if mesh.distributed:
                dist.all_reduce(y, group=mesh.group(("data", "tile")))
            y.mul_(inv)

    chain(1)
    _sync(device)
    sync_hosts()
    t0 = time.perf_counter()
    ms = _event_span(lambda: chain(iters), device)
    if ms is None:
        ms = (time.perf_counter() - t0) * 1e3
    return ms / iters


def device_profile(fn, device) -> dict | None:
    """torch.profiler's CUDA trace of fn(): device busy share of the span
    from the first kernel to the last, NCCL's kernels apart (None off
    the card)."""
    if device.type != "cuda":
        return None
    by_name, n, span = device_kernels(fn, reps=1)
    if not span:
        return {"kernels": 0, "idle_share": None}
    nccl = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    busy = sum(by_name.values())
    return {"kernels": n, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span, "nccl_share": nccl / span}


def build_models(opts: dict, n_frames: int, device, carried=None):
    """(cfg, fixed, jstate, n_grad): _build_models at the options' sizes
    from SEED, or `carried` (state, smpl and config as numpy, from
    convert's layout) on `device`."""
    if carried is not None:
        from hugs_tpu_torch.parallel.check import _setup
        jstate, fixed, cfg, _ = _setup(*carried, [], device)
        return cfg, fixed, jstate, n_grad_of(jstate.human.params,
                                             jstate.scene.gs)
    cfg, h_params, h_state, fixed, scene = _build_models(
        SEED, verts_per_bone=opts["verts_per_bone"],
        human_capacity=opts["capacity"], scene_n=opts["capacity"],
        scene_capacity=opts["capacity"], triplane_res=opts["triplane_res"],
        n_features=opts["n_features"], device=device, n_frames=n_frames)
    jstate = JointTrainState(human=init_human_train_state(h_params, h_state),
                             scene=init_scene_train_state(scene))
    return cfg, fixed, jstate, n_grad_of(h_params, scene)


def measure(opts: dict, device, carried=None) -> dict:
    """One rank's run of the worker (the process group joined, or none
    for one process): the step timed over opts['iters'] steps after a
    warm-up, the payload's all-reduce, the state digests of every rank.
    Returns the script's keys and this port's (every rank the same
    record, but for the device profile and the launches, which are its
    own)."""
    device = torch.device(device)
    mesh = make_hybrid_mesh(opts["n_tile"])
    world = mesh.size
    n_data = mesh.shape["data"]
    W, H, iters = opts["width"], opts["height"], opts["iters"]
    cfg, fixed, jstate, n_grad = build_models(opts, n_data, device, carried)
    # a data row (its tile ranks) is the script's process: one frame each
    frames = whole_batch(n_data, W, H, device)
    budget = opts["budget"] or probe_budget(jstate, fixed, cfg, frames,
                                            mesh, W, H)
    step = make_dp_tile_train_step(mesh, fixed, cfg, width=W, height=H,
                                   loss_fn=HumanSceneLoss(**LOSS_KW),
                                   instance_budget=budget)
    dcfg = load_config(None)
    h_static, h_sched = make_human_lrs(dcfg.human.lr)
    s_static, s_sched = make_scene_lrs(dcfg.scene.lr, 1.0)
    lrs = (h_sched(0), h_static, s_sched(0), s_static)

    def one():
        return step(jstate, frames, *lrs)[1]

    aux = one()                                     # warm-up
    if bool(aux["overflowed"]):
        raise RuntimeError(f"the step overflowed its band budget {budget} "
                           f"(n_slots {int(aux['n_slots'])}); pass "
                           f"--budget 0 to size it from a probe")
    _sync(device)
    sync_hosts()
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    events = []
    t0 = time.perf_counter()
    for _ in range(iters):
        events.append(_event_span(lambda: aux.update(one()), device))
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    loss, overflowed = float(aux["loss"]), bool(aux["overflowed"])
    ar_ms = allreduce_ms(n_grad, mesh, iters, device)
    digest = state_digest(jstate)
    profile = device_profile(one, device)
    digests = [digest]
    if mesh.distributed:
        digests = [None] * world
        dist.all_gather_object(digests, digest)
    step_ms = dt * 1e3
    return {
        "procs": world, "mesh": dict(mesh.shape), "n_frames": n_data,
        "step_ms": step_ms, "px_per_s": W * H * n_data / dt,
        "backend": "cuda" if device.type == "cuda" else "plain",
        "grad_allreduce_ms": ar_ms,
        "grad_payload_mb": round(n_grad * 4 / 1e6, 2),
        "comm_fraction": ar_ms / step_ms, "loss": loss,
        "n_grad": n_grad, "overflowed": overflowed,
        "step_ms_events_median": (statistics.median(events)
                                  if events[0] is not None else None),
        "step_ms_events": events, "iters": iters,
        "k1_launches": k1, "k2_launches": k2,
        "k1_per_step": k1 / iters, "k2_per_step": k2 / iters,
        "budget": budget, "width": W, "height": H,
        "capacity": opts["capacity"],
        "verts_per_bone": opts["verts_per_bone"],
        "triplane_res": opts["triplane_res"],
        "n_features": opts["n_features"],
        "device_profile": profile, "state_digests": [d[:16] for d in digests],
        "card": card() if device.type == "cuda" else None,
    }


def worker_rank(rank: int, world: int, opts: dict, device_type: str = "cpu",
                carried=None) -> dict:
    """measure() on rank `rank` of a group parallel/launch.py::run_ranks
    joined (card `rank` for cuda)."""
    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    return measure(opts, dev, carried)


def worker(opts: dict) -> int:
    """The worker command: joins torchrun's group (or runs alone), runs
    measure(), rank 0 prints the JSON line."""
    if opts["device"] == "cuda" and not torch.cuda.is_available():
        print("scaling_bench: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    dev = init_distributed(opts["device"])
    try:
        rec = measure(opts, dev)
        if not (dist.is_initialized() and dist.get_rank()):
            print(json.dumps(rec), flush=True)
        sync_hosts()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


WORKER_FLAGS = ("width", "height", "capacity", "budget", "n_tile", "iters",
                "verts_per_bone", "triplane_res", "n_features", "device")


def launch(opts: dict, log=print) -> list[dict]:
    """The launcher: for each N of opts['procs'], torchrun with N ranks on
    this machine; each record is rank 0's last JSON line. Raises
    RuntimeError when a run fails or times out, or when an N exceeds the
    cards (cuda). Writes the list to opts['out']/scaling.json."""
    if opts["device"] == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        over = [n for n in opts["procs"] if n > cards]
        if over:
            raise RuntimeError(f"--procs {over} exceed the {cards} CUDA "
                               f"device(s): each rank needs a card of its "
                               f"own (--device cpu runs gloo ranks)")
    results = []
    for n in opts["procs"]:
        # --standalone: the rendezvous binds a free port itself (a port
        # probed beforehand can be taken by the time torchrun listens)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", "-m", "hugs_tpu_torch.scaling_bench",
               "worker"]
        for k in WORKER_FLAGS:
            if opts[k] is not None:
                cmd += [f"--{k}", str(opts[k])]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        if opts["device"] == "cpu":
            env.setdefault("OMP_NUM_THREADS", str(RANK_THREADS))
        try:
            p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=TIMEOUT)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"{n} ranks: no result within {TIMEOUT} s") \
                from e
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"{n} ranks exited with {p.returncode}:\n"
                               + p.stderr[-4000:])
        log(lines[-1])
        results.append(json.loads(lines[-1]))
    os.makedirs(opts["out"], exist_ok=True)
    with open(os.path.join(opts["out"], "scaling.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def parse_args(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", choices=["worker", "launcher"])
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--budget", type=int, default=8192,
                    help="each band's slot budget; 0 sizes it from a "
                         "binning-only probe")
    ap.add_argument("--n_tile", type=int, default=None,
                    help="ranks on the tile axis (default: a host's ranks;"
                         " the launcher passes 1, one card a process)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--verts_per_bone", type=int, default=16)
    ap.add_argument("--triplane_res", type=int, default=32)
    ap.add_argument("--n_features", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join("runs", "scaling_bench"),
                    help="the launcher's directory for scaling.json")
    opts = vars(ap.parse_args(argv))
    if opts["iters"] < 1:
        ap.error("--iters must be at least 1")
    return opts


def main(argv=None) -> int:
    opts = parse_args(argv)
    if opts["role"] == "worker":
        return worker(opts)
    if opts["device"] == "cuda" and not torch.cuda.is_available():
        print("scaling_bench: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    if opts["n_tile"] is None:
        opts["n_tile"] = 1
    try:
        launch(opts)
    except RuntimeError as e:
        print(f"scaling_bench: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
