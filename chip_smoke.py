#!/usr/bin/env python3
"""Drives the hugs_tpu_torch serving render on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It builds the CUDA kernels from the sources in the checkout, then:

  1. setup: TF32 off, the card's name and power limit, the build time;
  2. K1 against its plain PyTorch version at full width (50k Gaussians,
     SH degree 3, 960x540), on the same bins, plus the whole tiled render
     against the dense oracle on two small scenes, one saturated so that
     K1's early exit fires;
  3. the serving path through the user's entry points: a PLY of that
     scene -> create_from_ply -> compact -> scene_forward ->
     render_human_scene(render_mode="scene") for 4 camera views, with
     the kernel launch counts set to 0 just before and read just after;
  4. times on the card (CUDA events, median of 20 after warm-up): K1's
     device time over back-to-back launches and one call's latency, the
     plain blend, and one request split into project / bin / blend;
     K1's bound, the least time the card could take for its work; and
     the device's idle share in a request, from one torch.profiler
     trace of 5 requests;
  5. one JSON line of the kernels; 6. the device line, last.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the repository beside it, it exits non-zero and
prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 960, 540
N_GAUSS = 50_000
SEED = 0
BG = (0.2, 0.3, 0.4)
REPS = 20
PROFILED = 5   # requests in the profiler's window
BACK_TO_BACK = 20   # K1 launches per timed span
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float operations K1 spends per (pixel, instance) pair it tests, and the
# extra ones per pair it blends, counted from csrc/blend_fwd.cu
OPS_TESTED = 22
OPS_BLENDED = 12
# K1 holds to its plain version: the two sum log1p(-alpha) in another
# order, so a pixel at the T_EPS threshold may flip, which moves it by at
# most 0.99 * 1e-4 times its colour
PIXEL_ATOL = 2e-5
MIN_SHARE = 0.9999
MAX_ABS = 1e-3


def build_scene(n, seed):
    """bench.py's workload, drawn with numpy: raw (pre-activation)
    parameters."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 1.5 + 5.0
    log_scales = (rng.normal(size=(n, 3)) * 0.3 - 4.0).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    opacity_logit = rng.normal(size=(n, 1)).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return dict(xyz=means, scaling=log_scales, rotation=rotq,
                opacity=opacity_logit, shs=shs)


def saturating_scene(w, h, fovx, fovy, seed):
    """Two depth layers of near-opaque splats on a grid over the whole
    w x h image of a camera at the origin: every pixel saturates."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0.0, w - 1.0, 24),
                         np.linspace(0.0, h - 1.0, 16))
    px, py = np.tile(gx.ravel(), 2), np.tile(gy.ravel(), 2)
    n = px.shape[0]
    z = np.concatenate([4.0 + rng.uniform(size=n // 2) * 0.2,
                        6.0 + rng.uniform(size=n // 2) * 0.2])
    mx = z * math.tan(fovx / 2) * ((2.0 * px + 1.0) / w - 1.0)
    my = z * math.tan(fovy / 2) * ((2.0 * py + 1.0) / h - 1.0)
    f32 = np.float32
    return dict(xyz=np.stack([mx, my, z], axis=-1).astype(f32),
                scales=np.full((n, 3), 0.4, f32),
                rotq=np.tile(np.array([1.0, 0, 0, 0], f32), (n, 1)),
                opacity=np.full((n,), 0.97, f32),
                shs=(rng.normal(size=(n, 16, 3)) * 0.3).astype(f32))


def view(i):
    """Camera i of the serving run: view 0 looks down +z from the origin,
    the others turn about y and step sideways."""
    a = 0.08 * i * (-1) ** i
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]], np.float32)
    t = np.array([0.1 * i, -0.05 * i, 0.0], np.float32)
    return R, t


def time_ms(fn, reps=REPS, warmup=3, inner=1):
    """Median over `reps` of the CUDA-event time of `inner` back-to-back
    calls of fn(), divided by `inner`, after warm-up. With inner > 1 the
    host queues launches ahead of the card, so a kernel's time excludes
    its wrapper's host cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_kernels(fn, reps=PROFILED):
    """From torch.profiler's CUDA trace of `reps` calls of fn: device time
    by kernel name (us per call), device kernels per call, and the span
    per call from the first kernel's start to the last one's end (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: tracing host ops would slow the host, which
    # sets the span
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, n, first, last = {}, 0, math.inf, -math.inf
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us() / reps
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            n += 1
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    return by_name, n / reps, (last - first) / reps if n else 0.0


def held(name, got, want, atol=PIXEL_ATOL):
    """Share of elements within atol and the max |difference|; raises
    unless the share reaches MIN_SHARE and the max stays under MAX_ABS."""
    d = (got - want).abs()
    share = float((d <= atol).float().mean())
    worst = float(d.max()) if d.numel() else 0.0
    print(f"# {name}: {share * 100:.4f}% within {atol}, max |d| {worst:.3e}")
    if share < MIN_SHARE or worst > MAX_ABS:
        raise AssertionError(f"{name} disagrees: {share:.6f} within {atol},"
                             f" max {worst:.3e}")
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hugs_tpu_torch import build
    from hugs_tpu_torch.models.scene_gs import (
        compact, create_from_ply, scene_forward,
    )
    from hugs_tpu_torch.render import cuda_blend, make_camera
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.oracle import LOG_TEPS
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.renderer import render, render_human_scene
    from hugs_tpu_torch.render.tiles import TILE, bin_gaussians, tile_grid
    from hugs_tpu_torch.utils.ply import save_gaussian_ply

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. setup
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(smi)
    t0 = time.time()
    build.build([cuda_blend.SOURCE])
    build_s = time.time() - t0
    print(f"# build: {build_s:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"# nvcc {name}: {line.strip()}")

    # ---- 2. K1 against plain at full width
    raw = build_scene(N_GAUSS, SEED)
    xyz = torch.as_tensor(raw["xyz"], device=dev)
    q = torch.as_tensor(raw["rotation"], device=dev)
    # the activations of scene_forward, so phase 3 sees the same values
    attrs = dict(
        xyz=xyz, scales=torch.exp(torch.as_tensor(raw["scaling"], device=dev)),
        rotq=q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                             min=1e-8),
        opacity=torch.sigmoid(torch.as_tensor(raw["opacity"], device=dev)[:, 0]),
        shs=torch.as_tensor(raw["shs"], device=dev))
    bg = torch.tensor(BG, device=dev)
    cams = [make_camera(*view(i), 0.9, 0.55, device=dev) for i in range(4)]

    def project(cam, a=attrs, alive=None):
        return project_gaussians(a["xyz"], a["scales"], a["rotq"],
                                 a["opacity"], a["shs"], cam, W, H, 3,
                                 alive=alive)

    # rehearsal: size the budget from every view's slot demand
    demand = max(int(bin_gaussians(project(c), W, H, 4 * N_GAUSS).n_slots)
                 for c in cams)
    budget = -(-(demand * 23 // 20) // 8192) * 8192
    pg = project(cams[0])
    bins = bin_gaussians(pg, W, H, budget)
    if bool(bins.overflowed):
        raise AssertionError(f"budget {budget} overflowed")
    feat = gauss_features(pg)
    img_k, logt_k, walked = cuda_blend.blend_fwd(
        feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H)
    img_p, logt_p, pairs = plain_blend(feat, bins.gauss_id, bins.starts,
                                       bins.ends, bg, W, H)
    torch.cuda.synchronize()
    nx, ny = tile_grid(W, H, TILE)
    counts = bins.ends - bins.starts
    print(f"# scene: {N_GAUSS} Gaussians, {int(pg.mask.sum())} visible; "
          f"{nx * ny} tiles; {int(counts.sum())} instances "
          f"(demand {int(bins.n_instances)} before culling, max "
          f"{int(counts.max())} per tile); budget {budget} slots; "
          f"K1 walked {int(walked.sum())}")
    max_err = held("K1 image vs plain", img_k, img_p)
    live = logt_p >= LOG_TEPS
    held("K1 log T vs plain (unsaturated pixels)", logt_k[live],
         logt_p[live])
    print(f"# unsaturated pixels: {int(live.sum())} of {W * H}")
    if not bool(torch.isfinite(img_k).all()):
        raise AssertionError("K1 image is not finite")

    # the whole tiled render against the dense oracle on small scenes: a
    # slice of this one, and one in which every pixel saturates, so K1's
    # early exit decides the walk
    small_cam = make_camera(np.eye(3), [0.0, 0.0, -2.0], 0.9, 0.7,
                            device=dev)
    sat = {k: torch.as_tensor(v, device=dev)
           for k, v in saturating_scene(64, 48, 0.9, 0.7, SEED).items()}
    for name, a, cam in (
            ("slice", {k: v[:300] for k, v in attrs.items()}, small_cam),
            ("saturated", sat, make_camera(np.eye(3), 0.0, 0.9, 0.7,
                                           device=dev))):
        args = (a["xyz"], a["scales"], a["rotq"], a["opacity"], a["shs"],
                cam, 64, 48)
        tiled = render(*args, bg=bg, active_sh_degree=3)["render"]
        oracle = render(*args, bg=bg, active_sh_degree=3,
                        backend="oracle")["render"]
        held(f"render(tiled) vs render(oracle), 64x48 {name}", tiled, oracle)
    pgs = project_gaussians(*args[:6], 64, 48, 3)
    bs = bin_gaussians(pgs, 64, 48, 1 << 16)
    _, logt_s, walked_s = cuda_blend.blend_fwd(
        gauss_features(pgs), bs.gauss_id, bs.starts, bs.ends, bg, 64, 48)
    listed = int((bs.ends - bs.starts).sum())
    print(f"# saturated scene: K1 walked {int(walked_s.sum())} of {listed} "
          f"instances")
    if not (bool((logt_s < LOG_TEPS).all()) and int(walked_s.sum()) < listed):
        raise AssertionError("K1's early exit did not fire")

    # ---- 3. serving path through the user's entry points
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.ply")
        save_gaussian_ply(path, raw["xyz"], raw["shs"][:, :1],
                          raw["shs"][:, 1:], raw["opacity"], raw["scaling"],
                          raw["rotation"])
        cuda_blend.LAUNCHES = 0
        t0 = time.time()
        gs = compact(create_from_ply(path, device=dev))
        with torch.no_grad():
            out = scene_forward(gs)
            images = []
            for cam in cams:
                pkg = render_human_scene(
                    {"camera": cam, "width": W, "height": H}, None, out, bg,
                    render_mode="scene", instance_budget=budget)
                if bool(pkg["overflowed"]):
                    raise AssertionError("a request overflowed its budget")
                images.append(pkg["render"])
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        launches = cuda_blend.LAUNCHES
    print(f"# serving: {len(cams)} requests in {serve_s:.3f} s (load "
          f"included), K1 launches {launches}, capacity {gs.capacity}")
    if launches != len(cams):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{len(cams)} requests")
    for i, img in enumerate(images):
        if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()) \
                or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise AssertionError(f"request {i}: bad image")
    d0 = float((images[0] - img_k).abs().max())
    print(f"# request 0 vs phase-2 K1 image: max |d| {d0:.3e}")
    if d0 > 1e-6:
        raise AssertionError("request 0 differs from the phase-2 image")

    # ---- 4. times on the card
    def k1():
        cuda_blend.blend_fwd(feat, bins.gauss_id, bins.starts, bins.ends, bg,
                             W, H)

    # K1's device time from back-to-back launches; one call alone adds
    # the wrapper's host cost, kept apart as its latency
    k1_ms = time_ms(k1, inner=BACK_TO_BACK)
    k1_call_ms = time_ms(k1)
    plain_ms = time_ms(lambda: plain_blend(
        feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H))

    # one request by stage: scene_forward + projection, binning, K1
    stages = {"project": [], "bin": [], "blend": [], "request": []}
    with torch.no_grad():
        for rep in range(3 + REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            a = scene_forward(gs)
            pgr = project(cams[0], a, a["alive"])
            ev[1].record()
            b = bin_gaussians(pgr, W, H, budget)
            ev[2].record()
            cuda_blend.blend_tiles(pgr, b, W, H, bg)
            ev[3].record()
            ev[3].synchronize()
            if rep >= 3:
                stages["project"].append(ev[0].elapsed_time(ev[1]))
                stages["bin"].append(ev[1].elapsed_time(ev[2]))
                stages["blend"].append(ev[2].elapsed_time(ev[3]))
                stages["request"].append(ev[0].elapsed_time(ev[3]))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}

    # the device's busy share of a request: its kernels' time against the
    # span from the first kernel's start to the last one's end, both from
    # the same profiled window
    def request():
        a = scene_forward(gs)
        pgr = project(cams[0], a, a["alive"])
        cuda_blend.blend_tiles(pgr, bin_gaussians(pgr, W, H, budget), W, H,
                               bg)

    with torch.no_grad():
        by_kernel, kernels_per_request, span_us = device_kernels(request)
    busy_ms = sum(by_kernel.values()) / 1e3
    span_ms = span_us / 1e3
    k1_prof_ms = sum(us for name, us in by_kernel.items()
                     if "blend_fwd_kernel" in name) / 1e3

    tested, blended = (int(x) for x in pairs.sum(dim=(1, 2)))
    ops = OPS_TESTED * tested + OPS_BLENDED * blended
    n_inst = int(counts.sum())
    nbytes = (feat.numel() * 4 + n_inst * 4 + 2 * nx * ny * 4 + 3 * 4
              + 4 * W * H * 4 + nx * ny * 4)
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"# card: {card}")
    print(f"# K1 {k1_ms:.4f} ms ({BACK_TO_BACK} back-to-back launches; "
          f"one call with its wrapper {k1_call_ms:.4f} ms); plain blend "
          f"{plain_ms:.4f} ms; "
          f"request {stage_ms['request']:.4f} ms = project "
          f"{stage_ms['project']:.4f} + bin {stage_ms['bin']:.4f} + blend "
          f"{stage_ms['blend']:.4f} ms  [{smi}]")
    print(f"# K1 bound: {tested} pairs tested x {OPS_TESTED} + {blended} "
          f"blended x {OPS_BLENDED} = {ops:.4e} ops / 67 TFLOP/s = "
          f"{ops_ms:.5f} ms; {nbytes} bytes / 3.35 TB/s = {bytes_ms:.5f} ms;"
          f" bound {bound_ms:.5f} ms by {bound_by} "
          f"({bound_ms / k1_ms * 100:.1f}% of K1's time)  [{smi}]")
    if by_kernel:
        print(f"# profiler, {PROFILED} requests: {kernels_per_request:.1f} "
              f"device kernels per request, busy {busy_ms:.4f} ms of a "
              f"{span_ms:.4f} ms span (first kernel start to last kernel "
              f"end): device idle share "
              f"{(1 - busy_ms / span_ms) * 100:.1f}%; K1 {k1_prof_ms:.4f} ms"
              f"  [{smi}]")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        for name, us in top:
            print(f"#   {us:9.2f} us  {name[:90]}")
    else:
        print("# profiler: no device events; idle share not measured")

    # ---- 5. kernels line, 6. device line
    print(json.dumps({"kernels": [{
        "name": "K1 blend_fwd", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "hugs_tpu/render/pallas_blend.py:354",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "call_ms": k1_call_ms,
        "held_to": "blend_tiles_plain", "ok": True,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
