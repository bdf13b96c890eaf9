"""K2 and K1 built from this checkout and from another, timed in one
process.

Compares K2 (csrc/blend_bwd.cu) and K1 (csrc/blend_fwd.cu, its exact
mode) of two source trees on one card, where times taken in separate
processes differ by a few % with the code unchanged, and the two kernels
of the POWER_MXU mode (blend_fwd_mxu_kernel, blend_bwd_mxu_kernel). Each
tree's source is built with this checkout's nvcc flags; both libraries
are loaded into this process, and each kernel is launched through each
in turn on the same frame for ROUNDS rounds, each timing each build as
the median of 20 spans of 20 back-to-back launches, the build that goes
first alternating. The exact kernels run on micro_bwd.frame (bench.py's
scene, g = ones), the mode's on that frame ("serving") and on
micro_bwd.training_frame (chip_smoke.py's training frame), K2 in the
mode on this checkout's K1 mode's log T and walk. Prints one JSON
object: for K2 at the top level, for K1 under "k1" and for the mode's
kernels under "mxu" (frame, then "K1" / "K2"), per build, the kernel's
ptxas report, its resident blocks per SM, its SASS instruction count and
most frequent opcodes, and its round times and their median; whether
the two SASS listings are the same opcodes in the same order; and the
largest difference between the builds' outputs (grad_feat; K1's image).

S2 and S1 ("s2", "s1"): each mode of csrc/vpu_peak.cu and
csrc/micro_bf16.cu from both trees, launched through the same C function
at the scripts' full sizes (S2 one call, grid 512; S1 one call, r 32768,
from a linspace that moves bfloat16 madd) in turns for ROUNDS rounds
(the median of 20 spans of MICRO_INNER launches each): per build the
kernel's ptxas report, SASS instruction count and most frequent opcodes,
the round times; whether the SASS is the same opcodes in the same order;
the largest difference between the builds' outputs and whether they are
equal bit for bit. The other tree's S2 `serial` kernel is
OTHER_S2_SERIAL, the one-element-a-thread template of the sources
before the several-chain design. Then the issue rate of this tree's S2
serial and S1 madd in both types on RATE_BLOCKS blocks, where
independent chains are plenty: warp instructions a scheduler issues a
clock.

Run on the card: `python -m hugs_tpu_torch.micro.k2_ab --other DIR
[--kernels k2 k1 mxu s2 s1] [--out F]`, DIR the root of the other
checkout (for example the parent commit, unpacked with `git archive`);
--kernels picks the parts (all by default).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import statistics
import subprocess
from pathlib import Path

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.micro import (
    card, device_ms, emit, loop_opcodes, loop_passes, pipe_counts,
    sass_listing, sass_opcodes, sm_clock_mhz,
)
from hugs_tpu_torch.micro import micro_bf16, vpu_peak
from hugs_tpu_torch.micro.micro_bwd import frame, training_frame
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.tiles import TILE, tile_grid

ROUNDS = 8
KERNEL = "blend_bwd_kernel"
K1_KERNEL = "blend_fwd_kernel"
MXU_KERNELS = {"K1": "blend_fwd_mxu_kernel", "K2": "blend_bwd_mxu_kernel"}
PARTS = ("k2", "k1", "mxu", "s2", "s1")
MICRO_INNER = 5   # launches per timed span of S2 and S1
RATE_BLOCKS = 4   # blocks of (1024, 128) the issue-rate probe runs on
# S2 serial's kernel in sources before the several-chain design
OTHER_S2_SERIAL = f"vpu_peak_kernelILi1ELi{vpu_peak.INNER}E"


@functools.lru_cache(maxsize=None)
def build_other(root: Path, source: str = cuda_blend.BWD_SOURCE
                ) -> tuple[Path, str]:
    """csrc/<source>.cu of the checkout at `root`, built with this
    checkout's flags into the build directory (once per process):
    (library, nvcc's output)."""
    src = root / "hugs_tpu_torch" / "csrc" / f"{source}.cu"
    out = build.BUILD_DIR / "k2_ab" / f"{source}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    return out, res.stdout + res.stderr


def launcher(lib: ctypes.CDLL, fr: dict, mxu: bool = False):
    """K2 through `lib` on frame `fr`, as cuda_blend.blend_bwd launches
    it (in the POWER_MXU mode with mxu, on fr's "mxu_log_t" and
    "mxu_n_walked"): a function returning (grad_feat, grad_bg)."""
    fn = lib.hugs_blend_bwd_mxu if mxu else lib.hugs_blend_bwd
    fn.argtypes, fn.restype = cuda_blend._BWD_ARGS, ctypes.c_int
    log_t = fr["mxu_log_t" if mxu else "log_t"]
    n_walked = fr["mxu_n_walked" if mxu else "n_walked"]
    b, w, h = fr["bins"], fr["width"], fr["height"]
    nx, ny = tile_grid(w, h, TILE)
    dev = fr["feat"].device

    def run():
        grad_feat = torch.zeros_like(fr["feat"])
        grad_bg = torch.zeros((3,), dtype=torch.float32, device=dev)
        err = fn(fr["feat"].data_ptr(), b.gauss_id.data_ptr(),
                 b.starts.data_ptr(), fr["bg"].data_ptr(),
                 log_t.data_ptr(), n_walked.data_ptr(),
                 fr["grad"].data_ptr(), w, h, nx, nx * ny,
                 grad_feat.data_ptr(), grad_bg.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: cudaError {err}")
        return grad_feat, grad_bg
    return run


def k1_launcher(lib: ctypes.CDLL, fr: dict, mxu: bool = False):
    """K1 through `lib` on frame `fr`, as cuda_blend.blend_fwd launches
    it (in the POWER_MXU mode with mxu): a function returning its raw
    image."""
    fn = lib.hugs_blend_fwd_mxu if mxu else lib.hugs_blend_fwd
    fn.argtypes, fn.restype = cuda_blend._FWD_ARGS, ctypes.c_int
    b, w, h = fr["bins"], fr["width"], fr["height"]
    nx, ny = tile_grid(w, h, TILE)
    dev = fr["feat"].device

    def run():
        img = torch.empty((3, h, w), dtype=torch.float32, device=dev)
        log_t = torch.empty((h, w), dtype=torch.float32, device=dev)
        n_walked = torch.empty((h, w), dtype=torch.int32, device=dev)
        walked = torch.empty((nx * ny,), dtype=torch.int32, device=dev)
        err = fn(fr["feat"].data_ptr(), b.gauss_id.data_ptr(),
                 b.starts.data_ptr(), b.ends.data_ptr(), fr["bg"].data_ptr(),
                 w, h, nx, nx * ny, img.data_ptr(), log_t.data_ptr(),
                 n_walked.data_ptr(), walked.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")
        return (img,)
    return run


def blocks_per_sm(lib: ctypes.CDLL, kernel: str) -> int:
    """The resident blocks per SM of `kernel` (one of the four above) as
    `lib` launches it, from its occupancy query."""
    mxu = kernel in MXU_KERNELS.values()
    name = ("hugs_blend_fwd" if kernel.startswith("blend_fwd")
            else "hugs_blend_bwd") + ("_mxu" if mxu else "") + "_blocks_per_sm"
    fn = getattr(lib, name)
    if not mxu:
        fn.argtypes = []
        return int(fn())
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    dynamic = ctypes.c_int(-1)
    return int(fn(ctypes.byref(dynamic)))


def compare(other: Path, rounds: int = ROUNDS, source=cuda_blend.BWD_SOURCE,
            kernel=KERNEL, make_launcher=launcher, fr=None) -> dict:
    fr = frame("cuda") if fr is None else fr
    this_path = build.build([source])[source]
    other_path, other_log = build_other(other, source)
    builds = {
        "this": (this_path, build.build_logs[source]),
        "other": (other_path, other_log)}
    runs, out = {}, {}
    for name, (path, log) in builds.items():
        lib = ctypes.CDLL(str(path))
        runs[name] = make_launcher(lib, fr)
        ops = sass_opcodes(path, kernel)
        out[name] = {"library": str(path),
                     "ptxas": build.kernel_resources(log, kernel),
                     "blocks_per_sm": blocks_per_sm(lib, kernel),
                     "sass_instructions": len(ops), "sass_ops": ops,
                     "ms_rounds": []}
    for i in range(rounds):
        order = ("this", "other") if i % 2 == 0 else ("other", "this")
        for name in order:
            out[name]["ms_rounds"].append(
                device_ms(runs[name], reps=20, inner=20))
    got, want = runs["this"]()[0], runs["other"]()[0]
    torch.cuda.synchronize()
    same = out["this"]["sass_ops"] == out["other"]["sass_ops"]
    for entry in out.values():
        ops = entry.pop("sass_ops")
        entry["sass_top_opcodes"] = collections.Counter(ops).most_common(25)
        entry["ms_median"] = statistics.median(entry["ms_rounds"])
    return {"device": card(), "other": str(other),
            "frame": {"width": fr["width"], "height": fr["height"],
                      "gaussians": fr["feat"].shape[0],
                      "instances": int((fr["bins"].ends
                                        - fr["bins"].starts).sum())},
            "builds": out, "same_sass_opcodes": same,
            "max_abs_diff": float((got - want).abs().max()),
            "max_abs_grad": float(want.abs().max())}


def in_turns(runs: dict, rounds: int, inner: int) -> dict:
    """Each function of `runs` timed ROUNDS times (device_ms, 20 spans of
    `inner` launches), the first of each round moving one along:
    {name: [ms per round]}."""
    names, out = list(runs), {name: [] for name in runs}
    for i in range(rounds):
        k = i % len(names)
        for name in names[k:] + names[:k]:
            out[name].append(device_ms(runs[name], reps=20, inner=inner))
    return out


def s2_runner(lib: ctypes.CDLL, mode: str, x: torch.Tensor):
    """One S2 call of `mode` through lib's hugs_vpu_peak on x (GRID,
    INNER), as vpu_peak.vpu_call launches it: a function returning the
    output."""
    fn = lib.hugs_vpu_peak
    fn.argtypes, fn.restype = vpu_peak._ARGS, ctypes.c_int
    consts = vpu_peak.CONSTS.to(x.device)

    def run():
        out = torch.empty_like(x)
        err = fn(vpu_peak.MODES.index(mode), vpu_peak.INNER, x.data_ptr(),
                 out.data_ptr(), consts.data_ptr(), x.numel(), vpu_peak.GRID,
                 vpu_peak.CARRY, vpu_peak.OUT_SCALE,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"S2 launch failed: cudaError {err}")
        return out
    return run


def s1_runner(lib: ctypes.CDLL, op: str, x: torch.Tensor, c: torch.Tensor):
    """One S1 call (r the largest of RS) through lib's hugs_micro_bf16 on
    x, as micro_bf16.passes launches it: a function returning the
    output."""
    fn = lib.hugs_micro_bf16
    fn.argtypes, fn.restype = micro_bf16._ARGS, ctypes.c_int

    def run():
        out = torch.empty_like(x)
        err = fn(micro_bf16.OPS.index(op), int(x.dtype == torch.bfloat16),
                 x.data_ptr(), out.data_ptr(), c.data_ptr(), micro_bf16.E,
                 x.numel(), micro_bf16.RS[-1],
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"S1 launch failed: cudaError {err}")
        return out
    return run


def _micro_ab(builds: dict, make_run, kernels: dict, rounds: int) -> dict:
    """One mode of S2 or S1 from the builds {name: (library path, nvcc's
    output)}, its kernel in each build's SASS `kernels[name]`, timed in
    turns: per build its ptxas report, SASS count and top opcodes, round
    times and median; the same SASS opcodes or not; the outputs' largest
    difference and bit-for-bit equality."""
    runs = {name: make_run(ctypes.CDLL(str(path)))
            for name, (path, _) in builds.items()}
    times = in_turns(runs, rounds, MICRO_INNER)
    out, ops = {}, {}
    for name, (path, log) in builds.items():
        kernel = kernels[name]
        ops[name] = sass_opcodes(path, kernel)
        out[name] = {"kernel": kernel,
                     "ptxas": build.kernel_resources(log, kernel),
                     "sass_instructions": len(ops[name]),
                     "sass_top_opcodes":
                         collections.Counter(ops[name]).most_common(12),
                     "ms_rounds": times[name],
                     "ms_median": statistics.median(times[name])}
    got, want = runs["this"](), runs["other"]()
    torch.cuda.synchronize()
    return {"builds": out, "same_sass_opcodes": ops["this"] == ops["other"],
            "max_abs_diff": float((got.float() - want.float()).abs().max()),
            "bitwise_equal": bool(torch.equal(_bits(got), _bits(want)))}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its width (float32 or bfloat16)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def issue_rate(run, lib: Path, kernel: str, marks: tuple,
               element_passes: int, sms: int, index: int) -> dict:
    """The warp instructions a scheduler issues a clock while `run` (a
    launch of `kernel` of library `lib` on RATE_BLOCKS blocks, so that
    independent chains are plenty) runs back to back: its loop's issued
    instructions per element pass (loop_passes over `marks`) times
    `element_passes`, over 32 lanes, the time, the SM clock read
    meanwhile and 4 schedulers an SM."""
    loop = loop_opcodes(sass_listing(lib, kernel))
    issue = pipe_counts(loop)["issue"] / loop_passes(loop, *marks)
    ms = device_ms(run, reps=20, inner=MICRO_INNER)
    clock = sm_clock_mhz(run, index=index)
    return {"element_passes": element_passes, "issue_per_pass": issue,
            "ms": ms, "sm_clock_mhz": clock,
            "per_clock_per_scheduler": element_passes * issue / 32
            / (ms * clock * 1e3 * 4 * sms)}


def compare_micro(other: Path, part: str, rounds: int = ROUNDS) -> dict:
    """S2 ("s2") or S1 ("s1") against the checkout at `other`: each mode
    A/B, then the issue rates."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    index = dev.index or 0
    out = {"device": card(), "other": str(other)}
    if part == "s2":
        src = vpu_peak.SOURCE
        builds = {"this": (build.build([src])[src], build.build_logs[src]),
                  "other": build_other(other, src)}
        x = vpu_peak.start_block(dev)
        for mode in vpu_peak.MODES:
            name = vpu_peak.kernel_name(mode)
            out[mode] = _micro_ab(
                builds, lambda lib, m=mode: s2_runner(lib, m, x),
                {"this": name, "other": OTHER_S2_SERIAL
                 if mode == "serial" else name}, rounds)
        xr = torch.linspace(0.0, 1.0, RATE_BLOCKS * x.numel(), device=dev)
        out["issue_rate"] = {"serial": issue_rate(
            lambda: vpu_peak.vpu_call(xr, "serial"), builds["this"][0],
            vpu_peak.kernel_name("serial"),
            (("FFMA",), 4 * vpu_peak.INNER), xr.numel() * vpu_peak.GRID,
            sms, index)}
        return out
    src = micro_bf16.SOURCE
    builds = {"this": (build.build([src])[src], build.build_logs[src]),
              "other": build_other(other, src)}
    c = torch.tensor([[micro_bf16.C_VALUE]], dtype=torch.float32, device=dev)
    start = torch.linspace(-2.0, 3.0, micro_bf16.P * micro_bf16.C,
                           device=dev).reshape(micro_bf16.P, micro_bf16.C)
    for op in micro_bf16.OPS:
        for name, dtype in micro_bf16.DTYPES.items():
            xs = start.to(dtype)
            kernel = micro_bf16.kernel_name(op, name)
            out[f"{op}_{name}"] = _micro_ab(
                builds, lambda lib, o=op, a=xs: s1_runner(lib, o, a, c),
                {"this": kernel, "other": kernel}, rounds)
    out["issue_rate"] = {}
    r = micro_bf16.RS[-1]
    for name, marks in (("float32", (("FFMA",), 1)),
                        ("bfloat16", (("HMUL2", "HADD2"), 2))):
        xr = torch.linspace(-2.0, 3.0, RATE_BLOCKS * start.numel(),
                            device=dev).to(micro_bf16.DTYPES[name])
        out["issue_rate"][f"madd_{name}"] = issue_rate(
            lambda a=xr: micro_bf16.passes(c, a, "madd", r),
            builds["this"][0], micro_bf16.kernel_name("madd", name), marks,
            xr.numel() // (2 if name == "bfloat16" else 1) * r, sms, index)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout")
    ap.add_argument("--kernels", nargs="+", choices=PARTS, default=PARTS,
                    help="the parts to compare (all by default)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    other, parts = Path(args.other), set(args.kernels)
    out = {part: compare_micro(other, part) for part in ("s2", "s1")
           if part in parts}
    fr = frame("cuda") if parts & {"k2", "k1", "mxu"} else None
    if "k2" in parts:
        out.update(compare(other, fr=fr))
    if "k1" in parts:
        out["k1"] = compare(other, source=cuda_blend.SOURCE,
                            kernel=K1_KERNEL, make_launcher=k1_launcher,
                            fr=fr)
    if "mxu" in parts:
        out["mxu"] = {}
        for name, f in (("serving", fr),
                        ("training", training_frame("cuda"))):
            _, f["mxu_log_t"], f["mxu_n_walked"], _ = cuda_blend.blend_fwd(
                f["feat"], f["bins"].gauss_id, f["bins"].starts,
                f["bins"].ends, f["bg"], f["width"], f["height"],
                power_mxu=True)
            out["mxu"][name] = {
                "K1": compare(other, source=cuda_blend.SOURCE,
                              kernel=MXU_KERNELS["K1"], fr=f,
                              make_launcher=lambda lib, x: k1_launcher(
                                  lib, x, True)),
                "K2": compare(other, kernel=MXU_KERNELS["K2"], fr=f,
                              make_launcher=lambda lib, x: launcher(
                                  lib, x, True))}
    emit(out, args.out)


if __name__ == "__main__":
    main()
