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

Run on the card: `python -m hugs_tpu_torch.micro.k2_ab --other DIR
[--out F]`, DIR the root of the other checkout (for example the parent
commit, unpacked with `git archive`).
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
from hugs_tpu_torch.micro import card, device_ms, emit, sass_opcodes
from hugs_tpu_torch.micro.micro_bwd import frame, training_frame
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.tiles import TILE, tile_grid

ROUNDS = 8
KERNEL = "blend_bwd_kernel"
K1_KERNEL = "blend_fwd_kernel"
MXU_KERNELS = {"K1": "blend_fwd_mxu_kernel", "K2": "blend_bwd_mxu_kernel"}


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K2 runs on the card only")
    other = Path(args.other)
    fr = frame("cuda")
    out = compare(other, fr=fr)
    out["k1"] = compare(other, source=cuda_blend.SOURCE, kernel=K1_KERNEL,
                        make_launcher=k1_launcher, fr=fr)
    out["mxu"] = {}
    for name, f in (("serving", fr), ("training", training_frame("cuda"))):
        _, f["mxu_log_t"], f["mxu_n_walked"], _ = cuda_blend.blend_fwd(
            f["feat"], f["bins"].gauss_id, f["bins"].starts, f["bins"].ends,
            f["bg"], f["width"], f["height"], power_mxu=True)
        out["mxu"][name] = {
            "K1": compare(other, source=cuda_blend.SOURCE,
                          kernel=MXU_KERNELS["K1"], fr=f,
                          make_launcher=lambda lib, x: k1_launcher(lib, x,
                                                                   True)),
            "K2": compare(other, kernel=MXU_KERNELS["K2"], fr=f,
                          make_launcher=lambda lib, x: launcher(lib, x,
                                                                True))}
    emit(out, args.out)


if __name__ == "__main__":
    main()
