"""K2 and K1 built from this checkout and from another, timed in one
process.

Compares K2 (csrc/blend_bwd.cu) and K1 (csrc/blend_fwd.cu, its exact
mode) of two source trees on one card, where times taken in separate
processes differ by a few % with the code unchanged. Each tree's source
is built with this checkout's nvcc flags; both libraries are loaded into
this process, and the kernel is launched through each in turn on the
same frame (micro_bwd.frame: bench.py's scene, g = ones) for ROUNDS
rounds, each timing each build as the median of 20 spans of 20
back-to-back launches, the build that goes first alternating. Prints one
JSON object: for K2 at the top level and for K1 under "k1", per build,
the kernel's ptxas report, its SASS instruction count and most frequent
opcodes, and its round times and their median; whether the two SASS
listings are the same opcodes in the same order; and the largest
difference between the builds' outputs (grad_feat; K1's image).

Run on the card: `python -m hugs_tpu_torch.micro.k2_ab --other DIR
[--out F]`, DIR the root of the other checkout (for example the parent
commit, unpacked with `git archive`).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.micro import card, device_ms, emit, sass_opcodes
from hugs_tpu_torch.micro.micro_bwd import frame
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.tiles import TILE, tile_grid

ROUNDS = 8
KERNEL = "blend_bwd_kernel"
K1_KERNEL = "blend_fwd_kernel"


def build_other(root: Path, source: str = cuda_blend.BWD_SOURCE
                ) -> tuple[Path, str]:
    """csrc/<source>.cu of the checkout at `root`, built with this
    checkout's flags into the build directory: (library, nvcc's output)."""
    src = root / "hugs_tpu_torch" / "csrc" / f"{source}.cu"
    out = build.BUILD_DIR / "k2_ab" / f"{source}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    return out, res.stdout + res.stderr


def launcher(lib: ctypes.CDLL, fr: dict):
    """K2 through `lib` on frame `fr`, as cuda_blend.blend_bwd launches
    it: a function returning (grad_feat, grad_bg)."""
    fn = lib.hugs_blend_bwd
    fn.argtypes, fn.restype = cuda_blend._BWD_ARGS, ctypes.c_int
    b, w, h = fr["bins"], fr["width"], fr["height"]
    nx, ny = tile_grid(w, h, TILE)
    dev = fr["feat"].device

    def run():
        grad_feat = torch.zeros_like(fr["feat"])
        grad_bg = torch.zeros((3,), dtype=torch.float32, device=dev)
        err = fn(fr["feat"].data_ptr(), b.gauss_id.data_ptr(),
                 b.starts.data_ptr(), fr["bg"].data_ptr(),
                 fr["log_t"].data_ptr(), fr["n_walked"].data_ptr(),
                 fr["grad"].data_ptr(), w, h, nx, nx * ny,
                 grad_feat.data_ptr(), grad_bg.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: cudaError {err}")
        return grad_feat, grad_bg
    return run


def k1_launcher(lib: ctypes.CDLL, fr: dict):
    """K1 through `lib` on frame `fr`, as cuda_blend.blend_fwd launches
    it: a function returning its raw image."""
    fn = lib.hugs_blend_fwd
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
        runs[name] = make_launcher(ctypes.CDLL(str(path)), fr)
        ops = sass_opcodes(path, kernel)
        out[name] = {"library": str(path),
                     "ptxas": build.kernel_resources(log, kernel),
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
    fr = frame("cuda")
    out = compare(Path(args.other), fr=fr)
    out["k1"] = compare(Path(args.other), source=cuda_blend.SOURCE,
                        kernel=K1_KERNEL, make_launcher=k1_launcher, fr=fr)
    emit(out, args.out)


if __name__ == "__main__":
    main()
