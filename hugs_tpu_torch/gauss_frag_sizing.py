"""The fragment-packet sizing of the Gaussian-sharded renderer (the
counterpart of scripts/gauss_frag_sizing.py): over orbiting cameras on a
NeuMan-lab-shaped scene, the largest per-(sender, band) packet that
parallel/gauss_shard.py's all_to_all moves, and the `frag_cap` it
recommends against the default (the local budget).

The scene is the script's, bit for bit from RandomState(0): N = 65,536
points, half on a sphere of radius 6, a quarter on the floor (y = -1.2),
a quarter in a human-shaped blob at the centre, shuffled; isotropic
scales from the mean squared distance to the 3 nearest others
(ops/knn.py), identity rotations, opacity 0.8, SH from the same stream.
Each of 6 orbit cameras (get_rotating_camera at 480x272, fov 0.95,
distance 3) is rendered by render_gauss_sharded on a ('gauss',) mesh of
D ranks with a roomy local budget (16 N / D) and frag_cap left at it:
the sizing needs the true demand, not a clipped one. Its frag_counts
(D, D) (row: sender, column: band) give the packet maximum, the band
maximum, the mean and the skew; frag_cap = next_pow2(1.5 max). An
overflow raises: no result is taken from a clipped render. The blend
runs on each band (K1 on the card, its plain version on the CPU).

  python -m hugs_tpu_torch.gauss_frag_sizing [--device cpu] [--ranks D]
      [--out DIR]

D defaults to the cards (NCCL ranks, one card each, through
parallel/launch.py::run_ranks), or 1 with no group; `--device cpu
--ranks 8` runs 8 gloo ranks, the script's 8-device mesh. One JSON line
is printed and written to DIR/gauss_frag_sizing.json (default
runs/gauss_frag_sizing). The script's tile_cap is not ported: K1 takes
16x16 tiles and truncates nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.micro import card
from hugs_tpu_torch.ops.knn import mean_sq_dist_to_knn
from hugs_tpu_torch.parallel.gauss_shard import render_gauss_sharded
from hugs_tpu_torch.parallel.launch import run_ranks
from hugs_tpu_torch.parallel.mesh import make_gauss_mesh
from hugs_tpu_torch.render import cuda_blend

N = 1 << 16                 # 65,536 Gaussians
W, H = 480, 272
N_CAMS = 6
FOV, DIST = 0.95, 3.0
BUDGET_PER_ROW = 16         # local budget 16 N / D
FRAG_BYTES = 10 * 4 + 3 * 4   # a fragment row: 10 f32 features, 3 int32 keys
TIMEOUT = 1800.0            # seconds for the ranks of one run
SIZING_RULE = ("frag_cap = next_pow2(measured_per_pair_max * 1.5) from a "
               "rehearsal pass (same probe machinery as the instance "
               "budget, trainer.rehearse_budget); overflow is reported, "
               "never silent")


def scene_points(n: int = N) -> tuple[np.ndarray, np.random.RandomState]:
    """The script's points (gauss_frag_sizing.py:44-54), float32 (n, 3),
    and its generator after the shuffle (the SH come next from it)."""
    rng = np.random.RandomState(0)
    u = rng.normal(size=(n // 2, 3))
    sph = 6.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    floor = np.stack([rng.uniform(-3, 3, n // 4),
                      np.full(n // 4, -1.2),
                      rng.uniform(-3, 3, n // 4)], axis=1)
    human = rng.normal(size=(n // 4, 3)) * [0.25, 0.8, 0.2]
    pts = np.concatenate([sph, floor, human]).astype(np.float32)[:n]
    rng.shuffle(pts)
    return pts, rng


def sizing_scene(n: int = N, device="cpu") -> dict:
    """The script's Gaussians as numpy: means, scales (kNN on `device`),
    rotq, opacity and shs (n, 16, 3)."""
    pts, rng = scene_points(n)
    d2 = mean_sq_dist_to_knn(torch.as_tensor(pts, device=device), k=3)
    s = torch.sqrt(torch.clamp(d2, min=1e-8)).cpu().numpy()
    return {"means": pts,
            "scales": np.repeat(s[:, None], 3, axis=1),
            "rotq": np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32),
                            (n, 1)),
            "opacity": np.full(n, 0.8, np.float32),
            "shs": rng.rand(n, 16, 3).astype(np.float32) * 0.2}


def camera_frames(width: int = W, height: int = H, n_cams: int = N_CAMS,
                  device="cpu") -> list:
    """The script's orbit: n_cams frame dicts at distance DIST, fov FOV."""
    return get_rotating_camera(img_size=(height, width), fov=FOV, dist=DIST,
                               nframes=n_cams, device=device)


def rank_counts(rank: int, world: int, scene: dict, width: int, height: int,
                n_cams: int, device_type: str = "cpu") -> dict:
    """This rank's part of the sizing on a ('gauss',) mesh of `world`
    ranks (the group joined, or none for one rank): each camera's
    frag_counts (D, D), the same on every rank, and K1's launches here."""
    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    mesh = make_gauss_mesh(world)
    t = {k: torch.tensor(v, device=dev) for k, v in scene.items()}
    n = t["means"].shape[0]
    budget = BUDGET_PER_ROW * (n // world)
    cuda_blend.LAUNCHES = 0
    mats = []
    for c in camera_frames(width, height, n_cams, dev):
        out = render_gauss_sharded(
            t["means"], t["scales"], t["rotq"], t["opacity"], t["shs"],
            c["camera"], width, height, mesh, active_sh_degree=3,
            local_budget=budget)
        if bool(out["overflowed"]):
            raise RuntimeError(f"camera {len(mats)} overflowed the local "
                               f"budget {budget} or a packet")
        mats.append(out["frag_counts"].cpu().numpy().astype(int).tolist())
    return {"frag_counts_per_camera": mats, "k1_launches": cuda_blend.LAUNCHES,
            "local_budget": budget}


def next_pow2(x: int) -> int:
    """The script's int(2 ** ceil(log2(max(x, 1))))."""
    return int(2 ** np.ceil(np.log2(max(x, 1))))


def summarize(mats: list, n: int, ranks: int, width: int = W,
              height: int = H) -> dict:
    """The script's record (:84-104) of the cameras' frag_counts."""
    per_pair_max = max(int(np.max(m)) for m in mats)
    per_band_max = max(int(np.asarray(m).sum(axis=0).max()) for m in mats)
    mean_pair = float(np.mean([np.mean(m) for m in mats]))
    budget = BUDGET_PER_ROW * (n // ranks)
    cap = next_pow2(per_pair_max * 3 // 2)
    return {
        "workload": f"{n} gaussians ({ranks}-chip shard, {n // ranks}/chip), "
                    f"{width}x{height}, {len(mats)} orbit cameras, "
                    f"NeuMan-lab shape (bg sphere + floor + human blob), "
                    f"shuffled rows",
        "local_budget_default": budget,
        "frag_cap_default": budget,
        "measured_per_pair_max": per_pair_max,
        "measured_per_band_max": per_band_max,
        "mean_per_pair": mean_pair,
        "skew_max_over_mean": per_pair_max / max(mean_pair, 1),
        "sizing_rule": SIZING_RULE,
        "frag_cap_recommended": cap,
        "bytes_per_pair_default": budget * FRAG_BYTES,
        "bytes_per_pair_recommended": cap * FRAG_BYTES,
        "frag_counts_per_camera": mats,
    }


def measure(device_type: str = "cuda", ranks: int = 1, n: int = N,
            width: int = W, height: int = H, n_cams: int = N_CAMS,
            scene: dict | None = None, timeout: float = TIMEOUT) -> dict:
    """The sizing on `ranks` ranks of `device_type` (one rank in this
    process; more through run_ranks, NCCL or gloo): the script's record,
    K1's launches on each rank, the ranks and the device. `scene`
    defaults to sizing_scene(n), its kNN on the first device; a scene
    given sets n."""
    if scene is None:
        scene = sizing_scene(n, "cuda" if device_type == "cuda" else "cpu")
    n = scene["means"].shape[0]
    if n % ranks:
        raise ValueError(f"N={n} must be divisible by the {ranks} ranks")
    args = (scene, width, height, n_cams, device_type)
    if ranks == 1:
        per_rank = [rank_counts(0, 1, *args)]
    else:
        per_rank = run_ranks(rank_counts, ranks, args,
                             backend="nccl" if device_type == "cuda"
                             else "gloo", timeout=timeout)
    mats = per_rank[0]["frag_counts_per_camera"]
    if any(r["frag_counts_per_camera"] != mats for r in per_rank):
        raise RuntimeError("the ranks gathered different frag_counts")
    rec = summarize(mats, n, ranks, width, height)
    rec.update(ranks=ranks, device=device_type,
               k1_launches=[r["k1_launches"] for r in per_rank])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="D, the ranks of the ('gauss',) mesh (default: "
                         "the cards; 1 on the CPU)")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "gauss_frag_sizing"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gauss_frag_sizing: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 1)
    if args.device == "cuda" and ranks > torch.cuda.device_count():
        print(f"gauss_frag_sizing: {ranks} ranks need as many cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    rec = measure(args.device, ranks)
    if args.device == "cuda":
        rec["card"] = card()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "gauss_frag_sizing.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
