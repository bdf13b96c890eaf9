"""Brute-force k-nearest-neighbour search, plain PyTorch.

Counterparts of simple-knn's distCUDA2 (scene initialisation,
`mean_sq_dist_to_knn`) and pytorch3d's knn_points (`knn`). Distances are
computed elementwise in the exact (a-b)^2 form, never through the
|a|^2 + |b|^2 - 2ab expansion of a matmul (torch.cdist's fast path),
which loses the near pairs' precision on clouds away from the origin.
Queries go in chunks to bound the (chunk, N) distance matrix.
"""
from __future__ import annotations

import torch

from hugs_tpu_torch.utils import profiling


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs for each query point.

    Returns (sq_dists (M, k), indices (M, k)), ascending by distance;
    among equal distances the lower index comes first. Counts its chunks
    in the open step's `knn_chunks` (utils/profiling.py).
    """
    profiling.count("knn_chunks", -(-query.shape[0] // chunk))
    # centre on the reference cloud, as the JAX package does
    mu = torch.mean(ref, dim=0, keepdim=True)
    query = query - mu
    ref = ref - mu
    rx, ry, rz = ref[:, 0], ref[:, 1], ref[:, 2]
    dists, idxs = [], []
    for q in torch.split(query, chunk):
        dx = rx[None, :] - q[:, 0:1]
        dy = ry[None, :] - q[:, 1:2]
        dz = rz[None, :] - q[:, 2:3]
        d = dx * dx + dy * dy + dz * dz                   # (C, N)
        ds, ids = [], []
        for _ in range(k):
            i = torch.argmin(d, dim=1, keepdim=True)      # first minimum
            ds.append(torch.gather(d, 1, i))
            ids.append(i)
            d.scatter_(1, i, torch.inf)
        dists.append(torch.cat(ds, dim=1))
        idxs.append(torch.cat(ids, dim=1))
    return torch.cat(dists), torch.cat(idxs)


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3,
                        chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest OTHER points
    (distCUDA2: scales = log(sqrt(clamp(distCUDA2(pts))))). Takes k+1
    neighbours and drops the nearest, the point itself."""
    d, _ = knn(points, points, k + 1, chunk=chunk)
    return torch.mean(d[:, 1:], dim=-1)
