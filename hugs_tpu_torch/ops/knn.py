"""Brute-force k-nearest-neighbour search.

Counterparts of simple-knn's distCUDA2 (scene initialisation,
`mean_sq_dist_to_knn`) and pytorch3d's knn_points (`knn`). Which path
runs is decided by where the queries lie: `knn` on CUDA tensors launches
K3, the hand-written kernel csrc/knn.cu (one launch a call, for k up to
MAX_K; anything else it raises on), and on CPU tensors runs `plain_knn`,
plain PyTorch, the kernel's reference, which it equals bit for bit on
finite points (distances and indices). There is no other path and no
fallback when a build or a launch fails.

Both centre the clouds on the reference cloud's mean, as the JAX package
does, and compute distances elementwise in the exact (a-b)^2 form,
((dx dx + dy dy) + dz dz) with each operation rounded on its own, never
through the |a|^2 + |b|^2 - 2ab expansion of a matmul (torch.cdist's fast
path), which loses the near pairs' precision on clouds away from the
origin. Results ascend by distance; among equal distances the lower
index comes first. `plain_knn` takes the queries in chunks to bound its
(chunk, N) distance matrix; the kernel holds each query's list in
registers and needs no chunks.

Both paths find the indices alone and take the neighbours' distances
from them by one gather (`gathered_sq_dists`: the same operations, so the
same values bit for bit), which is differentiable in both clouds, as the
JAX package's distances are.

Counters: LAUNCHES counts the kernel's launches since it was last set to
0 (a training step's record takes its change as `knn_launches`);
`plain_knn` adds its chunks to the open step's `knn_chunks`
(utils/profiling.py).
"""
from __future__ import annotations

import ctypes

import torch

from hugs_tpu_torch import build
from hugs_tpu_torch.utils import profiling

SOURCE = "knn"
MAX_K = 8         # the kernel's lists hold at most 8 neighbours
LAUNCHES = 0      # K3 launches since the count was last set to 0
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _centred(query: torch.Tensor, ref: torch.Tensor):
    mu = torch.mean(ref, dim=0, keepdim=True)
    return query - mu, ref - mu


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs for each query point: (sq_dists (M, k) float32,
    indices (M, k) int64), ascending by distance, the lower index first
    among equal distances. CUDA tensors launch K3 (float32 (M, 3) and
    (N, 3) on one device, 1 <= k <= MAX_K, k <= N); CPU tensors run
    `plain_knn`, whose chunks `chunk` bounds."""
    global LAUNCHES
    if not query.is_cuda:
        return plain_knn(query, ref, k, chunk)
    if ref.device != query.device:
        raise ValueError(f"ref is on {ref.device}, query on {query.device}")
    for name, x in (("query", query), ("ref", ref)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"K3 takes float32 (rows, 3) points; {name} is "
                             f"{x.dtype} {tuple(x.shape)}")
    m, n = query.shape[0], ref.shape[0]
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"K3 takes 1 <= k <= min({MAX_K}, N); k = {k}, "
                         f"N = {n}")
    if max(m, n) >= 2 ** 31:
        raise ValueError(f"K3 indexes rows with 32-bit ints; M = {m}, "
                         f"N = {n}")
    query, ref = _centred(query, ref)
    idxs = torch.empty((m, k), dtype=torch.int64, device=query.device)
    if m == 0:
        return gathered_sq_dists(query, ref, idxs), idxs
    lib = build.load(SOURCE)
    if lib.hugs_knn.argtypes is None:
        lib.hugs_knn.argtypes = _ARGS
        lib.hugs_knn.restype = ctypes.c_int
    q, r = query.detach().contiguous(), ref.detach().contiguous()
    with torch.cuda.device(query.device):
        err = lib.hugs_knn(q.data_ptr(), r.data_ptr(), m, n, k,
                           idxs.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    LAUNCHES += 1
    return gathered_sq_dists(query, ref, idxs), idxs


def gathered_sq_dists(query: torch.Tensor, ref: torch.Tensor,
                      idxs: torch.Tensor) -> torch.Tensor:
    """(M, k) squared distances of each query to its refs idxs (M, k),
    ((dx dx + dy dy) + dz dz) with d = ref - query, as the kernel and the
    plain version's distance matrix compute them (equal bit for bit);
    differentiable in query and ref."""
    diff = ref[idxs] - query[:, None, :]                  # (M, k, 3)
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return dx * dx + dy * dy + dz * dz


def plain_knn(query: torch.Tensor, ref: torch.Tensor, k: int,
              chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """`knn` in plain PyTorch on any device, `chunk` queries at a time:
    the neighbours found on a (chunk, N) distance matrix, k rounds of
    first-minimum argmin, their distances from `gathered_sq_dists`."""
    profiling.count("knn_chunks", -(-query.shape[0] // chunk))
    query, ref = _centred(query, ref)
    with torch.no_grad():
        rx, ry, rz = ref[:, 0], ref[:, 1], ref[:, 2]
        idxs = []
        for q in torch.split(query, chunk):
            dx = rx[None, :] - q[:, 0:1]
            dy = ry[None, :] - q[:, 1:2]
            dz = rz[None, :] - q[:, 2:3]
            d = dx * dx + dy * dy + dz * dz               # (C, N)
            ids = []
            for _ in range(k):
                i = torch.argmin(d, dim=1, keepdim=True)  # first minimum
                ids.append(i)
                d.scatter_(1, i, torch.inf)
            idxs.append(torch.cat(ids, dim=1))
        idxs = torch.cat(idxs)
    return gathered_sq_dists(query, ref, idxs), idxs


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3,
                        chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest OTHER points
    (distCUDA2: scales = log(sqrt(clamp(distCUDA2(pts))))). Takes k+1
    neighbours and drops the nearest, the point itself."""
    d, _ = knn(points, points, k + 1, chunk=chunk)
    return torch.mean(d[:, 1:], dim=-1)
