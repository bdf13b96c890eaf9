"""Several hosts: the ('data', 'tile') mesh laid out so that the tile axis
stays inside a host (the counterpart of hugs_tpu/parallel/multihost.py).

The image bands' all_gather and its reduce-scatter run every step, so
they belong on a host's NVLink; only the data axis's gradient
all-reduce crosses hosts. torchrun numbers a host's ranks consecutively
(RANK = node x LOCAL_WORLD_SIZE + LOCAL_RANK), and mesh.Mesh puts rank r
at tile coordinate r % n_tile, so every tile group lies on one host
when n_tile divides LOCAL_WORLD_SIZE: make_hybrid_mesh checks that and
builds the plain mesh. One process, or one host, is the same code.

  python -m torch.distributed.run --nnodes=M --nproc_per_node=N \\
      --rdzv_endpoint=HOST:PORT -m hugs_tpu_torch.main ...

`init_distributed` is mesh.py's (re-exported here). hugs_tpu's
`enable_overlap_flags` sets XLA TPU flags that let collectives overlap
the backward; it has no counterpart, because NCCL already runs
collectives on their own stream.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from hugs_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh,
)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_world_size() -> int:
    """The ranks on this host: torchrun's LOCAL_WORLD_SIZE, else the
    world (one host), else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return dist.get_world_size() if _initialized() else 1


def make_hybrid_mesh(n_tile: int | None = None) -> Mesh:
    """The ('data', 'tile') mesh over every rank, the tile axis inside a
    host: n_tile (default a host's ranks) must divide the host's ranks;
    'data' takes the rest, across hosts."""
    n_local = local_world_size()
    if n_tile is None:
        n_tile = n_local
    if n_local % n_tile:
        raise ValueError(f"n_tile={n_tile} must divide the {n_local} ranks "
                         f"of a host")
    return make_mesh(n_tile=n_tile)


def global_batch(local_batch, device: torch.device | str = "cuda"):
    """This rank's frames (arrays, or dicts, lists and tuples of them,
    each led by the frame axis) as tensors on its device: what a global
    array's local share is in torch, where each data rank holds its own
    frames and no array spans ranks (hugs_tpu's takes the mesh to build
    the global array)."""
    if isinstance(local_batch, dict):
        return {k: global_batch(v, device) for k, v in local_batch.items()}
    if isinstance(local_batch, (list, tuple)):
        return type(local_batch)(global_batch(v, device)
                                 for v in local_batch)
    return torch.as_tensor(np.asarray(local_batch), device=device)


def sync_hosts() -> None:
    """A barrier over every rank (nothing with one process)."""
    if _initialized():
        dist.barrier()
