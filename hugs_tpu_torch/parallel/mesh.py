"""The layouts of the ranks and the process groups of their axes: the
('data', 'tile') mesh (the counterpart of hugs_tpu/parallel/shard.py::
make_mesh) and the 1-D ('gauss',) mesh of the Gaussian-sharded renderer
(hugs_tpu/train/trainer.py::_get_gauss_mesh).

Rank r sits at data coordinate r // n_tile and tile coordinate
r % n_tile, the row-major order in which the JAX package reshapes its
device list. Each axis has one process group per coordinate of the
other axis (torch.distributed.new_group, which every rank enters for
every group, in the same order); both axes together are the default
group. A mesh made without a process group is (1, 1) with no groups:
every collective of parallel/collectives.py is then the identity.

A ('gauss',) mesh of n ranks is the whole default group (the world must
be n), or one rank with no group: the one-card case, whose collectives
are the identity but which runs the whole fragment path. The layout of
several hosts is parallel/multihost.py's.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

AXES = ("data", "tile")
GAUSS = "gauss"
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


class Mesh:
    """n_data x n_tile ranks, this rank's coordinates and the groups of
    its axes ({'data': group, 'tile': group}; None without a process
    group)."""

    def __init__(self, n_data: int = 1, n_tile: int = 1, rank: int = 0,
                 groups: dict | None = None):
        self.shape = {"data": int(n_data), "tile": int(n_tile)}
        self.rank = int(rank)
        self.coords = {"data": self.rank // self.shape["tile"],
                       "tile": self.rank % self.shape["tile"]}
        self.groups = groups

    def __repr__(self):
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({shape}, rank={self.rank}, "
                f"distributed={self.distributed})")

    @classmethod
    def line(cls, axis: str, n: int = 1, rank: int = 0,
             distributed: bool = False) -> "Mesh":
        """A 1-D mesh of n ranks over `axis`, its group the default one
        where `distributed`."""
        mesh = cls.__new__(cls)
        mesh.shape = {axis: int(n)}
        mesh.rank = int(rank)
        mesh.coords = {axis: mesh.rank}
        mesh.groups = {axis: None} if distributed else None
        return mesh

    @property
    def distributed(self) -> bool:
        return self.groups is not None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def axes(self, axis) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}; expected one of "
                                 f"{tuple(self.shape)}")
        return axes

    def axis_size(self, axis) -> int:
        n = 1
        for a in self.axes(axis):
            n *= self.shape[a]
        return n

    def group(self, axis):
        """The process group of `axis` ('data', 'tile' or both): the
        default group for both axes."""
        axes = self.axes(axis)
        return self.groups[axes[0]] if len(axes) == 1 else None

    def local_slice(self, n: int) -> slice:
        """This data rank's share of n items (n a multiple of n_data)."""
        n_data = self.shape["data"]
        if n % n_data:
            raise ValueError(f"{n} items do not split over {n_data} data "
                             f"ranks")
        per = n // n_data
        d = self.coords["data"]
        return slice(d * per, (d + 1) * per)

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the logs, checkpoints and images."""
        return self.rank == 0

    def barrier(self):
        if self.distributed:
            dist.barrier()


def make_mesh(n_data: int | None = None, n_tile: int = 1) -> Mesh:
    """The mesh over every rank of the default process group, n_data
    (default: the world size over n_tile) x n_tile; (1, 1) without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_tile != 1:
            raise ValueError(f"a ({n_data}, {n_tile}) mesh needs a process "
                             f"group of {(n_data or 1) * n_tile} ranks; "
                             f"none is initialised")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_tile
    if n_data * n_tile != world:
        raise ValueError(f"a ({n_data}, {n_tile}) mesh needs "
                         f"{n_data * n_tile} ranks; the world has {world}")
    groups = {}
    # every rank enters every new_group call, in the same order
    for t in range(n_tile):
        g = dist.new_group([d * n_tile + t for d in range(n_data)])
        if rank % n_tile == t:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([d * n_tile + t for t in range(n_tile)])
        if rank // n_tile == d:
            groups["tile"] = g
    return Mesh(n_data, n_tile, rank, groups)


def make_gauss_mesh(n: int) -> Mesh:
    """The 1-D ('gauss',) mesh of n ranks: the default process group,
    whose world must be n, or with no group n = 1 (one card, no
    collectives)."""
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ValueError(f"a ('gauss',) mesh of {n} ranks needs a process "
                             f"group of {n} ranks; none is initialised")
        return Mesh.line(GAUSS)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a ('gauss',) mesh of {n} ranks needs a world of "
                         f"{n} ranks; the world has {world}")
    return Mesh.line(GAUSS, n, dist.get_rank(), distributed=True)


def factor_devices(n: int) -> tuple[int, int]:
    """(n_data, n_tile) for n ranks: the tile axis 4 or 2 where it
    divides n, else n (__graft_entry__.py's dryrun_multichip factoring)."""
    n_tile = next(c for c in (4, 2, n) if n % c == 0 and c <= n)
    return n // n_tile, n_tile


def torchrun_env() -> bool:
    """Whether torchrun's variables describe this process."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Joins the process group torchrun's variables describe (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on card
    LOCAL_RANK for a cuda device, gloo for the CPU. Returns the device
    this rank works on; without the variables, `device` unchanged and no
    group."""
    device = torch.device(device)
    if not torchrun_env():
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return device
