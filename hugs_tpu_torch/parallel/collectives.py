"""The collectives of the data x tile and Gaussian-sharded paths, over a
Mesh's axes.

Each is the identity on a mesh without a process group. `all_gather` is
differentiable: its backward is the reduce-scatter sum of the gradient,
the transpose of JAX's all_gather(tiled=True). Every rank of the group
that differentiates a value computed identically on each of them (a
loss on the gathered frame) hands the reduce-scatter the same cotangent,
so each rank's slice receives n times its gradient; the data x tile
step divides its pixel objective by n_tile for this (train_dp_tile.py).

`all_to_all` exchanges a (D, cap, ...) packet with equal splits: row e
goes to rank e of the axis, and row e of the result came from rank e.
It is differentiable, and its backward is the same exchange of the
gradient, the transpose that jax.grad inserts for lax.all_to_all
(hugs_tpu/parallel/gauss_shard.py:27-30).

The rest reduce without a gradient: `psum_` (one all-reduce of a list of
tensors flattened into one buffer, in place), `pmax`, `pany`, and
`broadcast_` from rank 0. On the card they run over NCCL, on the CPU over
gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from hugs_tpu_torch.parallel.mesh import Mesh

# torch 2.13 renamed all_gather_into_tensor and reduce_scatter_tensor (the
# old names warn there); earlier releases have only the old names
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
        _gather_into(out, xm, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        gm = grad.movedim(ctx.dim, 0).contiguous()
        out = gm.new_empty((gm.shape[0] // ctx.n,) + tuple(gm.shape[1:]))
        _reduce_scatter(out, gm, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' x of `axis` concatenated along `dim` in coordinate
    order; differentiable."""
    if not mesh.distributed:
        return x
    return _AllGather.apply(x, mesh.group(axis), mesh.axis_size(axis), dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Row e of x (D, ...) to rank e of `axis` (D ranks); returns the rows
    the ranks sent here, in rank order. Differentiable."""
    n = mesh.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} ranks takes ({n}, ...) "
                         f"packets, not {tuple(x.shape)}")
    if not mesh.distributed:
        return x
    return _AllToAll.apply(x, mesh.group(axis))


def _all_reduce_(buf: torch.Tensor, mesh: Mesh, axis, op) -> torch.Tensor:
    if mesh.distributed:
        dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return buf


@torch.no_grad()
def psum_(tensors: list[torch.Tensor], mesh: Mesh,
          axis=("data", "tile")) -> list[torch.Tensor]:
    """Sums each tensor over `axis` in place, all of them in one
    all-reduce of one float32 buffer. Returns the list."""
    if not mesh.distributed or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _all_reduce_(flat, mesh, axis, dist.ReduceOp.SUM)
    pos = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[pos:pos + n].view(t.shape))
        pos += n
    return tensors


@torch.no_grad()
def pmax(x: torch.Tensor, mesh: Mesh, axis=("data", "tile")) -> torch.Tensor:
    return _all_reduce_(x.clone(), mesh, axis, dist.ReduceOp.MAX)


@torch.no_grad()
def pany(x: torch.Tensor, mesh: Mesh, axis=("data", "tile")) -> torch.Tensor:
    """Logical or over `axis` of a bool tensor."""
    return _all_reduce_(x.to(torch.uint8), mesh, axis,
                        dist.ReduceOp.MAX).bool()


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Rank 0's values of each tensor on every rank, in place (through a
    contiguous copy where a tensor is a strided view)."""
    if mesh.distributed:
        for t in tensors:
            c = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(c, src=0)
            if c is not t:
                t.copy_(c)
    return tensors
