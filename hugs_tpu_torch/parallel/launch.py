"""Runs a function on N ranks of one machine, each a spawned process in
one process group, and returns what each rank returned: the launcher of
the CPU tests' gloo groups and of chip_smoke.py's NCCL ranks (one card
each). Ranks that do not finish within the timeout are terminated and
the call raises, so a hung collective cannot stall the caller.

A user launches the port on N cards with torchrun instead
(`python -m torch.distributed.run --nproc_per_node=N -m
hugs_tpu_torch.main ...`, see main.py).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

# CPU threads per rank: ranks share the machine's cores
RANK_THREADS = 2


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, args, out):
    try:
        torch.set_num_threads(RANK_THREADS)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        # reported to the parent, which raises; then this rank fails too
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 60.0) -> list:
    """fn(rank, world, *args) on `world` spawned ranks of one process
    group (gloo on the CPU; nccl with rank r on card r), fn importable
    by name and its arguments and result picklable. Returns the results
    in rank order; raises RuntimeError with the rank's traceback if one
    raised, or when `timeout` seconds pass, after terminating every
    rank."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, None
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        while len(results) < world and failed is None:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = out.get(timeout=max(min(left, 1.0), 0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    # died before it could report (e.g. while starting)
                    failed = (f"ranks {dead} exited with codes "
                              f"{[procs[r].exitcode for r in dead]}")
                elif left <= 0:
                    failed = (f"{world - len(results)} of {world} ranks did "
                              f"not finish within {timeout} s")
                continue
            if ok:
                results[rank] = value
            else:
                failed = f"rank {rank} raised:\n{value}"
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0)
                   if failed is None else 0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        out.close()
    if failed is not None:
        raise RuntimeError(f"run_ranks({fn.__name__}): {failed}")
    return [results[r] for r in range(world)]
