"""Local ranks for tests and smoke runs: ``run_local_ranks`` starts
``world`` processes on this machine, joins them in a process group over a
``FileStore`` in a scratch directory (no TCP port), runs one function on
each, and returns what each rank returned.  A rank that raises fails the
call with its traceback; ranks still running at the deadline are killed
and the call fails, so a hung collective cannot hang the caller.

The ranks use gloo, also when they share one card (NCCL refuses two ranks
on one GPU; gloo's collectives take CUDA tensors).  A multi-GPU run is
launched with ``torchrun`` instead (see ``dist.multihost``)."""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, fn, world: int, workdir: str, kw: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = fn(**kw)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def run_local_ranks(fn, world: int, workdir, timeout: float, **kw) -> list:
    """fn(**kw) on ranks 0..world-1 of a fresh gloo process group; returns the
    ranks' results in rank order.  ``fn`` must be importable by name in a
    spawned interpreter (a module-level function); ``workdir`` a directory
    of its own (made if missing)."""
    workdir = os.fspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank, args=(fn, world, workdir, kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic()), grace_period=5):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                               f"{timeout} s: killed")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
