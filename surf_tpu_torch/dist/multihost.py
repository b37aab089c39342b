"""Process-group start-up (port of ``surf_tpu.dist.multihost``).

Every process of a run calls ``init_multihost()`` before it builds a mesh,
then ``make_host_chip_mesh`` builds the ('hosts', 'chips') mesh over the
whole world.  Under ``torchrun`` (``torchrun --nproc-per-node=N ...``) the
process group comes from the launcher's environment; with nothing set the
process is a world of one.  The rendering and gradient code of
``dist.sharding`` runs unchanged on any world size."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh_2d

_LAUNCHER = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str | torch.device = "cuda") -> torch.device:
    """Initialise the default process group: NCCL for a CUDA device, gloo
    for the CPU.  With ``coordinator_address`` ("host:port") the world is
    ``num_processes`` processes and this one is ``process_id``; without
    it, the environment ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); with none of that, a world of one in this process.
    Returns this rank's device: ``cuda:LOCAL_RANK`` (made current) for a
    CUDA device, else the device as given."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: device cuda, but CUDA is not available")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)  # NCCL binds the rank to the current device
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _LAUNCHER):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return device


def make_host_chip_mesh(device) -> Mesh:
    """The whole world as a ('hosts', 'chips') mesh, hosts-major: a host's
    chips are its LOCAL_WORLD_SIZE ranks (``torchrun`` sets it; the whole
    world without it)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return make_mesh_2d(world // per_host, per_host, device)
