"""Process-group start-up from the launcher's environment.

Counterpart of `gaussianrpg_tpu/parallel/distributed.py`. The JAX package
is single-controller (one process drives every device); the port is SPMD:
`python -m torch.distributed.run --nproc_per_node N ...` starts one
process per rank and sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR` and `MASTER_PORT`, which `initialize` reads.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a collective that waits longer fails: ranks that took different
# branches (one retrying an overflowed step, one not) raise, not hang
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(backend: str | None = None) -> bool:
    """Start the default process group from the launcher's environment
    with `backend` ("nccl" unless given; "gloo" for CPU ranks or several
    ranks on one card) and a TIMEOUT on every collective. Returns False,
    and starts nothing, when the environment names no launch (safe to
    call unconditionally); True when a group is running, also one that
    was started before."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in LAUNCHER_ENV):
        return False
    dist.init_process_group(backend or "nccl", init_method="env://",
                            timeout=TIMEOUT)
    return True


def host_local_mesh_info():
    """(rank, world size, local device count): this process's rank, the
    number of ranks, and the CUDA devices this host has (0 without
    CUDA)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dist.is_initialized():
        return 0, 1, local
    return dist.get_rank(), dist.get_world_size(), local


def local_device(device=None) -> torch.device:
    """The device of this rank: `device` when the caller names one, else
    `cuda:LOCAL_RANK % device_count()` (made current, so that "cuda"
    means it too)."""
    if device is not None:
        dev = torch.device(device)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev
