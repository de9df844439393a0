"""Joining a process group (port of
weiner_slamit_v2_tpu/parallel/multihost.py).

Every process calls :func:`initialize`; afterwards :func:`global_mesh` is a
``BAMesh`` over all ranks and the distributed BA (parallel/sharded_ba.py)
runs over it unchanged. The collectives ride NCCL between cards and gloo
between CPU processes; the backend follows the device the caller names,
never a fallback.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..util import resolve_device


def initialize(device=None, init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    With no ``init_method`` the standard environment is read (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them);
    otherwise e.g. ``file:///path/store`` or ``tcp://host:port`` with
    ``world_size`` and ``rank``. On the card, rank r takes card LOCAL_RANK
    (or r modulo the card count)."""
    device = resolve_device(device)
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank)
    return device


def global_mesh(device=None):
    """A 1-D ``BAMesh`` over every rank of the default group."""
    from .sharded_ba import BAMesh

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return BAMesh(group=None, rank=dist.get_rank(), world_size=dist.get_world_size(), device=device)


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1
