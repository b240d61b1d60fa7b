"""Multi-process initialisation.

Port of the JAX package's ``parallel/multihost.py``: there
``jax.distributed.initialize`` joins a cluster, here
``torch.distributed.init_process_group`` does, with NCCL between cards and
gloo on the CPU. A launcher such as ``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; a
caller may instead pass a store or an ``init_method`` with the world size
and the rank.

As in the JAX package, a plain host with no cluster is not an error (the
call returns False), but a real failure propagates: a bad address, a rank
outside the world, an unknown backend. Swallowing those would turn a
misconfigured cluster into a silent single-process run.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    store=None,
) -> bool:
    """Initialise ``torch.distributed`` once. Returns True when more than
    one process takes part.

    With no arguments it reads the launcher environment; with none set
    (``WORLD_SIZE`` absent) there is no cluster and it returns False
    without initialising anything. ``backend`` defaults to NCCL when a card
    is present and gloo otherwise; under NCCL this process takes the card
    ``LOCAL_RANK`` (else its rank modulo the card count). A second call is
    a no-op."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if any(v is not None for v in (init_method, world_size, rank, store)):
        kw = dict(world_size=-1 if world_size is None else world_size, rank=-1 if rank is None else rank)
    elif "WORLD_SIZE" in os.environ:  # the launcher's env:// rendezvous
        world_size, rank, kw = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0)), {}
    else:
        return False
    if world_size is not None and world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    if rank is not None and world_size is not None and not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} lies outside a world of {world_size}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", (rank or 0) % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, store=store, **kw)
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that writes reports and files: rank 0, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    """The initialised process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1
