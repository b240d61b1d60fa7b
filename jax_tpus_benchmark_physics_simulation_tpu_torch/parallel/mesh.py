"""The row mesh: a 1-D ring of ranks over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py`` for the row-sharded grid
engines. JAX builds a ``Mesh`` over devices and runs ``shard_map`` programs
whose ``ppermute``, ``pmax`` and ``psum`` XLA compiles into collectives.
Here one process drives one device, and :class:`RowMesh` holds that
process's place in a process group: its rank, the world size, its device
and the group. Its methods are the collectives the engines use:

- :meth:`RowMesh.exchange`: one row to each ring neighbour and one row from
  each, through ``dist.batch_isend_irecv`` (``ppermute`` in JAX);
- :meth:`RowMesh.all_max` / :meth:`RowMesh.all_sum` (``pmax`` / ``psum``);
- :meth:`RowMesh.all_gather_rows`: every rank's block, concatenated.

A mesh of one rank needs no process group: its exchange is a local swap,
which is also what ``ppermute`` does on an axis of size 1 (gloo refuses a
send to self), and its reductions return their input. With a group of one
rank (NCCL on one card) the reductions still run on the group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# message tags of the two directions of an exchange
_TO_PREV, _TO_NEXT = 0, 1


@dataclass(frozen=True)
class RowMesh:
    """This process's place in a 1-D ring of ``size`` ranks."""

    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None  # a ProcessGroup; None: one rank, no group

    def _peer(self, step: int) -> int:
        """Global rank of the group member ``step`` places along the ring."""
        return dist.get_global_rank(self.group, (self.rank + step) % self.size)

    def exchange(self, first_row: torch.Tensor, last_row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(prev_halo, next_halo)``: the previous rank's ``last_row`` and the
        next rank's ``first_row``, around the ring (rank 0's previous rank
        is the last one). Every rank must call it with rows of one shape.

        At size 2 both neighbours are one peer, so the two messages to it
        and the two from it pair up by order (NCCL) and by tag (gloo): each
        rank posts its sends first-row-then-last-row and its receives
        next-halo-then-prev-halo, which match the peer's sends in that
        order. At size 1 the halos are the inputs themselves (no copy): a
        caller that changes a halo in place passes rows it owns."""
        if self.size == 1:
            return last_row, first_row
        first_row = first_row.contiguous()
        last_row = last_row.contiguous()
        prev_halo = torch.empty_like(last_row)
        next_halo = torch.empty_like(first_row)
        prev, nxt = self._peer(-1), self._peer(1)
        ops = [
            dist.P2POp(dist.isend, first_row, prev, self.group, _TO_PREV),
            dist.P2POp(dist.isend, last_row, nxt, self.group, _TO_NEXT),
            dist.P2POp(dist.irecv, next_halo, nxt, self.group, _TO_PREV),
            dist.P2POp(dist.irecv, prev_halo, prev, self.group, _TO_NEXT),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return prev_halo, next_halo

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t
        # gloo reduces no bool: flags travel as int32
        buf = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.dtype)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks (``pmax``); a bool is an any."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks (``psum``)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), concatenated along
        dim 0 in rank order."""
        if self.group is None:
            return t
        parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def _default_device(backend: Optional[str], rank: int) -> torch.device:
    """gloo: the CPU; NCCL or no group: this rank's card (``LOCAL_RANK``
    as a launcher sets it, else the rank modulo the card count)."""
    if backend == "gloo":
        return torch.device("cpu")
    if backend is None:
        return torch.device("cuda")
    local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def make_mesh(n_devices: Optional[int] = None, group=None, device=None) -> RowMesh:
    """The row mesh of this process over ``group`` (default: the whole
    initialised process group). Without an initialised process group it is
    a mesh of one rank. ``n_devices``, if given, must equal the group's
    size: each rank drives one device. ``device`` defaults to the CPU under
    gloo and to this rank's card otherwise."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank = dist.get_rank(group)
        if rank < 0:
            raise ValueError("this process is not a member of the group")
        size = dist.get_world_size(group)
        backend = dist.get_backend(group)
    elif group is not None:
        raise ValueError("a group was given, but torch.distributed is not initialised")
    else:
        rank, size, backend = 0, 1, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested a mesh of {n_devices} devices, the process group has {size} ranks")
    device = torch.device(device) if device is not None else _default_device(backend, rank)
    return RowMesh(rank=rank, size=size, device=device, group=group)


def shard_along(mesh: RowMesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` (whose length the
    mesh size must divide), as a contiguous copy."""
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"dimension {dim} of length {n} does not split over {mesh.size} ranks")
    block = n // mesh.size
    return t.narrow(dim, mesh.rank * block, block).contiguous()


def replicated(mesh: RowMesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` as group rank ``src`` holds it, on every rank (a broadcast, in
    place)."""
    if mesh.group is not None:
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, src), group=mesh.group)
    return t


def halo_blocks(t: torch.Tensor, p: int, seam: float = 0.0, dim: int = 0) -> List[torch.Tensor]:
    """The ``p`` row blocks of a whole grid along ``dim`` (1 for stacked
    fields), each with its periodic neighbour rows attached, ``rows + 2``
    long: what each of ``p`` ranks builds from its exchange, here in one
    process (for checking the halo kernels against the whole-grid ones).
    The first block's previous row gets ``-seam`` and the last block's
    next row ``+seam`` (``box`` for x)."""
    n = t.shape[dim]
    rows = n // p
    out = []
    for k in range(p):
        prev = t.narrow(dim, (k * rows - 1) % n, 1)
        nxt = t.narrow(dim, ((k + 1) * rows) % n, 1)
        if seam and k == 0:
            prev = prev - seam
        if seam and k == p - 1:
            nxt = nxt + seam
        out.append(torch.cat([prev, t.narrow(dim, k * rows, rows), nxt], dim))
    return out


def pad_to_multiple(n: int, p: int) -> int:
    return ((n + p - 1) // p) * p
