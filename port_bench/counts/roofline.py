"""The least time an H100 could take for a kernel's work, and the work
itself, counted from shapes and from the state: the larger of the
operations over the card's float32 peak and the bytes over its memory
rate.

The rules are those the port's kernel table was measured against
(``PERF.md`` §6). They count what the function needs, so the count stays
the same whatever kernel implements it:

- a cell-list force: ``3d - 1`` operations a distance test (each particle
  against the particles of its ``3^d`` neighbour cells, itself excluded),
  ``7 + 2d`` more a pair inside the cutoff (one divide, s^6, the force
  magnitude, d products and d sums); d coordinate grids in, d grids out,
  plus any count grid the kernel is handed;
- a permutation of F field planes: the code grid read, the F fields of
  the particles that land in the output read (an empty slot's fields need
  no read), F planes written.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch

# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
WORD = 4  # float32 and int32 bytes

Bound = Tuple[float, str]


def bound(flops: float, nbytes: float) -> Bound:
    """``(seconds, bound_by)``: the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def force_bound(work: Tuple[int, int], dim: int, n_slots: int, extra_in_bytes: int = 0) -> Bound:
    """Bound of a cell-list force (forces only), from the pair census
    ``(candidates, in_cutoff)`` and the ``n_slots`` of each coordinate
    grid."""
    candidates, in_cut = work
    return bound((3 * dim - 1) * candidates + (7 + 2 * dim) * in_cut, WORD * dim * 2 * n_slots + extra_in_bytes)


def migrate_bound(n_fields: int, n_slots: int, n_moved: int) -> Bound:
    """A permutation of ``n_fields`` planes of ``n_slots`` that places
    ``n_moved`` particles."""
    return bound(0.0, WORD * (n_slots + n_moved * n_fields + n_slots * n_fields))


def pair_census(position: torch.Tensor, box: float, cells_per_side: int, cutoff: float) -> Tuple[int, int]:
    """``(candidates, in_cutoff)`` that a cell-list force needs on these
    positions binned into ``cells_per_side``^d cells: each particle against
    the particles of its 3^d neighbour cells, itself excluded, and the
    ordered pairs among them inside the cutoff (each pair once for each
    partner), by the minimum image."""
    from port_bench.reference.lj_nve import pair_list

    n, dim = position.shape
    cps = cells_per_side
    r = torch.remainder(position.double(), box)
    c = torch.div(r, box / cps, rounding_mode="floor").long().clamp_(0, cps - 1)
    strides = torch.tensor([cps ** (dim - 1 - k) for k in range(dim)], device=r.device)
    n_cell = torch.bincount((c * strides).sum(1), minlength=cps**dim).view((cps,) * dim)
    candidates = -n
    for off in itertools.product((-1, 0, 1), repeat=dim):
        candidates += int((n_cell * torch.roll(n_cell, off, tuple(range(dim)))).sum())
    i, j = pair_list(r, box, cutoff)
    d = r[i] - r[j]
    d = d - box * torch.round(d / box)
    in_cut = 2 * int(((d * d).sum(1) < cutoff * cutoff).sum())
    return candidates, in_cut
