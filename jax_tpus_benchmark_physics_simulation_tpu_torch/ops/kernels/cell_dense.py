"""Cell-grid geometry and the cell-dense LJ force.

Port of the JAX package's ``ops/kernels/cell_dense.py``:

- :class:`CellGridFn` and :func:`make_cell_grid_fn`: cells per side, slot
  capacity and skin, the same numbers as the JAX package so both lay
  particles out on the same grid (the grid engines size their grids with
  it);
- :meth:`CellGridFn.build`: the ``force_impl="cell"`` path's assignment of
  particles to (cell, slot), by a stable argsort of the cell ids (the same
  ``slot`` and ``occupancy`` as the JAX package on a state without
  overflow), with ``needs_rebuild`` / ``maybe_rebuild`` under a Verlet
  skin;
- :func:`make_lj_force_cell_dense`: for each of the 3^dim neighbour
  offsets, the cell grid rolled by that offset against itself, minimum
  image and LJ on the dense (cells..., C, C) pair block.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.pbc import minimum_image


@dataclass(frozen=True)
class CellAssignment:
    slot: torch.Tensor  # (N,) int64 flat slot index into the cell grid
    occupancy: torch.Tensor  # (*grid, C) bool
    ref_position: torch.Tensor  # (N, D) positions at build time
    overflow: torch.Tensor  # 0-d bool


@dataclass(frozen=True)
class CellGridFn:
    box: float
    cutoff: float
    skin: float
    n: int
    dim: int
    cells_per_side: int
    capacity: int

    @property
    def n_cells(self) -> int:
        return self.cells_per_side**self.dim

    def _cell_coords(self, position: torch.Tensor) -> torch.Tensor:
        cps = self.cells_per_side
        return torch.clamp((position // (self.box / cps)).to(torch.int64), 0, cps - 1)

    def build(self, position: torch.Tensor, prev_overflow: Optional[torch.Tensor] = None) -> CellAssignment:
        n, cap, cps, dim = self.n, self.capacity, self.cells_per_side, self.dim
        dev = position.device
        coords = self._cell_coords(position)
        ids = coords[:, 0]
        for d in range(1, dim):
            ids = ids * cps + coords[:, d]

        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg_start = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(n, device=dev) - seg_start
        overflow = torch.any(rank >= cap)
        rank = torch.clamp(rank, max=cap - 1)
        if prev_overflow is not None:
            overflow = overflow | prev_overflow

        slot = torch.empty(n, dtype=torch.int64, device=dev)
        slot[order] = sorted_ids * cap + rank  # the slot of particle p, in particle order
        occ_flat = torch.zeros(self.n_cells * cap, dtype=torch.bool, device=dev)
        occ_flat[slot] = True
        return CellAssignment(
            slot=slot, occupancy=occ_flat.reshape((cps,) * dim + (cap,)),
            ref_position=position, overflow=overflow,
        )

    def needs_rebuild(self, position: torch.Tensor, assign: CellAssignment) -> torch.Tensor:
        """0-d bool tensor: some particle moved more than skin/2."""
        dr = minimum_image(position - assign.ref_position, self.box)
        return torch.max(torch.sum(dr * dr, dim=-1)) > (0.5 * self.skin) ** 2

    def maybe_rebuild(self, position: torch.Tensor, assign: CellAssignment) -> CellAssignment:
        """The assignment rebuilt at ``position`` if it needs it, else
        ``assign``. JAX's ``lax.cond`` becomes one host read of
        :meth:`needs_rebuild` a call (a step), the same kind of read as the
        grid engine's per-window ``dmax2``."""
        if bool(self.needs_rebuild(position, assign)):
            return self.build(position, prev_overflow=assign.overflow)
        return assign


def make_cell_grid_fn(
    box: float,
    cutoff: float,
    n: int,
    dim: int = 2,
    skin: float = 0.4,
    rho: Optional[float] = None,
    capacity: Optional[int] = None,
    safety: Optional[float] = None,
) -> CellGridFn:
    cells_per_side = max(1, int(box / (cutoff + skin)))
    if cells_per_side < 3:
        raise ValueError(
            f"cell-dense path needs >= 3 cells per side (box={box}, "
            f"cutoff+skin={cutoff + skin}); use the dense or neighbor path"
        )
    cell_size = box / cells_per_side
    if rho is None:
        rho = n / (box**dim)
    if capacity is None:
        mean = rho * cell_size**dim
        if safety is not None:
            capacity = max(4, int(math.ceil(mean * safety + 2)))
        else:
            # mean + 3*sqrt(mean) + 1. The JAX package measured max
            # occupancy 12 against this cap of 16 at 2D N=100k.
            capacity = max(4, int(math.ceil(mean + 3.0 * math.sqrt(mean) + 1)))
        if dim == 3 and capacity > 16:
            capacity = ((capacity + 15) // 16) * 16
    # multiple of 8: the TPU needed it; kept so both packages share one
    # geometry and the parity tests compare like with like
    capacity = ((capacity + 7) // 8) * 8
    return CellGridFn(
        box=float(box),
        cutoff=float(cutoff),
        skin=float(skin),
        n=n,
        dim=dim,
        cells_per_side=cells_per_side,
        capacity=capacity,
    )


def make_lj_force_cell_dense(grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0):
    """Returns ``force_fn(R, assign) -> F`` and ``force_fn.energy(R,
    assign)``: the physics of ``LennardJones(box, cutoff)``."""
    dim, box, cutoff, cap = grid_fn.dim, grid_fn.box, grid_fn.cutoff, grid_fn.capacity
    grid_shape = (grid_fn.cells_per_side,) * dim
    offsets = list(itertools.product((-1, 0, 1), repeat=dim))
    axes = tuple(range(dim))
    sc6 = (sigma / cutoff) ** 6
    shift = 4.0 * epsilon * (sc6 * sc6 - sc6)

    def _pair_blocks(position: torch.Tensor, assign: CellAssignment):
        """Yields ``(r2, dr, valid)`` on the (grid..., C, C) pair block of
        each offset."""
        flat = position.new_zeros((grid_fn.n_cells * cap, dim))
        flat[assign.slot] = position
        pos_c = flat.reshape(grid_shape + (cap, dim))
        occ = assign.occupancy
        eye = torch.eye(cap, dtype=torch.bool, device=position.device)
        for off in offsets:
            other = torch.roll(pos_c, off, axes) if any(off) else pos_c
            occ_o = torch.roll(occ, off, axes) if any(off) else occ
            dr = minimum_image(pos_c[..., :, None, :] - other[..., None, :, :], box)
            r2 = torch.sum(dr * dr, dim=-1)
            valid = occ[..., :, None] & occ_o[..., None, :] & (r2 < cutoff**2)
            if not any(off):
                valid = valid & ~eye
            yield r2, dr, valid

    def _s6(r2: torch.Tensor, valid: torch.Tensor):
        r2_safe = torch.where(valid, r2, torch.ones_like(r2))
        inv_r2 = r2_safe.new_full((), sigma * sigma) / r2_safe
        return r2_safe, inv_r2 * inv_r2 * inv_r2

    def force_fn(position: torch.Tensor, assign: CellAssignment) -> torch.Tensor:
        f_c = None
        for r2, dr, valid in _pair_blocks(position, assign):
            r2_safe, s6 = _s6(r2, valid)
            s12 = s6 * s6
            fmag = torch.where(valid, 24.0 * epsilon * (2.0 * s12 - s6) / r2_safe, torch.zeros_like(s6))
            contrib = torch.sum(fmag[..., None] * dr, dim=-2)  # (grid..., C, D)
            f_c = contrib if f_c is None else f_c + contrib
        return f_c.reshape(-1, dim)[assign.slot]

    def energy_fn(position: torch.Tensor, assign: CellAssignment) -> torch.Tensor:
        e = position.new_zeros(())
        for r2, _, valid in _pair_blocks(position, assign):
            _, s6 = _s6(r2, valid)
            pair = torch.where(valid, 4.0 * epsilon * (s6 * s6 - s6) - shift, torch.zeros_like(s6))
            e = e + 0.5 * torch.sum(pair)
        return e

    force_fn.energy = energy_fn
    return force_fn
