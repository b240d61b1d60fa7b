"""Grid-resident LJ molecular dynamics (2D), the port's main path.

Port of the JAX package's ``ops/kernels/grid_md.py`` (``GridMDState``,
``GridMD``), single device. The windows, drivers, binning, sort-free
rebuild and observables are the core it shares with the 3D engine
(``grid_engine.py``; read its docstring first). What is 2D's own:

- The packed layout ``(cps / R, cap, R * cps)``: R (``rows_per_block``)
  consecutive cell rows share a block, slot ``(g, a, lane)`` holds slot
  ``a`` of cell ``(g * R + lane // cps, lane % cps)``. R defaults to the
  JAX package's ``choose_rows_per_block``, without its 128-lane padding.
  The allocation runs on the unpacked view (``pack`` / ``unpack``).
- The force kernel: B1 (``cell_cuda``) at R = 1, B3 (``cell_cuda_packed``)
  at R > 1, which takes the state's count grid ``counts``.
- The rebuild's migrate kernel B2 (``migrate_cuda``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import make_grid_force_kernel
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import (
    choose_rows_per_block,
    make_grid_force_kernel_packed,
    pack,
    unpack,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_engine import GridEngine, GridState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import migrate


@dataclass(kw_only=True)
class GridMDState(GridState):
    """All (cps/R, cap, R*cps) leaves live on ``GridMD.device``.

    ``fxg/fyg`` hold the total force. ``dispx/dispy`` accumulate per-slot
    displacement since the last rebuild (the Verlet-skin monitor).
    ``counts`` is the ``(rows, cps)`` int32 number of particles of each
    cell, made at ``init`` and at each rebuild: a cell's particles hold its
    slots ``0 .. count-1`` until the next rebuild. Kernel B3 (R > 1) takes
    it.
    """

    xg: torch.Tensor
    yg: torch.Tensor
    vxg: torch.Tensor
    vyg: torch.Tensor
    fxg: torch.Tensor
    fyg: torch.Tensor
    dispx: torch.Tensor
    dispy: torch.Tensor
    # Kahan compensation residuals (compensated=True)
    crx: Optional[torch.Tensor] = None
    cry: Optional[torch.Tensor] = None
    cvx: Optional[torch.Tensor] = None
    cvy: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None


class GridMD(GridEngine):
    """Factory for the 2D grid-resident MD step functions. State lives on
    ``device``: the card unless the caller asks for the CPU.

    ``rows_per_block``: R, which must divide the cells per side; None takes
    the JAX package's default, ``choose_rows_per_block(cps)``.
    """

    AXES = ("x", "y")
    State = GridMDState

    def __init__(
        self,
        grid_fn: CellGridFn,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
        rows_per_block: Optional[int] = None,
        device="cuda",
    ):
        if rows_per_block is None:
            rows_per_block = choose_rows_per_block(grid_fn.cells_per_side)
        super().__init__(grid_fn, dt, compensated, device, rows_per_block)
        # hot-path kernel: forces only; the energy variant runs only at
        # sampling points (potential_energy, virial)
        if rows_per_block > 1:
            def mk(**kw):
                return make_grid_force_kernel_packed(grid_fn, rows_per_block, sigma, epsilon, **kw)
        else:
            def mk(**kw):
                return make_grid_force_kernel(grid_fn, sigma, epsilon, **kw)
        self.force_kernel = mk()
        self.energy_kernel = mk(with_energy=True)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        return pack(t, self.rows_per_block)

    def _unpack(self, t: torch.Tensor) -> torch.Tensor:
        return unpack(t, self.rows_per_block)

    def _binning(self, counts: torch.Tensor, overflow: torch.Tensor) -> dict:
        """The count grid is the state's own (B3 reads it)."""
        return dict(counts=counts, overflow=overflow)

    def _force_args(self, s: GridMDState) -> tuple:
        """The count grid where the force kernel takes it (B3, R > 1)."""
        return (s.counts,) if self.rows_per_block > 1 else ()

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        """Kernel B2; it reports nothing besides the planes."""
        return migrate(scode, fields, fills, self.rows_per_block, occ=occ), None
