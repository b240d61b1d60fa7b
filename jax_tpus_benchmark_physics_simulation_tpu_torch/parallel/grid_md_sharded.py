"""Row-sharded grid-resident LJ MD (2D): spatial domain decomposition.

Port of the JAX package's ``parallel/grid_md_sharded.py``
(``ShardedGridMD``). The cell-row axis of the grid is split over a 1-D
:class:`~..parallel.mesh.RowMesh`: each rank holds ``cps / P`` contiguous
rows of every grid and drives its own device. Where JAX runs the window
under ``shard_map`` and the rebuild on GSPMD-global arrays, here every rank
runs the single-device engine's code on its own rows, and the sharding
hooks of the engines' shared core (``grid_engine.GridEngine._all_max`` and
the rest) become collectives:

- **Force.** One exchange a step brings the previous rank's last row and
  the next rank's first row of x and y (with -box / +box on x across the
  periodic seam), and kernel B1 halo (``cell_cuda.grid_force_halo_edges``)
  sums every local slot's 9 cells, reading the edge rows where the
  exchange left them (no ``(rows + 2)`` copy of the grids). The port's B1 does no Newton halving, so
  there are no reaction rows to send back (JAX's ``_shift_reaction``).
- **Window.** ``GridEngine._make_window`` with the halo force; its ``dmax2``
  is reduced with an all-reduce MAX, then read on the host once a window
  as on one device, so every rank takes the same branch of the drivers.
  Langevin noise: keyed by the global particle ids that every rank's
  ``pid`` grid holds (``noise_cuda``), so the ranks draw disjoint noise,
  the same that one device draws, with no rank fold (JAX folds the shard
  index into its key).
- **Rebuild.** ``GridEngine._migration_dest`` on the local rows: the global
  row index carries the rank's row offset, and the two row rolls read one
  row past each end (the neighbours' per-cell ``counts``, then their
  ``bases_t``), two one-row exchanges. A third exchange brings the
  neighbours' edge rows of the code grid and of every field, and kernel
  B2 halo (``migrate_cuda.migrate_halo``) scatters the local rows. No rank
  ever holds the whole grid. The overflow flags (far mover, slot capacity,
  skin/2) are reduced with MAX and stay loud.
- **Observables.** Energy, virial and kinetic energy sum over ranks;
  ``positions`` and ``particle_order`` gather every rank's rows.

The layout is unpacked (R = 1), as JAX's sharded engine requires. A mesh
of one rank runs the same halo kernels, with the exchange a local swap; it
never falls back to the plain ``GridMD``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import (
    CellForceParams,
    grid_force_halo_edges,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD, GridMDState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import migrate_halo
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh, make_mesh, shard_along


class RowSharded:
    """The sharding hooks shared by the 2D and the 3D row-sharded engines.
    A subclass lists it before its engine class and calls :meth:`_shard`
    after the engine's ``__init__``."""

    mesh: RowMesh

    def _shard(self, mesh: RowMesh) -> None:
        if self.cps % mesh.size:
            raise ValueError(f"cells_per_side {self.cps} not divisible by mesh size {mesh.size}")
        self.mesh = mesh
        self.n_shards = mesh.size
        self.rows_local = self.cps // mesh.size
        self._row0 = mesh.rank * self.rows_local
        self._row_slots = math.prod(self.grid_shape[1:])  # slots in one cell row
        self.grid_shape = (self.rows_local,) + tuple(self.grid_shape[1:])
        self.size = self.rows_local * self._row_slots

    @property
    def n_rows(self) -> int:
        return self.rows_local

    def _held(self, slot: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The particles whose global slot lies in this rank's rows, and
        their slots in the local grids."""
        row = torch.div(slot, self._row_slots, rounding_mode="floor")
        ids = torch.nonzero((row >= self._row0) & (row < self._row0 + self.rows_local)).squeeze(1)
        return slot[ids] - self._row0 * self._row_slots, ids

    def _row_ext(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` with the previous rank's last row before it and the next
        rank's first row after it, along ``dim`` (one exchange)."""
        n = t.shape[dim]
        prev, nxt = self.mesh.exchange(t.narrow(dim, 0, 1), t.narrow(dim, n - 1, 1))
        return torch.cat([prev, t, nxt], dim)

    def _all_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_max(t)

    def _all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(t)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather_rows(t)

    def _edge_rows(self, *grids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(prev, nxt)``: the previous rank's last row and the next rank's
        first row of each grid, stacked, from one exchange. The first grid
        is x: its previous row on rank 0 and its next row on the last rank
        lie across the periodic seam and get -box / +box, the offsets B1
        and B4 add themselves on one device."""
        prev, nxt = self.mesh.exchange(torch.stack([g[0] for g in grids]), torch.stack([g[-1] for g in grids]))
        if self.mesh.rank == 0:
            prev[0] -= self.box
        if self.mesh.rank == self.n_shards - 1:
            nxt[0] += self.box
        return prev, nxt

    def _with_halo(self, *grids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each grid with the neighbours' edge rows attached, ``(rows + 2,
        ...)``, from one exchange (:meth:`_edge_rows`)."""
        prev, nxt = self._edge_rows(*grids)
        return tuple(torch.cat([prev[k : k + 1], g, nxt[k : k + 1]]) for k, g in enumerate(grids))

    def _halo_planes(self, scode: torch.Tensor, fields: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The code grid and the stacked fields with the neighbours' edge
        rows attached, from one exchange (the int32 codes travel as their
        float32 bits beside the fields)."""

        def edge(i):
            return torch.cat([scode[i : i + 1].view(torch.float32)[None], fields[:, i : i + 1]])

        prev, nxt = self.mesh.exchange(edge(0), edge(scode.shape[0] - 1))
        code = torch.cat([prev[0].view(torch.int32), scode, nxt[0].view(torch.int32)])
        return code, torch.cat([prev[1:], fields, nxt[1:]], dim=1)

    def shard_state(self, state):
        """This rank's rows of a state over the whole grid (every rank
        passes the same state; scalars and the noise stream are kept). The
        grids and the 2D engine's count grid are cut along the rows."""
        out = {}
        for name, value in vars(state).items():
            if isinstance(value, torch.Tensor) and value.dim() >= 2:
                if value.shape[0] != self.cps:
                    raise ValueError(f"{name}: expected {self.cps} cell rows, got {value.shape[0]}")
                value = shard_along(self.mesh, value.to(self.device))
            elif isinstance(value, torch.Tensor):
                value = value.to(self.device)
            out[name] = value
        return state.replace(**out)

    def prepare(self, state):
        """A state over the whole grid is sharded; a local one passes."""
        return self.shard_state(state) if state.xg.shape[0] != self.rows_local else state

    def _rebuild(self, s):
        raise NotImplementedError("the sort-based rebuild oracle needs the whole grid: run it on one engine")


class ShardedGridMD(RowSharded, GridMD):
    """``GridMD`` with the cell rows split over ``mesh`` (default: the
    initialised process group, or one rank without one). State lives on
    ``mesh.device``; ``init`` places each rank's rows from the positions
    that every rank builds from the same seed."""

    def __init__(
        self,
        grid_fn: CellGridFn,
        mesh: Optional[RowMesh] = None,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
    ):
        mesh = mesh if mesh is not None else make_mesh()
        super().__init__(
            grid_fn, sigma=sigma, epsilon=epsilon, dt=dt, compensated=compensated,
            rows_per_block=1,  # the halo exchange is per physical cell row
            device=mesh.device,
        )
        self._shard(mesh)
        self.n_blocks = self.rows_local
        self._params = CellForceParams.from_grid(grid_fn, sigma, epsilon)
        self.force_kernel = self._halo_force
        self.energy_kernel = self._halo_energy

    def _halo_force(self, xg: torch.Tensor, yg: torch.Tensor, with_energy: bool = False):
        """B1 halo on this rank's rows, ``(fx, fy)``: the kernel reads the
        exchanged edge rows where they lie, no grid is copied."""
        prev, nxt = self._edge_rows(xg, yg)
        return grid_force_halo_edges(xg, yg, prev[0], prev[1], nxt[0], nxt[1], self._params, with_energy)

    def _halo_energy(self, xg: torch.Tensor, yg: torch.Tensor):
        """B1 halo's energy variant: ``(fx, fy, e, w)`` on this rank's rows."""
        return self._halo_force(xg, yg, with_energy=True)

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        code, ext = self._halo_planes(scode, torch.stack(fields))
        return migrate_halo(code, ext, fills, occ=occ), None

    def force_once(self, s: GridMDState):
        """One sharded force evaluation: this rank's ``(fx, fy)``."""
        return self.force_kernel(s.xg, s.yg)
