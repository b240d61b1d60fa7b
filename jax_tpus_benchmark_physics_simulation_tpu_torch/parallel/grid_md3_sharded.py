"""Row-sharded grid-resident LJ MD (3D): spatial domain decomposition.

Port of the JAX package's ``parallel/grid_md3_sharded.py``
(``ShardedGridMD3``): the 2D scheme of ``grid_md_sharded.py`` (read its
docstring first) on the x-rows of the ``(ncx, cap, ncy * ncz)`` layout.

- **Force.** One exchange a step of the edge x-rows of x, y and z, then
  B4 halo (``cell_cuda3.grid_force3_halo``) or, in the hybrid windows of
  ``static_cov="auto"`` while ``max_occ <= cov``, B5 halo. ``max_occ`` is
  reduced with MAX at every (re)binning, so every rank picks the same
  kernel and B4 covers the same slots on every rank.
- **Rebuild.** ``GridMD3._migration_dest3`` on the local x-rows (two
  one-row exchanges of the per-cell counts and bases), then B6 halo
  (``migrate_cuda3.migrate3_halo``) from the local rows with the
  neighbours' whole edge rows attached. B6's mover flag is computed on
  the card from each rank's own source cells and reduced with MAX, so
  ``mover_flags`` counts exactly the rebuilds the unsharded engine counts. JAX compacts each edge
  row to its ``k_mov`` mover planes before the exchange; the port sends
  the rows whole (``csrc/migrate3.cu`` says why).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda3 import grid_force3_halo
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3, GridMD3State
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda3 import migrate3_halo
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import RowSharded
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh, make_mesh


class ShardedGridMD3(RowSharded, GridMD3):
    """``GridMD3`` with the x-rows split over ``mesh`` (default: the
    initialised process group, or one rank without one). ``static_cov`` and
    ``migrate_k_mov`` as in ``GridMD3``; the rebuild is always B6 halo with
    its mover flag (JAX's sharded rebuild requires the compact build)."""

    def __init__(
        self,
        grid_fn: CellGridFn,
        mesh: Optional[RowMesh] = None,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
        migrate_k_mov: int = 16,
        static_cov: Optional[Union[int, str]] = None,
    ):
        mesh = mesh if mesh is not None else make_mesh()
        super().__init__(
            grid_fn, sigma=sigma, epsilon=epsilon, dt=dt, compensated=compensated,
            migrate_compact=True, migrate_k_mov=migrate_k_mov,
            static_cov=static_cov, device=mesh.device, partner_list=False,  # the halo form has no list form
        )
        self._shard(mesh)
        # the kernels GridMD3 chose, in their halo form
        static = None if self._hybrid else self.static_cov
        self.force_kernel = self._halo_kernel(False, static)
        self.energy_kernel = self._halo_kernel(True, static)
        self.force_kernel_static = self._halo_kernel(False, self.static_cov) if self._hybrid else None

    def _halo_kernel(self, with_energy: bool, static_cov: Optional[int]):
        """``(xg, yg, zg, max_occ=None) -> outputs`` of B4 halo, or of B5
        halo with ``static_cov``, on this rank's x-rows."""

        def kernel(xg, yg, zg, max_occ=None):
            return grid_force3_halo(*self._with_halo(xg, yg, zg), self._params, max_occ, with_energy, static_cov)

        return kernel

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        code, ext = self._halo_planes(scode, torch.stack(fields))
        return migrate3_halo(code, ext, fills, k_mov=self.migrate_k_mov, occ=occ)

    def force_once(self, s: GridMD3State):
        """One sharded force evaluation: this rank's ``(fx, fy, fz)``."""
        return self.force_kernel(s.xg, s.yg, s.zg, s.max_occ)
