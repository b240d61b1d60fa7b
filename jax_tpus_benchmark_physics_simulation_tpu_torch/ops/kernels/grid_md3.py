"""Grid-resident LJ molecular dynamics (3D).

Port of the JAX package's ``ops/kernels/grid_md3.py`` (``GridMD3State``,
``GridMD3``), single device. The windows, drivers, binning, the sort-free
rebuild's allocation over the 27 directions and the observables are the
core it shares with the 2D engine (``grid_engine.py``; read its docstring
first), on the layout ``(ncx, cap, ncy * ncz)`` (R = 1): viewed as
``(ncx, cap, ncy, ncz)`` a (y, z) cell shift is a shift on two axes. What
is 3D's own:

- The force kernels B4/B5 (``cell_cuda3``) and their choice (``GridMD3``'s
  ``static_cov``). ``max_occ``, the largest cell occupancy of the last
  (re)binning, is a 0-d int32 tensor on the device, taken from the
  binning's count grid; B4 (the counted kernel at the capacity's shared
  memory) reads it there through a pointer as its bound.
- The rebuild's migrate kernel: one launch of B6 (``migrate_cuda3``; B7
  with ``migrate_compact=False``) moves the fields from where they lie,
  fills the slots the allocation left empty and raises its mover flag on
  the card when a cell has more than ``migrate_k_mov`` movers, the state in
  which the JAX package's compacted kernel drops particles. B6 here moves
  every particle whatever the count, so the flag loses nothing: the state
  counts the rebuilds it rose in (``mover_flags``, on the device) and keeps
  it out of ``overflow``, which stays for lost or misplaced physics (a
  cell's capacity, a far mover, the skin, pure static mode's bound).
- The partner list (``partner_list``, on by default on the card): the
  first window of at least 2 steps after a (re)binning builds the list of
  each target's partners within the list radius (``cutoff + skin``, widened
  for float32 rounding: ``cell_cuda3.list_radius2``) for the kernel that
  window runs, and the binning's windows call the list form of B5 or B4,
  which tests those partners only. While no particle has moved skin/2
  since the binning (the window's flag), every pair within the cutoff is
  on the list and the forces are the counted loop's bits. One-step
  windows (3D equilibration's gated windows) build none: a list would be
  used once. A target whose partners overflow the list's capacity runs
  the counted loop and is counted in ``list_overflows``, on the device.
  The list lives in the state for one binning: a (re)binning drops it
  (``_binning``), every window counts its steps (``_stepped``), and the
  window that is the last of its binning (the fixed driver's) drops it
  after use.

Host control flow: the JAX package's ``lax.cond``/``while_loop`` drivers
are Python loops here. The gated driver reads ``dmax2`` once per window. In
the hybrid mode (``static_cov="auto"``), the choice between B5 (while
``max_occ <= cov``) and B4 reads ``max_occ`` once per rebuild period.

The row-sharded engine (``parallel/grid_md3_sharded.py``) overrides the
core's sharding hooks. The JAX package's ``_rebuild_migrate_rows`` (its
plain-jnp rebuild oracle) is not ported: ``_rebuild`` is the port's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda3 import (
    LIST_STEPS,
    CellForce3Params,
    PartnerList3,
    build_partner_list3,
    grid_force3,
    list_bound_ok,
    list_capacity,
    list_radius2,
    make_grid_force_kernel3,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_engine import GridEngine, GridState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda3 import migrate3
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(kw_only=True)
class GridMD3State(GridState):
    """All (ncx, cap, ncy*ncz) leaves live on ``GridMD3.device``.
    ``max_occ``, ``mover_flags`` and ``list_overflows`` are 0-d tensors."""

    xg: torch.Tensor
    yg: torch.Tensor
    zg: torch.Tensor
    vxg: torch.Tensor
    vyg: torch.Tensor
    vzg: torch.Tensor
    fxg: torch.Tensor
    fyg: torch.Tensor
    fzg: torch.Tensor
    dispx: torch.Tensor  # displacement since the last rebuild
    dispy: torch.Tensor
    dispz: torch.Tensor
    max_occ: torch.Tensor  # int32 max cell occupancy of the last (re)binning
    mover_flags: torch.Tensor  # int32 rebuilds whose B6 found > migrate_k_mov movers in a cell
    # Kahan compensation residuals (compensated=True)
    crx: Optional[torch.Tensor] = None
    cry: Optional[torch.Tensor] = None
    crz: Optional[torch.Tensor] = None
    cvx: Optional[torch.Tensor] = None
    cvy: Optional[torch.Tensor] = None
    cvz: Optional[torch.Tensor] = None
    # int32 targets whose partners overflowed a partner list's capacity
    # (they ran the counted loop: nothing is lost)
    list_overflows: Optional[torch.Tensor] = None
    plist: Optional[PartnerList3] = None  # the partner list of this binning
    # steps run since the binning (host-side); None: unknown, as in a state
    # that neither init nor a rebuild made, which builds no partner list
    since_binning: Optional[int] = None


class GridMD3(GridEngine):
    """Factory for the 3D grid-resident MD step functions.

    ``static_cov``: the compile-time occupancy bound of kernel B5.
      - None: every window runs B4 (bound ``max_occ``, read on the device).
      - an int: pure static mode. B5 runs every force and energy call, and a
        (re)binning whose ``max_occ`` exceeds it raises ``overflow``.
      - ``"auto"``: hybrid mode (the ``lj_fluid`` 3D default). ``cov`` is
        ``m + 2 sqrt(m)`` rounded up to a multiple of 8 (m the mean cell
        occupancy); windows run B5 while ``max_occ <= cov`` and B4
        otherwise, exactly, with no flag. Energy and virial run B4.
    The TPU's lane and VMEM gates of this choice are not ported: they have
    no counterpart on the card.

    ``partner_list``: whether windows of at least 2 steps run the list form
    (module docstring); None: on the card. ``list_cap`` (an attribute) is
    the entries a target, ``cell_cuda3.list_capacity``'s.
    """

    AXES = ("x", "y", "z")
    State = GridMD3State

    def __init__(
        self,
        grid_fn: CellGridFn,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
        migrate_compact: bool = True,
        migrate_k_mov: int = 16,
        static_cov: Optional[Union[int, str]] = None,
        device="cuda",
        partner_list: Optional[bool] = None,
    ):
        super().__init__(grid_fn, dt, compensated, device)
        self.migrate_compact = migrate_compact
        self.migrate_k_mov = migrate_k_mov
        self._hybrid = static_cov == "auto"
        if self._hybrid:
            m = self.n / float(self.cps**3)
            est = int(math.ceil(m + 2.0 * math.sqrt(max(m, 1.0))))
            static_cov = min(self.cap, _round_up(max(est, 8), 8))
        if static_cov is not None and not 0 < static_cov <= self.cap:
            raise ValueError(f"static_cov {static_cov} must lie in [1, capacity {self.cap}]")
        self.static_cov = static_cov
        kw = dict(sigma=sigma, epsilon=epsilon)
        if self._hybrid:
            self.force_kernel = make_grid_force_kernel3(grid_fn, **kw)
            self.energy_kernel = make_grid_force_kernel3(grid_fn, with_energy=True, **kw)
            self.force_kernel_static = make_grid_force_kernel3(grid_fn, static_cov=static_cov, **kw)
        else:
            self.force_kernel = make_grid_force_kernel3(grid_fn, static_cov=static_cov, **kw)
            self.energy_kernel = make_grid_force_kernel3(
                grid_fn, with_energy=True, static_cov=static_cov, **kw
            )
            self.force_kernel_static = None
        self._params = CellForce3Params.from_grid(grid_fn, sigma, epsilon)
        self.partner_list = self.device.type == "cuda" if partner_list is None else bool(partner_list)
        self.list_r2 = list_radius2(grid_fn.cutoff, self.skin, self.box)
        self.list_cap = list_capacity(self.n, self.box, self.list_r2)

    @property
    def _pure_static(self) -> bool:
        return self.static_cov is not None and not self._hybrid

    def _counters(self) -> dict:
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return dict(mover_flags=zero, list_overflows=zero.clone())

    def _binning(self, counts: torch.Tensor, overflow: torch.Tensor) -> dict:
        """``max_occ`` from the count grid (in pure static mode above
        ``static_cov`` it raises ``overflow``); no partner list yet."""
        max_occ = self._all_max(counts.max())
        if self._pure_static:
            overflow = overflow | (max_occ > self.static_cov)
        return dict(max_occ=max_occ, overflow=overflow, plist=None, since_binning=0)

    def _force_args(self, s: GridMD3State) -> tuple:
        """B4 reads the occupancy bound on the device; it is constant
        between rebuilds (the binning is fixed)."""
        return (s.max_occ,)

    def _stepped(self, s: GridMD3State, n_inner: int) -> dict:
        """The steps run since the binning, which the partner list's
        lifetime reads."""
        return {} if s.since_binning is None else dict(since_binning=s.since_binning + n_inner)

    def _window_for(self, s: GridMD3State, n_inner: int, thermostat=None, last: bool = False):
        """The ``n_inner``-step window for the state's binning. In hybrid
        mode: B5's while ``max_occ <= cov``, else B4's, which costs one
        host read of ``max_occ``; ``max_occ`` only changes at a rebuild, so
        the drivers call this once per rebuild period. With the partner
        list on and ``n_inner >= 2``, the window runs that kernel's list
        form: on a state fresh from its binning it builds the list first
        (the ``md.list`` span), and it falls back to the counted loop where
        the state has no list for its binning or the window would end past
        the list's lifetime (``cell_cuda3.LIST_STEPS``). ``last``: the
        window drops the list after use (a caller holding the state across
        the next rebinning would otherwise keep it beside the next one)."""
        static = self._hybrid and trace.host_read(s.max_occ, int) <= self.static_cov
        window = self._make_window(self.force_kernel_static if static else self.force_kernel, n_inner, thermostat)
        cov = self.static_cov if static or self._pure_static else None
        if not (self.partner_list and n_inner >= 2 and list_bound_ok(cov, self.cap)):
            return window

        def listed(s):
            if s.plist is None and s.since_binning == 0:
                with trace.span("md.list"):
                    plist, full = build_partner_list3(s.xg, s.yg, s.zg, self._params, self.list_r2, self.list_cap,
                                                      s.max_occ, cov, full=s.list_overflows)
                s = s.replace(plist=plist, list_overflows=full)
            if s.plist is None or s.since_binning + n_inner > LIST_STEPS:
                out = window(s)
            else:
                plist = s.plist

                def force(xg, yg, zg, max_occ):
                    return grid_force3(xg, yg, zg, self._params, max_occ, static_cov=cov, plist=plist)

                out = self._make_window(force, n_inner, thermostat)(s)
            return out.replace(plist=None) if last else out

        return listed

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        """B6, or B7 with ``migrate_compact=False``: the planes and the
        mover flag."""
        k_mov = self.migrate_k_mov if self.migrate_compact else None
        return migrate3(scode, fields, fills, k_mov=k_mov, occ=occ)

    def _rebuild_flags(self, s: GridMD3State, overflow: torch.Tensor, mov_of: torch.Tensor) -> dict:
        """One reduction over the ranks for both flags; B6's mover flag adds
        one to ``mover_flags`` and leaves ``overflow`` alone."""
        overflow, mov_of = self._all_max(torch.stack([overflow, mov_of]))
        return dict(overflow=overflow, mover_flags=s.mover_flags + mov_of)
