"""Grid-resident LJ molecular dynamics over its axes: the core that the 2D
engine (``grid_md.GridMD``) and the 3D one (``grid_md3.GridMD3``) share.

Port of the JAX package's ``GridMD`` / ``GridMD3`` machinery, single
device, written once over ``AXES`` (D = ``len(AXES)``). All particle state
(positions, velocities, forces, particle ids, Kahan residuals) lives
permanently in the cell-grid layout ``(cps / R, cap, R * plane)``: the
``plane = cps^(D-1)`` cells of a cell row are flattened into the last
axis, without the TPU's 128-lane padding, and R (``rows_per_block``)
consecutive rows share a block (R > 1 only in 2D's packed layout). Empty
slots hold the x sentinel ``2.5 * box``.

- The velocity-Verlet update runs in leapfrog windows: one force call and
  one elementwise pass per step, half-kick in and half-unkick out at the
  window boundary. In NVE the pass is ``leapfrog_cuda.Leapfrog``: one
  kernel launch a step on the card. ``thermostat=(gamma, kT)`` makes each
  step BAOAB Langevin (NVT): the pass is ``baoab_cuda.Baoab``, one kernel
  launch a step on the card beside one noise launch.
- Positions are not wrapped per step: between rebuilds a particle drifts at
  most skin/2 outside [0, box), which the kernels' per-offset seam handling
  covers. Coordinates are wrapped once per rebuild.
- The skin monitor is one displacement accumulator a axis plus a running
  max of their squared norm, the scalar ``dmax2`` of each window (on the
  card reduced inside the window's kernel).
- The rebuild is sort-free: every particle moves at most one cell between
  rebuilds, so an allocation over the 3^D migration classes
  (``_migration_dest``, ``alloc_cuda``: three kernel passes on the card)
  gives each slot a source-frame code, and one migrate kernel launch (2D:
  B2, 3D: B6) moves the fields. ``_rebuild`` is the sort-based oracle.
- The partner list (``partner_list``, the engine's choice): the first
  window of at least 2 steps after a (re)binning builds the list of each
  target's partners within the list radius (``cutoff + skin``, widened for
  float32 rounding: ``cell_cuda3.list_radius2``) for the force kernel that
  window runs (the ``md.list`` span), and the binning's windows call that
  kernel's list form, which tests those partners only. While no particle
  has moved skin/2 since the binning (the window's flag), every pair
  within the cutoff is on the list and the forces are the counted loop's
  bits. One-step windows build none (a list would be used once), nor does
  a state of unknown binning; a window that would end past the list's
  lifetime (``cell_cuda3.LIST_STEPS``) runs the counted loop. A target
  whose partners overflow the list's capacity runs the counted loop and is
  counted in ``list_overflows``, on the device. The list lives in the
  state for one binning: a (re)binning drops it, every window counts its
  steps (``_stepped``), and a window that is the last of its binning (the
  fixed driver's) drops it after use. The dimension builds the list
  (``_build_list``) and gives its list form (``_list_force``).

Host control flow: the JAX package runs the rebuild gate inside a device
``while_loop``. Here the drivers are Python loops that read the scalar
``dmax2`` once per window, one host sync every ``n_inner`` steps, through
``utils.trace.host_read``, which counts it. Windows and rebuilds are the
``md.window`` and ``md.rebuild`` spans of ``utils/trace.py``, a rebuild's
allocation the ``md.alloc`` span inside it.

Langevin noise: the state carries its stream seed as ``rng_seed`` (None
for NVE) and its global step as ``rng_counter``, both Python ints; every
window advances the step by ``n_inner`` and rebuilds carry it through.
The noise of a step is ``noise_cuda.langevin_noise`` of (seed, step, the
slots' particle ids): a pure function of (seed, global step, particle id,
axis), one kernel launch a step on the card and its plain version on the
CPU, which agree to float32 rounding. So the same state in gives the same
state out, a particle's kicks do not depend on the slot it holds, and a
caller that hands on the step (``lj_fluid``'s phases) draws fresh noise in
every block.

An engine keeps what is its own dimension's in the hooks it overrides:
its kernels and state class, ``_counters`` (the counts ``init`` zeroes),
``_binning`` (what a (re)binning sets from its count grid),
``_force_args``, ``_window_for`` (the window a driver runs),
``_build_list`` and ``_list_force`` (the partner list and its list form),
``_migrate`` and ``_rebuild_flags`` (the migrate kernel and its flags). The
row-sharded engines (``parallel/``) override the sharding hooks below.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.alloc_cuda import allocate
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import SENTINEL_FACTOR
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda3 import LIST_STEPS
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import unpack
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.baoab_cuda import Baoab
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.noise_cuda import langevin_noise
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace

@dataclass(kw_only=True)
class GridState:
    """The leaves every grid state has besides its per-axis grids (``xg``,
    ``vxg``, ``fxg``, ``dispx``, and with Kahan compensation ``crx`` and
    ``cvx``, for each axis). ``dmax2``, ``overflow`` and ``time`` are 0-d
    tensors; ``rng_seed`` the Langevin noise stream's seed and
    ``rng_counter`` the global step (module docstring), which rebuilds
    carry through."""

    occ: torch.Tensor  # float 1.0/0.0
    pid: torch.Tensor  # int32 particle id, sentinel -1
    dmax2: torch.Tensor  # running max of |disp|^2 since the rebuild
    overflow: torch.Tensor  # bool
    time: torch.Tensor
    rng_seed: Optional[int] = None
    rng_counter: int = 0  # the global step of the state
    # int32 targets whose partners overflowed a partner list's capacity
    # (they ran the counted loop: nothing is lost)
    list_overflows: Optional[torch.Tensor] = None
    plist: Optional[object] = None  # the partner list of this binning
    # steps run since the binning (host-side); None: unknown, as in a state
    # that neither init nor a rebuild made, which builds no partner list
    since_binning: Optional[int] = None

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


class GridEngine:
    """Factory for the grid-resident MD step functions over ``AXES``. State
    lives on ``device``: the card unless the caller asks for the CPU."""

    AXES: Tuple[str, ...]
    State: type
    partner_list = False  # whether windows of 2+ steps run the list form

    def __init__(self, grid_fn: CellGridFn, dt: float, compensated: bool, device, rows_per_block: int = 1):
        d = len(self.AXES)
        if grid_fn.dim != d:
            raise ValueError(f"{type(self).__name__} is {d}D")
        if grid_fn.n >= (1 << 24):
            raise ValueError("particle ids ride the rebuild as float32: n must be < 2^24")
        self.compensated = compensated
        self.grid_fn = grid_fn
        self.cps = grid_fn.cells_per_side
        self.cap = grid_fn.capacity
        self.box = grid_fn.box
        self.skin = grid_fn.skin
        self.n = grid_fn.n
        self.dt = dt
        self.device = torch.device(device)
        self.sentinel = SENTINEL_FACTOR * float(grid_fn.box)
        if rows_per_block < 1 or self.cps % rows_per_block:
            raise ValueError(f"rows_per_block {rows_per_block} must divide cells_per_side {self.cps}")
        self.rows_per_block = rows_per_block
        self.plane = self.cps ** (d - 1)
        self.n_blocks = self.cps // rows_per_block
        self.lanes = rows_per_block * self.plane
        self.grid_shape = (self.n_blocks, self.cap, self.lanes)
        self.size = self.n_blocks * self.cap * self.lanes

    # -- hooks that the row-sharded engines (parallel/) override: here one
    # engine holds every cell row ---------------------------------------------
    _row0 = 0  # global index of the first cell row held

    @property
    def n_rows(self) -> int:
        """Cell rows held (the unpacked view's)."""
        return self.cps

    def _held(self, slot: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(slots, ids)`` of the particles placed here, from their global
        flat slots: all of them (``ids`` None)."""
        return slot, None

    @staticmethod
    def _row_ext(t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` with one row more at each end along ``dim``: the periodic
        neighbours of its first and last row."""
        n = t.shape[dim]
        return torch.cat([t.narrow(dim, n - 1, 1), t, t.narrow(dim, 0, 1)], dim)

    @staticmethod
    def _all_max(t: torch.Tensor) -> torch.Tensor:
        """Max over the engine's ranks (one here)."""
        return t

    _all_sum = _all_max  # sum over the engine's ranks

    _gather_rows = _all_max  # every rank's rows, concatenated

    # -- hooks of the dimension -------------------------------------------------
    def _counters(self) -> dict:
        """The state's counters, zeroed by ``init``."""
        return dict(list_overflows=torch.zeros((), dtype=torch.int32, device=self.device))

    def _binning(self, counts: torch.Tensor, overflow: torch.Tensor) -> dict:
        """The fields a (re)binning sets from its ``(rows, plane)`` int32
        count grid, ``overflow`` among them."""
        raise NotImplementedError

    def _force_args(self, s) -> tuple:
        """Arguments the force kernel takes after the coordinates."""
        return ()

    def _stepped(self, s, n_inner: int) -> dict:
        """The fields a window of ``n_inner`` steps advances besides the
        grids: the steps run since the binning, which the partner list's
        lifetime reads."""
        return {} if s.since_binning is None else dict(since_binning=s.since_binning + n_inner)

    def _window_for(self, s, n_inner: int, thermostat=None, last: bool = False):
        """The ``n_inner``-step window a driver runs on ``s``; ``last``: the
        last window of its binning."""
        return self._listed_window(self.force_kernel, None, n_inner, thermostat, last)

    def _build_list(self, s, bound):
        """``(list, list_overflows)``: the partner list of the state's
        binning for the force kernel at ``bound`` (what ``_window_for``
        chose), the state's count of full targets advanced."""
        raise NotImplementedError

    def _list_force(self, plist, bound):
        """The list form of the force kernel at ``bound`` on ``plist``,
        called as the force kernel is."""
        raise NotImplementedError

    def _listed_window(self, force_fn, bound, n_inner: int, thermostat=None, last: bool = False):
        """The window of ``force_fn`` (the force kernel at ``bound``), or,
        with the partner list on and ``n_inner >= 2``, one that runs its
        list form: on a state fresh from its binning it builds the list
        first (the ``md.list`` span), and it falls back to ``force_fn``
        where the state has no list for its binning or the window would end
        past the list's lifetime (``LIST_STEPS``). ``last``: the window
        drops the list after use (a caller holding the state across the
        next rebinning would otherwise keep it beside the next one)."""
        window = self._make_window(force_fn, n_inner, thermostat)
        if not (self.partner_list and n_inner >= 2):
            return window

        def listed(s):
            if s.plist is None and s.since_binning == 0:
                with trace.span("md.list"):
                    plist, full = self._build_list(s, bound)
                s = s.replace(plist=plist, list_overflows=full)
            if s.plist is None or s.since_binning + n_inner > LIST_STEPS:
                out = window(s)
            else:
                out = self._make_window(self._list_force(s.plist, bound), n_inner, thermostat)(s)
            return out.replace(plist=None) if last else out

        return listed

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        """The rebuild's permutation of the field planes, ``(planes,
        flag)``: ``occ`` is the allocation's occupancy of the output,
        ``flag`` what the kernel reports besides (None)."""
        raise NotImplementedError

    def _rebuild_flags(self, s, overflow: torch.Tensor, flag) -> dict:
        """The flags a migration rebuild sets, reduced over the ranks."""
        return dict(overflow=self._all_max(overflow))

    # -- binning -----------------------------------------------------------------
    def _grid_slot(self, cx: torch.Tensor, a: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        """Flat slot of slot ``a`` of the cell in row ``cx``, column ``col``
        of its plane, in the state's layout."""
        r = self.rows_per_block
        return (torch.div(cx, r, rounding_mode="floor") * self.cap + a) * self.lanes + (cx % r) * self.plane + col

    def _cell_ids(self, coords) -> torch.Tensor:
        """Flat cell id (row-major over ``AXES``) of wrapped coordinates."""
        ids = None
        for v in coords:
            c = torch.div(v, self.box / self.cps, rounding_mode="floor").to(torch.int32).clamp(0, self.cps - 1)
            ids = c if ids is None else ids * self.cps + c
        return ids

    def _slot(self, position: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat grid slot for each particle + overflow flag. Particles of a
        cell take slots in particle order (stable sort), as in the JAX
        package."""
        cap = self.cap
        ids = self._cell_ids(position.unbind(1))
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device) - seg.to(torch.int32)
        overflow = torch.any(rank >= cap)
        rank = rank.clamp(max=cap - 1)
        slot = torch.empty_like(ids)
        slot[order] = sorted_ids * cap + rank  # (cell, a) flat
        cell_id = torch.div(slot, cap, rounding_mode="floor")
        cx = torch.div(cell_id, self.plane, rounding_mode="floor")
        return self._grid_slot(cx, slot % cap, cell_id % self.plane).long(), overflow

    def _counts(self, occ: torch.Tensor) -> torch.Tensor:
        """The ``(rows, plane)`` int32 count grid of an occupancy grid."""
        return (unpack(occ, self.rows_per_block) > 0.5).sum(1, dtype=torch.int32)

    def prepare(self, state):
        """Placement hook (parity with the JAX package's ``prepare``)."""
        return state

    def init(self, position: torch.Tensor, velocity: torch.Tensor, seed: Optional[int] = None, step: int = 0):
        """``seed`` arms the state's noise stream, which Langevin windows
        need and NVE ones ignore; ``step`` is the global step of the state
        (its noise's counter)."""
        position = position.to(self.device)
        velocity = velocity.to(self.device)
        slot, overflow = self._slot(position)
        slot, ids = self._held(slot)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = torch.full((self.size,), fill, dtype=dtype, device=self.device)
            z[slot] = v if ids is None else v[ids]
            return z.view(self.grid_shape)

        axes = self.AXES
        fields = {f"{a}g": put(position[:, k], fill=self.sentinel if k == 0 else 0.0) for k, a in enumerate(axes)}
        fields.update({f"v{a}g": put(velocity[:, k]) for k, a in enumerate(axes)})
        occ = put(torch.ones(self.n, dtype=dtype, device=self.device))
        pid = torch.full((self.size,), -1, dtype=torch.int32, device=self.device)
        pid[slot] = torch.arange(self.n, dtype=torch.int32, device=self.device) if ids is None else ids.to(torch.int32)
        if self.compensated:
            fields.update({f"{r}{a}": torch.zeros(self.grid_shape, dtype=dtype, device=self.device)
                           for r in ("cr", "cv") for a in axes})
        zero = torch.zeros((), dtype=dtype, device=self.device)
        s = self.State(
            **fields, **{f"f{a}g": None for a in axes}, **{f"disp{a}": torch.zeros_like(occ) for a in axes},
            occ=occ, pid=pid.view(self.grid_shape), dmax2=zero, time=zero.clone(), rng_seed=seed,
            rng_counter=step, since_binning=0, **self._counters(), **self._binning(self._counts(occ), overflow),
        )
        f = self.force_kernel(*(fields[f"{a}g"] for a in axes), *self._force_args(s))
        return s.replace(**{f"f{a}g": fa for a, fa in zip(axes, f)})

    # -- migration rebuild (sort-free) ----------------------------------------
    def _migration_dest(self, s):
        """Allocation phase of the rebuild (``alloc_cuda.allocate``: three
        kernel passes on the card, the eager PyTorch allocation on the CPU).
        Returns the wrapped coordinates (one grid an axis), the source-frame
        code grid ``dcode * cap + target_a`` (-1 where empty or invalid) that
        the migrate kernel consumes, the post-rebuild occupancy grid, the
        overflow flag and the post-rebuild count grid (``(rows, plane)``
        int32; the occupancy grid is 1 on exactly the slots below the count
        of their cell), all in the state's layout. Every particle gets the
        cell and slot the JAX package's allocation gives it.

        The per-cell counts and bases read one row past each end through
        ``_row_ext``: the periodic neighbour rows here, the neighbour ranks'
        rows in the row-sharded engines, whose ``_row0`` also offsets the
        row index."""
        return allocate([getattr(s, f"{a}g") for a in self.AXES], s.occ, s.overflow, cps=self.cps, box=self.box,
                        rows_per_block=self.rows_per_block, row0=self._row0, row_ext=self._row_ext)

    def _moved(self, s) -> Tuple[list, list]:
        """Names of the fields a rebuild moves, positions first, in the
        migrate kernel's plane order, and the value each leaves in an empty
        slot (x the sentinel, pid -1)."""
        names = [f"{f}{a}g" for f in ("", "v", "f") for a in self.AXES] + ["pid"]
        if s.crx is not None:
            names += [f"{r}{a}" for r in ("cr", "cv") for a in self.AXES]
        return names, [self.sentinel if k == "xg" else -1.0 if k == "pid" else 0.0 for k in names]

    def _rebuilt(self, s, planes, **changes):
        """``s`` after a rebinning: the moved planes, the displacement
        monitor reset."""
        out = dict(zip(self._moved(s)[0], planes))
        out["pid"] = out["pid"].to(torch.int32)
        zeros = torch.zeros_like(s.xg)
        out.update({f"disp{a}": zeros for a in self.AXES})
        return s.replace(**out, dmax2=torch.zeros_like(s.dmax2), plist=None, since_binning=0, **changes)

    def _rebuild_migrate(self, s):
        """Sort-free re-binning: the allocation (the ``md.alloc`` span),
        then one migrate launch that moves every field
        from where it lies and fills the slots the allocation leaves empty.
        A particle that moved further than one cell raises ``overflow`` and
        is kept in place; so does a cell over its capacity.
        Coordinates are wrapped back into [0, box) here, the only place
        they ever are, and empty slots are re-filled with the sentinel."""
        with trace.span("md.rebuild"):
            with trace.span("md.alloc"):
                *wrapped, scode, occ, overflow, counts = self._migration_dest(s)
                binning = self._binning(counts, overflow)
            names, fills = self._moved(s)
            fields = wrapped + [s.pid.to(s.xg.dtype) if k == "pid" else getattr(s, k) for k in names[len(wrapped):]]
            planes, flag = self._migrate(scode, fields, fills, occ)
            binning.update(self._rebuild_flags(s, binning["overflow"], flag))
            return self._rebuilt(s, planes, occ=occ, **binning)

    # -- rebuild (sort-based oracle) -------------------------------------------
    def _rebuild(self, s):
        """Re-binning by a stable sort of cell ids (the JAX package's
        oracle): correct for any displacement, so it checks the sort-free
        rebuild. Overflows a cell's capacity loudly."""
        cap = self.cap
        dev = s.xg.device
        occ = s.occ.reshape(-1)
        wrapped = [torch.remainder(getattr(s, f"{a}g"), self.box).reshape(-1) for a in self.AXES]
        n_cells = self.cps ** len(self.AXES)
        ids = torch.where(occ > 0.5, self._cell_ids(wrapped), n_cells)  # empties last
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(self.size, dtype=torch.int32, device=dev) - seg.to(torch.int32)
        real = sorted_ids < n_cells
        overflow = s.overflow | torch.any(real & (rank >= cap))
        rank = rank.clamp(max=cap - 1)
        cx = torch.div(sorted_ids, self.plane, rounding_mode="floor")
        new_slot = self._grid_slot(cx, rank, sorted_ids % self.plane)
        new_slot = torch.where(real, new_slot, self.size).long()  # empties to a dropped slot

        def scat(v, fill=0.0):
            out = torch.full((self.size + 1,), fill, dtype=v.dtype, device=dev)
            out[new_slot] = v.reshape(-1)[order]
            return out[: self.size].view(self.grid_shape)

        names, fills = self._moved(s)
        fields = wrapped + [getattr(s, k) for k in names[len(wrapped):]]
        planes = [scat(v, fill) for v, fill in zip(fields, fills)]
        occ_new = scat(s.occ)
        return self._rebuilt(s, planes, occ=occ_new, **self._binning(self._counts(occ_new), overflow))

    def _needs_rebuild(self, s, frac: float = 0.5) -> torch.Tensor:
        """Gate on the scalar displacement max kept by the windows. NaN-safe:
        a NaN ``dmax2`` asks for a rebuild."""
        return ~(s.dmax2 <= (frac * self.skin) ** 2)

    # -- MD step ---------------------------------------------------------------
    def _make_window(self, force_fn, n_inner: int, thermostat=None):
        """Leapfrog window: ``window(s) -> s`` advancing ``n_inner`` >= 1
        velocity-Verlet steps with one force call per step, over the
        engine's ``AXES``. If any particle's displacement since the rebuild
        exceeded skin/2 mid-window, the state's ``overflow`` flag is raised
        (NaN-safe: ``~(NaN <= t)`` is True).

        NVE: the kick, drift, Kahan residuals and displacement max of each
        step are one :class:`~.leapfrog_cuda.Leapfrog` pass (on the card one
        kernel launch a step and one a window; on the CPU its plain
        version), the window's ``dmax2`` one scalar.

        ``thermostat=(gamma, kT)`` makes each step BAOAB Langevin (NVT): the
        exact Ornstein-Uhlenbeck map ``vh <- c1*vh + c2*xi`` between two
        half-drifts, ``c1 = exp(-gamma*dt)``, ``c2 = sqrt(kT*(1-c1^2))``
        (unit mass), still one force call a step. A step's kick, refresh,
        drifts, Kahan position residuals and displacement max are one
        :class:`~.baoab_cuda.Baoab` pass (as NVE's: a launch a step and one
        a window on the card, the plain version on the CPU) beside one
        noise launch a step (``noise_cuda.langevin_noise`` at the step's
        global index, keyed by the slots' particle ids). The noise is
        exactly 0 in empty slots, so they stay exactly at rest; velocity
        Kahan compensation is bypassed (the OU map rescales vh). A state
        without a noise stream raises ``ValueError``."""
        dt = self.dt
        comp = bool(self.compensated)
        axes = self.AXES

        def finish(s, dmax2, pos, v, f, disp, **res):
            """The window's end state: ``res`` the residual planes it wrote."""
            dmax2 = self._all_max(dmax2)
            violation = ~(dmax2 <= (0.5 * self.skin) ** 2)
            out = dict(dmax2=dmax2, overflow=s.overflow | violation, time=s.time + n_inner * dt,
                       rng_counter=s.rng_counter + n_inner)
            for k, a in enumerate(axes):
                out.update({f"{a}g": pos[k], f"v{a}g": v[k], f"f{a}g": f[k], f"disp{a}": disp[k]})
                out.update({f"{r}{a}": planes[k] for r, planes in res.items()})
            return s.replace(**out, **self._stepped(s, n_inner))

        def nve(s):
            extra = self._force_args(s)
            res = {}
            if comp:
                res = {r: [getattr(s, f"{r}{a}") for a in axes] for r in ("cr", "cv")}
            lf = Leapfrog([getattr(s, f"v{a}g") for a in axes], [getattr(s, f"{a}g") for a in axes],
                          [getattr(s, f"disp{a}") for a in axes], **res, dt=dt)
            f = [getattr(s, f"f{a}g") for a in axes]
            for _ in range(n_inner):
                lf.step(f)
                f = list(force_fn(*lf.pos, *extra))
            lf.close(f)
            res = dict(cr=lf.cr, cv=lf.cv) if comp else {}
            return finish(s, lf.dmax2, lf.pos, lf.v, f, lf.disp, **res)

        if thermostat is not None:
            gamma, kt_target = thermostat
            c1 = float(math.exp(-gamma * dt))
            c2 = float(math.sqrt(kt_target * (1.0 - c1 * c1)))

        def langevin(s):
            if s.rng_seed is None:
                raise ValueError("Langevin window needs a PRNG stream: init(..., seed=...)")
            extra = self._force_args(s)
            bo = Baoab([getattr(s, f"v{a}g") for a in axes], [getattr(s, f"{a}g") for a in axes],
                       [getattr(s, f"disp{a}") for a in axes], [getattr(s, f"cr{a}") for a in axes] if comp else None,
                       dt=dt, c1=c1, c2=c2)
            f = [getattr(s, f"f{a}g") for a in axes]
            for i in range(n_inner):
                xi = langevin_noise(s.rng_seed, s.rng_counter + i, s.pid, len(axes), s.xg.dtype)
                bo.step(f, xi)
                f = list(force_fn(*bo.pos, *extra))
            bo.close(f)
            res = dict(cr=bo.cr) if comp else {}
            return finish(s, bo.dmax2, bo.pos, bo.v, f, bo.disp, **res)

        window = nve if thermostat is None else langevin

        def traced(s):
            with trace.span("md.window"):
                return window(s)

        return traced

    # -- drivers ---------------------------------------------------------------
    def step_nocheck(self, s):
        """One velocity-Verlet step with no rebuild logic. Only valid inside
        rebuild-gated windows; prefer the drivers below for long runs."""
        return self._make_window(self.force_kernel, 1)(s)

    def step(self, s):
        """One step with a displacement-gated rebuild before it (one host
        read of ``dmax2``). Correct for any dt."""
        if trace.host_read(self._needs_rebuild(s), bool):
            s = self._rebuild_migrate(s)
        return self.step_nocheck(s)

    def make_chunk_step(self, n_inner: int, gate_frac: float = 0.25, thermostat=None):
        """``chunk(s) -> s``: a rebuild if the gate trips (one host read of
        ``dmax2``), then an ``n_inner``-step window. Size ``n_inner`` with
        :meth:`auto_chunk_params` for the same ``gate_frac``: the window
        must fit in the remaining ``(1/2 - gate_frac)`` skin margin.
        ``thermostat=(gamma, kT)`` makes the windows BAOAB Langevin."""

        def chunk(s):
            if trace.host_read(self._needs_rebuild(s, frac=gate_frac), bool):
                s = self._rebuild_migrate(s)
            return self._window_for(s, n_inner, thermostat)(s)

        return chunk

    def make_production_run(self, n_steps: int, n_inner: int, gate_frac: float = 0.25, thermostat=None):
        """``run(s) -> s`` advancing exactly ``n_steps`` (``n_inner`` must
        divide it): windows run until the rebuild gate trips, checked
        between windows with one host read of ``dmax2``; then a rebuild, and
        again. The window is chosen once per rebuild period. The same
        windows, gate cadence and rebuilds as the JAX package's nested
        ``while_loop``, including one trailing rebuild."""
        if n_steps % n_inner:
            raise ValueError(f"n_inner {n_inner} must divide n_steps {n_steps}")

        def run(s):
            done = 0
            while done < n_steps:
                window = self._window_for(s, n_inner, thermostat)
                while done < n_steps and not trace.host_read(self._needs_rebuild(s, frac=gate_frac), bool):
                    s = window(s)
                    done += n_inner
                # the binning's partner list goes before the next binning's
                # rebuild allocates
                s = s.replace(plist=None)
                s = self._rebuild_migrate(s)
            return s

        return run

    def make_production_run_fixed(self, n_steps: int, cadence: int, thermostat=None):
        """Fixed-cadence driver: ``rebuild -> cadence-step window`` blocks,
        with no gate read; ``n_steps % cadence`` trailing steps run as one
        remainder block. NVE only. Safety rests on the window's skin/2
        violation flag: a cadence too long for the actual temperature raises
        ``overflow``, never loses pairs silently. Size it with
        :meth:`auto_cadence`, on equilibrated states only. Each window is
        the last of its binning."""
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        if thermostat is not None:
            raise ValueError("the fixed-cadence driver is NVE-only: Langevin runs use the gated drivers")
        nb, rem = divmod(n_steps, cadence)

        def run(s):
            for n in [cadence] * nb + [rem] * bool(rem):
                s = self._rebuild_migrate(s)
                s = self._window_for(s, n, last=True)(s)
            return s

        return run

    def auto_cadence(self, kt: float = 1.0, n_steps: int = 100_000) -> int:
        """Rebuild cadence for :meth:`make_production_run_fixed`: the fastest
        one-axis speed among ``N * n_steps`` Gaussian samples,
        ``sqrt(2 ln(N n_steps) kT)``, may drift at most ``0.5 * skin`` (with
        a 7% buffer) between rebuilds. The JAX package's rule."""
        samples = max(float(self.n) * max(n_steps, 1), math.e)
        vmax = math.sqrt(2.0 * math.log(samples)) * kt**0.5
        return max(1, int(0.93 * 0.5 * self.skin / (vmax * self.dt)))

    def auto_chunk_params(self, kt: float = 1.0) -> Tuple[int, float]:
        """``(n_inner, gate_frac)`` sized together: the highest rebuild gate
        whose remaining window budget still fits >= 1 step at the 8-sigma
        tail speed. The gate values are the JAX package's, tuned on a TPU;
        their retuning for the H100 is open (ROADMAP.md). Falls back toward
        0.25 for large dt where the margin cannot fit one step."""
        prefer = 0.40 if self.n >= 50_000 else 0.35
        for gate in (0.45, 0.4, 0.35, 0.3, 0.25):
            if gate > prefer:
                continue
            k = int(((0.5 - gate) * self.skin) / (8.0 * kt**0.5 * self.dt))
            if k >= 1:
                return k, gate
        return 1, 0.25

    def auto_inner_steps(
        self, kt: float = 1.0, vmax_sigmas: float = 8.0, gate_frac: float = 0.25
    ) -> int:
        """Window length with ``v_tail * dt * k < (1/2 - gate_frac) * skin``
        for the ``vmax_sigmas``-sigma tail of the Maxwell distribution."""
        vmax = vmax_sigmas * kt**0.5
        k = int(((0.5 - gate_frac) * self.skin) / (vmax * self.dt))
        return max(1, k)

    # -- observables / export ---------------------------------------------------
    def kinetic_energy(self, s) -> torch.Tensor:
        v2 = None
        for a in self.AXES:
            t = getattr(s, f"v{a}g") ** 2
            v2 = t if v2 is None else v2 + t
        return self._all_sum(0.5 * torch.sum(v2 * s.occ))

    def potential_energy(self, s) -> torch.Tensor:
        """One energy-kernel pass. Each pair's shifted LJ energy is counted
        on both partners, hence the 0.5."""
        e = self.energy_kernel(*self._coords(s), *self._force_args(s))[len(self.AXES)]
        return self._all_sum(0.5 * torch.sum(e))

    def virial(self, s) -> torch.Tensor:
        """Pair virial ``W = sum_pairs 24*eps*(2(s/r)^12 - (s/r)^6)`` from
        the energy-kernel pass (each pair on both partners, hence 0.5)."""
        w = self.energy_kernel(*self._coords(s), *self._force_args(s))[len(self.AXES) + 1]
        return self._all_sum(0.5 * torch.sum(w))

    def pressure(self, s) -> torch.Tensor:
        """Instantaneous virial pressure ``P = (2*KE + W) / (D * V)``."""
        d = len(self.AXES)
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (d * self.box**d)

    def _coords(self, s) -> list:
        return [getattr(s, f"{a}g") for a in self.AXES]

    def particle_order(self, s, *grids: torch.Tensor) -> torch.Tensor:
        """(N, len(grids)) values of the grids in particle order."""
        pid = self._gather_rows(s.pid).reshape(-1)
        tgt = torch.where(pid >= 0, pid, self.n).long()
        out = torch.zeros((self.n + 1, len(grids)), dtype=grids[0].dtype, device=grids[0].device)
        out[tgt] = torch.stack([self._gather_rows(g).reshape(-1) for g in grids], dim=1)
        return out[: self.n]

    def positions(self, s) -> torch.Tensor:
        """(N, D) positions in particle order, wrapped into [0, box)."""
        return torch.remainder(self.particle_order(s, *self._coords(s)), self.box)

    def velocities(self, s) -> torch.Tensor:
        return self.particle_order(s, *(getattr(s, f"v{a}g") for a in self.AXES))

    def forces(self, s) -> torch.Tensor:
        """(N, D) total forces in particle order."""
        return self.particle_order(s, *(getattr(s, f"f{a}g") for a in self.AXES))
