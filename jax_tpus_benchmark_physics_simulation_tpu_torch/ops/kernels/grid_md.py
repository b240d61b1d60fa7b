"""Grid-resident LJ molecular dynamics (2D), the port's main path.

Port of the JAX package's ``ops/kernels/grid_md.py`` (``GridMDState``,
``GridMD``), single device. All particle state (positions, velocities,
forces, particle ids, Kahan residuals) lives permanently in the cell-grid
layout ``(cps / R, cap, R * cps)``: R (``rows_per_block``) consecutive cell
rows share a block, slot ``(g, a, lane)`` holds slot ``a`` of cell
``(g * R + lane // cps, lane % cps)``. R = 1 is the unpacked layout of force
kernel B1 (``cell_cuda``), R > 1 the packed layout of B3
(``cell_cuda_packed``); R defaults to the JAX package's
``choose_rows_per_block``, without its 128-lane padding. Empty slots hold
the x sentinel ``2.5 * box``.

- The velocity-Verlet update runs in leapfrog windows: one force call and
  one elementwise pass per step, half-kick in and half-unkick out at the
  window boundary. In NVE the pass is ``leapfrog_cuda.Leapfrog``: one
  kernel launch a step on the card. ``thermostat=(gamma, kT)`` makes each
  step BAOAB Langevin (NVT), in eager PyTorch.
- Positions are not wrapped per step: between rebuilds a particle drifts at
  most skin/2 outside [0, box), which the kernel's per-offset seam handling
  covers. Coordinates are wrapped once per rebuild.
- The skin monitor is a pair of displacement accumulators plus a running
  max of their squared norm, the scalar ``dmax2`` of each window (on the
  card reduced inside the window's kernel).
- The rebuild is sort-free: every particle moves at most one cell between
  rebuilds, so an allocation in plain PyTorch (``_migration_dest``) gives
  each slot a source-frame code, and kernel B2 (``migrate_cuda``) moves the
  fields. ``_rebuild`` is the sort-based oracle.

Host control flow: the JAX package runs the rebuild gate inside a device
``while_loop``. Here the drivers are Python loops that read the scalar
``dmax2`` once per window, one host sync every ``n_inner`` steps, through
``utils.trace.host_read``, which counts it. Windows and rebuilds are the
``md.window`` and ``md.rebuild`` spans of ``utils/trace.py``, a rebuild's
allocation the ``md.alloc`` span inside it.

Langevin noise: the state carries its stream as ``rng_seed`` (None for NVE)
and ``rng_counter``, both Python ints. Each window seeds one
``torch.Generator`` on the state's device from the pair, draws a
``(d,) + grid`` normal block per step, and advances the counter by
``n_inner``: the same state in gives the same state out, as with the JAX
package's folded keys. The CPU generator (mt19937) and the card's (Philox)
give different numbers, so Langevin runs on the card and on the CPU agree
only in distribution.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import (
    SENTINEL_FACTOR,
    make_grid_force_kernel,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import (
    choose_rows_per_block,
    make_grid_force_kernel_packed,
    pack,
    unpack,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import migrate
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace

# the 9 migration directions, in the class order of the allocation
_DIRS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

_MASK64 = (1 << 64) - 1


def _stream_seed(seed: int, counter: int) -> int:
    """One 64-bit generator seed from (seed, counter), mixed by SplitMix64
    so that every bit of both reaches the low 32 bits (all that the CPU's
    mt19937 reads)."""
    z = (((seed & 0xFFFFFFFF) << 32) + (counter & 0xFFFFFFFF) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def kadd(x, c, inc):
    """Kahan-compensated ``x += inc`` with residual ``c``. Kept as separate
    eager ops: an algebraic simplification would cancel the residual."""
    y = inc - c
    t = x + y
    c = (t - x) - y
    return t, c


def sumsq(v):
    """``v[0]^2 + v[1]^2 (+ v[2]^2)``, as separate eager ops."""
    out = v[0] * v[0]
    for t in v[1:]:
        out = out + t * t
    return out


@dataclass
class GridMDState:
    """All (cps/R, cap, R*cps) leaves live on ``GridMD.device``.

    ``fxg/fyg`` hold the total force. ``dispx/dispy`` accumulate per-slot
    displacement since the last rebuild (the Verlet-skin monitor).
    ``dmax2``, ``overflow`` and ``time`` are 0-d tensors. ``rng_seed`` and
    ``rng_counter`` are the Langevin noise stream (see the module
    docstring); rebuilds carry them through. ``counts`` is the ``(rows,
    cps)`` int32 number of particles of each cell, made at ``init`` and at
    each rebuild: a cell's particles hold its slots ``0 .. count-1`` until
    the next rebuild. Kernel B3 (R > 1) takes it.
    """

    xg: torch.Tensor
    yg: torch.Tensor
    vxg: torch.Tensor
    vyg: torch.Tensor
    fxg: torch.Tensor
    fyg: torch.Tensor
    occ: torch.Tensor  # float 1.0/0.0
    pid: torch.Tensor  # int32 particle id, sentinel -1
    dispx: torch.Tensor
    dispy: torch.Tensor
    dmax2: torch.Tensor  # running max of dispx^2+dispy^2 since rebuild
    overflow: torch.Tensor  # bool
    time: torch.Tensor
    # Kahan compensation residuals (compensated=True)
    crx: Optional[torch.Tensor] = None
    cry: Optional[torch.Tensor] = None
    cvx: Optional[torch.Tensor] = None
    cvy: Optional[torch.Tensor] = None
    rng_seed: Optional[int] = None
    rng_counter: int = 0
    counts: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "GridMDState":
        return dataclasses.replace(self, **changes)


class GridMD:
    """Factory for the grid-resident MD step functions. State lives on
    ``device``: the card unless the caller asks for the CPU.

    ``rows_per_block``: R, which must divide the cells per side; None takes
    the JAX package's default, ``choose_rows_per_block(cps)``.
    """

    AXES = ("x", "y")

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
        if grid_fn.dim != 2:
            raise ValueError("grid-resident MD is 2D")
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
        if rows_per_block is None:
            rows_per_block = choose_rows_per_block(self.cps)
        if rows_per_block < 1 or self.cps % rows_per_block:
            raise ValueError(f"rows_per_block {rows_per_block} must divide cells_per_side {self.cps}")
        self.rows_per_block = rows_per_block
        self.n_blocks = self.cps // rows_per_block
        self.lanes = rows_per_block * self.cps
        self.grid_shape = (self.n_blocks, self.cap, self.lanes)
        self.size = self.n_blocks * self.cap * self.lanes
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

    # -- hooks that the row-sharded engine (parallel/grid_md_sharded.py)
    # overrides: here one engine holds every cell row ----------------------
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

    @staticmethod
    def _noise_seed(s) -> int:
        """The seed of a Langevin window's generator."""
        return _stream_seed(s.rng_seed, s.rng_counter)

    # -- layout helpers ------------------------------------------------------
    def _slot2(self, position: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat grid slot for each particle + overflow flag. Particles of a
        cell take slots in particle order (stable sort), as in the JAX
        package."""
        cps, cap, r = self.cps, self.cap, self.rows_per_block
        coords = torch.div(position, self.box / cps, rounding_mode="floor")
        coords = coords.to(torch.int32).clamp(0, cps - 1)
        ids = coords[:, 0] * cps + coords[:, 1]
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device) - seg.to(torch.int32)
        overflow = torch.any(rank >= cap)
        rank = rank.clamp(max=cap - 1)
        slot = torch.empty_like(ids)
        slot[order] = sorted_ids * cap + rank  # (cell, a) flat
        cell_id = torch.div(slot, cap, rounding_mode="floor")
        aa = slot % cap
        cx = torch.div(cell_id, cps, rounding_mode="floor")
        cy = cell_id % cps
        lane = (cx % r) * cps + cy
        return ((torch.div(cx, r, rounding_mode="floor") * cap + aa) * self.lanes + lane).long(), overflow

    def prepare(self, state: GridMDState) -> GridMDState:
        """Placement hook (parity with the JAX package's ``prepare``)."""
        return state

    def _counts(self, occ: torch.Tensor) -> torch.Tensor:
        """The ``(rows, cps)`` int32 count grid of an occupancy grid."""
        return (unpack(occ, self.rows_per_block) > 0.5).sum(1, dtype=torch.int32)

    def init(self, position: torch.Tensor, velocity: torch.Tensor, seed: Optional[int] = None) -> GridMDState:
        """``seed`` arms the state's noise stream, which Langevin windows
        need and NVE ones ignore."""
        position = position.to(self.device)
        velocity = velocity.to(self.device)
        slot2, overflow = self._slot2(position)
        slot2, ids = self._held(slot2)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = torch.full((self.size,), fill, dtype=dtype, device=self.device)
            z[slot2] = v if ids is None else v[ids]
            return z.view(self.grid_shape)

        xg = put(position[:, 0], fill=self.sentinel)
        yg = put(position[:, 1])
        vxg, vyg = put(velocity[:, 0]), put(velocity[:, 1])
        occ = put(torch.ones(self.n, dtype=dtype, device=self.device))
        pid = torch.full((self.size,), -1, dtype=torch.int32, device=self.device)
        pid[slot2] = torch.arange(self.n, dtype=torch.int32, device=self.device) if ids is None else ids.to(torch.int32)
        counts = self._counts(occ)
        fxg, fyg = self.force_kernel(xg, yg, *self._count_args(counts))
        comp = {}
        if self.compensated:
            comp = {k: torch.zeros(self.grid_shape, dtype=dtype, device=self.device)
                    for k in ("crx", "cry", "cvx", "cvy")}
        zero = torch.zeros((), dtype=dtype, device=self.device)
        return GridMDState(
            xg=xg, yg=yg, vxg=vxg, vyg=vyg, fxg=fxg, fyg=fyg,
            occ=occ, pid=pid.view(self.grid_shape),
            dispx=torch.zeros_like(xg), dispy=torch.zeros_like(xg),
            dmax2=zero, overflow=overflow, time=zero.clone(), rng_seed=seed, counts=counts, **comp,
        )

    # -- migration rebuild (sort-free) ----------------------------------------
    def _migration_dest(self, s: GridMDState):
        """Allocation phase of the rebuild. Returns the wrapped coordinates,
        the source-frame code grid ``dcode * cap + target_a`` (-1 where
        empty or invalid) that kernel B2 consumes, the post-rebuild
        occupancy grid, the overflow flag and the post-rebuild count grid
        (``(rows, cps)`` int32; the occupancy grid is 1 on exactly the slots
        below the count of their cell).

        The allocation depends only on physical cells and slot order, so it
        runs on the unpacked ``(cps, cap, cps)`` view of the grids (one copy
        each way where R > 1) and gives every particle the cell and slot
        the JAX package's packed allocation gives it.

        The rolls of the per-cell counts and bases along the rows read one
        row past each end through ``_row_ext``: the periodic neighbour rows
        here, the neighbour ranks' rows in the row-sharded engine, whose
        ``_row0`` also offsets the row index."""
        cps, cap, box, r = self.cps, self.cap, self.box, self.rows_per_block
        rows = self.n_rows
        dev = s.xg.device
        i32 = torch.int32

        # unwrapped drift is < skin/2 since the last rebuild; sentinel slots
        # give garbage here, gated by occ_b everywhere below
        xw = torch.remainder(s.xg, box)
        yw = torch.remainder(s.yg, box)
        occ_b = unpack(s.occ, r) > 0.5

        cx = torch.arange(self._row0, self._row0 + rows, dtype=i32, device=dev).view(rows, 1, 1)
        cy = torch.arange(cps, dtype=i32, device=dev).view(1, 1, cps)
        cell = box / cps
        txc = torch.div(unpack(xw, r), cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        tyc = torch.div(unpack(yw, r), cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        # migration direction in {-1, 0, 1} with periodic wrap
        dxc = (txc - cx + 1 + cps) % cps - 1
        dyc = (tyc - cy + 1 + cps) % cps - 1
        moved_far = occ_b & ((dxc.abs() > 1) | (dyc.abs() > 1))
        overflow = s.overflow | torch.any(moved_far)
        # a far-mover (flagged above) stays in its source cell
        dxc = torch.where(moved_far, 0, dxc)
        dyc = torch.where(moved_far, 0, dyc)

        # Allocation: per target cell, the classes (stayers and each
        # direction) land in fixed order, each class's slots starting after
        # the counts of all earlier classes. A target receives movers of
        # direction d from exactly one source cell (t - d), so a mover's
        # in-class rank at the target is its rank within its source cell.
        dcode = (dxc + 1) * 3 + (dyc + 1)  # class in 0..8
        dm = (torch.arange(9, dtype=i32, device=dev).view(9, 1, 1, 1) == dcode[None]) & occ_b[None]
        dmi = dm.to(i32)
        inc = torch.cumsum(dmi, dim=2, dtype=i32)  # along the slot axis
        ranks = inc - dmi
        counts = self._row_ext(inc[:, :, cap - 1 : cap, :], 1)  # (9, rows + 2, 1, cps)
        # counts per class moved to the target frame: out[X, Y] = v[X-dx, Y-dy]
        rc = torch.stack([torch.roll(counts[j, 1 - dx : 1 - dx + rows], dy, 2) for j, (dx, dy) in enumerate(_DIRS)])
        bases_t = torch.cumsum(rc, dim=0, dtype=i32) - rc
        bases_ext = self._row_ext(bases_t, 1)
        base_src = torch.stack(
            [torch.roll(bases_ext[j, 1 + dx : 1 + dx + rows], -dy, 2) for j, (dx, dy) in enumerate(_DIRS)]
        )
        picked = torch.where(dm, base_src + ranks, 0).sum(0, dtype=i32)
        target_a = torch.where(occ_b, picked, -1)

        overflow = overflow | torch.any((target_a >= cap) & occ_b)
        valid = occ_b & (target_a >= 0) & (target_a < cap)
        # classes occupy disjoint code ranges [j*cap, (j+1)*cap)
        scode = torch.where(valid, dcode * cap + target_a, -1).to(i32)

        # post-rebuild occupancy: slots fill compactly from 0
        tot = torch.clamp(rc.sum(0, dtype=i32), max=cap)  # (rows, 1, cps)
        slot_i = torch.arange(cap, dtype=i32, device=dev).view(1, cap, 1)
        occ_new = (slot_i < tot).to(s.occ.dtype)
        return xw, yw, pack(scode, r), pack(occ_new, r), overflow, tot.view(rows, cps)

    def _rebuild_migrate(self, s: GridMDState) -> GridMDState:
        """Sort-free re-binning: allocation in plain PyTorch (the
        ``md.alloc`` span), then one kernel-B2 launch that moves every field
        from where it lies and fills the slots the allocation leaves empty.
        A particle that moved further than one cell raises ``overflow`` and
        is kept in place.
        Coordinates are wrapped back into [0, box) here, the only place
        they ever are, and empty slots are re-filled with the sentinel."""
        with trace.span("md.rebuild"):
            with trace.span("md.alloc"):
                xw, yw, scode, occ, overflow, counts = self._migration_dest(s)
            dtype = s.xg.dtype
            fields = [xw, yw, s.vxg, s.vyg, s.fxg, s.fyg, s.pid.to(dtype)]
            fills = [self.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
            if s.crx is not None:
                fields += [s.crx, s.cry, s.cvx, s.cvy]
                fills += [0.0, 0.0, 0.0, 0.0]
            out = self._migrate(scode, fields, fills, occ)
            comp = {}
            if s.crx is not None:
                comp = dict(crx=out[7], cry=out[8], cvx=out[9], cvy=out[10])
            return s.replace(
                xg=out[0], yg=out[1], vxg=out[2], vyg=out[3], fxg=out[4], fyg=out[5],
                occ=occ, pid=out[6].to(torch.int32), counts=counts,
                dispx=torch.zeros_like(s.xg), dispy=torch.zeros_like(s.xg),
                dmax2=torch.zeros_like(s.dmax2), overflow=self._all_max(overflow), **comp,
            )

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor) -> torch.Tensor:
        """The rebuild's permutation of the field planes: kernel B2; ``occ``
        is the allocation's occupancy of the output."""
        return migrate(scode, fields, fills, self.rows_per_block, occ=occ)

    # -- rebuild (sort-based oracle) -------------------------------------------
    def _rebuild(self, s: GridMDState) -> GridMDState:
        """Re-binning by a stable sort of cell ids (the JAX package's
        oracle): correct for any displacement, so it checks the sort-free
        rebuild. Overflows a cell's capacity loudly."""
        cps, cap, lanes, r = self.cps, self.cap, self.lanes, self.rows_per_block
        dev = s.xg.device
        occ = s.occ.reshape(-1)
        x = torch.remainder(s.xg, self.box).reshape(-1)
        y = torch.remainder(s.yg, self.box).reshape(-1)
        n_cells = cps * cps
        cell = self.box / cps
        cxi = torch.div(x, cell, rounding_mode="floor").to(torch.int32).clamp(0, cps - 1)
        cyi = torch.div(y, cell, rounding_mode="floor").to(torch.int32).clamp(0, cps - 1)
        ids = torch.where(occ > 0.5, cxi * cps + cyi, n_cells)  # empties last
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(self.size, dtype=torch.int32, device=dev) - seg.to(torch.int32)
        real = sorted_ids < n_cells
        overflow = s.overflow | torch.any(real & (rank >= cap))
        rank = rank.clamp(max=cap - 1)
        cx = torch.div(sorted_ids, cps, rounding_mode="floor")
        cy = sorted_ids % cps
        new_slot = (torch.div(cx, r, rounding_mode="floor") * cap + rank) * lanes + (cx % r) * cps + cy
        new_slot = torch.where(real, new_slot, self.size).long()  # empties to a dropped slot

        def scat(v, fill=0.0):
            out = torch.full((self.size + 1,), fill, dtype=v.dtype, device=dev)
            out[new_slot] = v.reshape(-1)[order]
            return out[: self.size].view(self.grid_shape)

        comp = {}
        if s.crx is not None:
            comp = dict(crx=scat(s.crx), cry=scat(s.cry), cvx=scat(s.cvx), cvy=scat(s.cvy))
        occ_new = scat(s.occ)
        return s.replace(
            xg=scat(x, fill=self.sentinel), yg=scat(y), vxg=scat(s.vxg), vyg=scat(s.vyg),
            fxg=scat(s.fxg), fyg=scat(s.fyg), occ=occ_new, pid=scat(s.pid, fill=-1),
            counts=self._counts(occ_new),
            dispx=torch.zeros_like(s.xg), dispy=torch.zeros_like(s.xg),
            dmax2=torch.zeros_like(s.dmax2), overflow=overflow, **comp,
        )

    def _needs_rebuild(self, s: GridMDState, frac: float = 0.5) -> torch.Tensor:
        """Gate on the scalar displacement max kept by the windows. NaN-safe:
        a NaN ``dmax2`` asks for a rebuild."""
        return ~(s.dmax2 <= (frac * self.skin) ** 2)

    # -- MD step ---------------------------------------------------------------
    def _count_args(self, counts: torch.Tensor) -> tuple:
        """The count grid where the force kernel takes it (B3, R > 1)."""
        return (counts,) if self.rows_per_block > 1 else ()

    def _force_args(self, s: GridMDState) -> tuple:
        """Arguments the force kernel takes after the coordinates."""
        return self._count_args(s.counts)

    def _make_window(self, force_fn, n_inner: int, thermostat=None):
        """Leapfrog window: ``window(s) -> s`` advancing ``n_inner`` >= 1
        velocity-Verlet steps with one force call per step, over the
        engine's ``AXES`` (shared with the 3D engine). If any particle's
        displacement since the rebuild exceeded skin/2 mid-window, the
        state's ``overflow`` flag is raised (NaN-safe: ``~(NaN <= t)`` is
        True).

        NVE: the kick, drift, Kahan residuals and displacement max of each
        step are one :class:`~.leapfrog_cuda.Leapfrog` pass (on the card one
        kernel launch a step and one a window; on the CPU its plain
        version), the window's ``dmax2`` one scalar.

        ``thermostat=(gamma, kT)`` makes each step BAOAB Langevin (NVT): the
        exact Ornstein-Uhlenbeck map ``vh <- c1*vh + c2*xi`` between two
        half-drifts, ``c1 = exp(-gamma*dt)``, ``c2 = sqrt(kT*(1-c1^2))``
        (unit mass), still one force call a step, in eager PyTorch (the
        noise is the state's ``torch.Generator`` stream). The noise is
        masked by occupancy, so empty slots stay exactly at rest; velocity
        Kahan compensation is bypassed (the OU map rescales vh). A state
        without a noise stream raises ``ValueError``."""
        dt = self.dt
        comp = bool(self.compensated)
        axes = self.AXES

        def finish(s, dmax2, pos, v, f, disp, **res):
            """The window's end state: ``res`` the residual planes it wrote."""
            dmax2 = self._all_max(dmax2)
            violation = ~(dmax2 <= (0.5 * self.skin) ** 2)
            out = dict(dmax2=dmax2, overflow=s.overflow | violation, time=s.time + n_inner * dt)
            for k, a in enumerate(axes):
                out.update({f"{a}g": pos[k], f"v{a}g": v[k], f"f{a}g": f[k], f"disp{a}": disp[k]})
                out.update({f"{r}{a}": planes[k] for r, planes in res.items()})
            return s.replace(**out)

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
            gen = torch.Generator(device=s.xg.device)
            gen.manual_seed(self._noise_seed(s))
            noise_shape = (len(axes),) + tuple(s.xg.shape)
            extra = self._force_args(s)
            f = [getattr(s, f"f{a}g") for a in axes]
            vh = [getattr(s, f"v{a}g") + 0.5 * dt * fa for a, fa in zip(axes, f)]
            pos = [getattr(s, f"{a}g") for a in axes]
            cr = [getattr(s, f"cr{a}") for a in axes]
            disp = [getattr(s, f"disp{a}") for a in axes]
            dm = sumsq(disp)
            for _ in range(n_inner):
                # A O A: drift half on vh, OU-refresh vh, drift half on the
                # refreshed vh; the increments fuse into one add
                xi = torch.randn(noise_shape, generator=gen, dtype=s.xg.dtype, device=s.xg.device)
                vp = [c1 * v + c2 * (xi[k] * s.occ) for k, v in enumerate(vh)]
                inc = [0.5 * dt * (v + p) for v, p in zip(vh, vp)]
                vh = vp
                for k in range(len(axes)):
                    if comp:
                        pos[k], cr[k] = kadd(pos[k], cr[k], inc[k])
                    else:
                        pos[k] = pos[k] + inc[k]
                    disp[k] = disp[k] + inc[k]
                dm = torch.maximum(dm, sumsq(disp))
                f = list(force_fn(*pos, *extra))
                vh = [v + dt * fa for v, fa in zip(vh, f)]
            v = [v - 0.5 * dt * fa for v, fa in zip(vh, f)]
            res = dict(cr=cr) if comp else {}
            return finish(s.replace(rng_counter=s.rng_counter + n_inner), torch.max(dm), pos, v, f, disp, **res)

        window = nve if thermostat is None else langevin

        def traced(s):
            with trace.span("md.window"):
                return window(s)

        return traced

    def _window_for(self, s: GridMDState, n_inner: int, thermostat=None):
        """The ``n_inner``-step window (one force kernel in 2D; the 3D
        engine picks between two by the state's occupancy)."""
        return self._make_window(self.force_kernel, n_inner, thermostat)

    # -- drivers, shared with the 3D engine ----------------------------------
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
                s = self._rebuild_migrate(s)
            return s

        return run

    def make_production_run_fixed(self, n_steps: int, cadence: int, thermostat=None):
        """Fixed-cadence driver: ``rebuild -> cadence-step window`` blocks,
        with no gate read; ``n_steps % cadence`` trailing steps run as one
        remainder block. NVE only. Safety rests on the window's skin/2
        violation flag: a cadence too long for the actual temperature raises
        ``overflow``, never loses pairs silently. Size it with
        :meth:`auto_cadence`, on equilibrated states only."""
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        if thermostat is not None:
            raise ValueError("the fixed-cadence driver is NVE-only: Langevin runs use the gated drivers")
        nb, rem = divmod(n_steps, cadence)

        def run(s):
            for _ in range(nb):
                s = self._rebuild_migrate(s)
                s = self._window_for(s, cadence)(s)
            if rem:
                s = self._rebuild_migrate(s)
                s = self._window_for(s, rem)(s)
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
    def kinetic_energy(self, s: GridMDState) -> torch.Tensor:
        return self._all_sum(0.5 * torch.sum((s.vxg**2 + s.vyg**2) * s.occ))

    def potential_energy(self, s: GridMDState) -> torch.Tensor:
        """One energy-kernel pass. Each pair's shifted LJ energy is counted
        on both partners, hence the 0.5."""
        _, _, e, _ = self.energy_kernel(s.xg, s.yg, *self._force_args(s))
        return self._all_sum(0.5 * torch.sum(e))

    def virial(self, s: GridMDState) -> torch.Tensor:
        """Pair virial ``W = sum_pairs 24*eps*(2(s/r)^12 - (s/r)^6)`` from
        the energy-kernel pass (each pair on both partners, hence 0.5)."""
        _, _, _, w = self.energy_kernel(s.xg, s.yg, *self._force_args(s))
        return self._all_sum(0.5 * torch.sum(w))

    def pressure(self, s: GridMDState) -> torch.Tensor:
        """Instantaneous virial pressure ``P = (2*KE + W) / (d * V)``, d = 2."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (2.0 * self.box**2)

    def particle_order(self, s: GridMDState, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        pid = self._gather_rows(s.pid).reshape(-1)
        tgt = torch.where(pid >= 0, pid, self.n).long()
        out = torch.zeros((self.n + 1, 2), dtype=a.dtype, device=a.device)
        out[tgt] = torch.stack((self._gather_rows(a).reshape(-1), self._gather_rows(b).reshape(-1)), dim=1)
        return out[: self.n]

    def positions(self, s: GridMDState) -> torch.Tensor:
        """(N, 2) positions in particle order, wrapped into [0, box)."""
        return torch.remainder(self.particle_order(s, s.xg, s.yg), self.box)

    def velocities(self, s: GridMDState) -> torch.Tensor:
        return self.particle_order(s, s.vxg, s.vyg)
