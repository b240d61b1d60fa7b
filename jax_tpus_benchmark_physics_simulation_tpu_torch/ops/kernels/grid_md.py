"""Grid-resident LJ molecular dynamics (2D), the port's main path.

Port of the JAX package's ``ops/kernels/grid_md.py`` (``GridMDState``,
``GridMD``) for the unpacked layout. All particle state (positions,
velocities, forces, particle ids, Kahan residuals) lives permanently in the
cell-grid layout ``(cps, cap, cps)`` read by the force kernel B1
(``cell_cuda``); empty slots hold the x sentinel ``2.5 * box``.

- The velocity-Verlet update runs in leapfrog windows: one force call and
  one elementwise pass per step, half-kick in and half-unkick out at the
  window boundary.
- Positions are not wrapped per step: between rebuilds a particle drifts at
  most skin/2 outside [0, box), which the kernel's per-offset seam handling
  covers. Coordinates are wrapped once per rebuild.
- The skin monitor is a pair of displacement accumulators plus a per-slot
  running max, reduced to the scalar ``dmax2`` once per window.
- The rebuild is sort-free: every particle moves at most one cell between
  rebuilds, so an allocation in plain PyTorch (``_migration_dest``) gives
  each slot a source-frame code, and kernel B2 (``migrate_cuda``) moves the
  fields.

Host control flow: the JAX package runs the rebuild gate inside a device
``while_loop``. Here :meth:`GridMD.make_production_run` is a Python loop
that reads the scalar ``dmax2`` once per window, one host sync every
``n_inner`` steps.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import (
    make_grid_force_kernel,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import migrate

# Empty grid slots store x = SENTINEL_FACTOR * box (y = 0). With the
# kernel's ``0 < r2 < cutoff^2`` validity test this excludes every pair
# that touches an empty slot, without occupancy masks.
SENTINEL_FACTOR = 2.5

# the 9 migration directions, in the class order of the allocation
_DIRS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


@dataclass
class GridMDState:
    """All (cps, cap, cps) leaves live on ``GridMD.device``.

    ``fxg/fyg`` hold the total force. ``dispx/dispy`` accumulate per-slot
    displacement since the last rebuild (the Verlet-skin monitor).
    ``dmax2``, ``overflow`` and ``time`` are 0-d tensors.
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

    def replace(self, **changes) -> "GridMDState":
        return dataclasses.replace(self, **changes)


class GridMD:
    """Factory for the grid-resident MD step functions. State lives on
    ``device``: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        grid_fn: CellGridFn,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
        rows_per_block: int = 1,
        device="cuda",
    ):
        if grid_fn.dim != 2:
            raise ValueError("grid-resident MD is 2D")
        if rows_per_block != 1:
            raise NotImplementedError(
                "rows_per_block > 1 is the lane-packed layout (TPU kernel B3), "
                "not ported yet (ROADMAP.md section 1, still to port: 'The rest of "
                "2D GridMD', the packed layout)"
            )
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
        self.grid_shape = (self.cps, self.cap, self.cps)
        self.size = self.cps * self.cap * self.cps
        # hot-path kernel: forces only; the energy variant runs only at
        # sampling points (potential_energy, virial)
        self.force_kernel = make_grid_force_kernel(grid_fn, sigma, epsilon)
        self.energy_kernel = make_grid_force_kernel(grid_fn, sigma, epsilon, with_energy=True)

    # -- layout helpers ------------------------------------------------------
    def _slot2(self, position: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat grid slot for each particle + overflow flag. Particles of a
        cell take slots in particle order (stable sort), as in the JAX
        package."""
        cps, cap = self.cps, self.cap
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
        return ((cx * cap + aa) * cps + cy).long(), overflow

    def init(self, position: torch.Tensor, velocity: torch.Tensor) -> GridMDState:
        position = position.to(self.device)
        velocity = velocity.to(self.device)
        slot2, overflow = self._slot2(position)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = torch.full((self.size,), fill, dtype=dtype, device=self.device)
            z[slot2] = v
            return z.view(self.grid_shape)

        xg = put(position[:, 0], fill=self.sentinel)
        yg = put(position[:, 1])
        vxg, vyg = put(velocity[:, 0]), put(velocity[:, 1])
        occ = put(torch.ones(self.n, dtype=dtype, device=self.device))
        pid = torch.full((self.size,), -1, dtype=torch.int32, device=self.device)
        pid[slot2] = torch.arange(self.n, dtype=torch.int32, device=self.device)
        fxg, fyg = self.force_kernel(xg, yg)
        comp = {}
        if self.compensated:
            comp = {k: torch.zeros(self.grid_shape, dtype=dtype, device=self.device)
                    for k in ("crx", "cry", "cvx", "cvy")}
        zero = torch.zeros((), dtype=dtype, device=self.device)
        return GridMDState(
            xg=xg, yg=yg, vxg=vxg, vyg=vyg, fxg=fxg, fyg=fyg,
            occ=occ, pid=pid.view(self.grid_shape),
            dispx=torch.zeros_like(xg), dispy=torch.zeros_like(xg),
            dmax2=zero, overflow=overflow, time=zero.clone(), **comp,
        )

    # -- migration rebuild (sort-free) ----------------------------------------
    def _migration_dest(self, s: GridMDState):
        """Allocation phase of the rebuild. Returns the wrapped coordinates,
        the source-frame code grid ``dcode * cap + target_a`` (-1 where
        empty or invalid) that kernel B2 consumes, the post-rebuild
        occupancy grid and the overflow flag."""
        cps, cap, box = self.cps, self.cap, self.box
        dev = s.xg.device
        i32 = torch.int32
        occ_b = s.occ > 0.5

        # unwrapped drift is < skin/2 since the last rebuild; sentinel slots
        # give garbage here, gated by occ_b everywhere below
        xw = torch.remainder(s.xg, box)
        yw = torch.remainder(s.yg, box)

        cx = torch.arange(cps, dtype=i32, device=dev).view(cps, 1, 1)
        cy = torch.arange(cps, dtype=i32, device=dev).view(1, 1, cps)
        cell = box / cps
        txc = torch.div(xw, cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        tyc = torch.div(yw, cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
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
        counts = inc[:, :, cap - 1 : cap, :]  # (9, cps, 1, cps)
        # counts per class moved to the target frame: out[X, Y] = v[X-dx, Y-dy]
        rc = torch.stack([torch.roll(counts[j], (dx, dy), (0, 2)) for j, (dx, dy) in enumerate(_DIRS)])
        bases_t = torch.cumsum(rc, dim=0, dtype=i32) - rc
        base_src = torch.stack(
            [torch.roll(bases_t[j], (-dx, -dy), (0, 2)) for j, (dx, dy) in enumerate(_DIRS)]
        )
        picked = torch.where(dm, base_src + ranks, 0).sum(0, dtype=i32)
        target_a = torch.where(occ_b, picked, -1)

        overflow = overflow | torch.any((target_a >= cap) & occ_b)
        valid = occ_b & (target_a >= 0) & (target_a < cap)
        # classes occupy disjoint code ranges [j*cap, (j+1)*cap)
        scode = torch.where(valid, dcode * cap + target_a, -1).to(i32)

        # post-rebuild occupancy: slots fill compactly from 0
        tot = torch.clamp(rc.sum(0, dtype=i32), max=cap)  # (cps, 1, cps)
        slot_i = torch.arange(cap, dtype=i32, device=dev).view(1, cap, 1)
        occ_new = (slot_i < tot).to(s.occ.dtype)
        return xw, yw, scode, occ_new, overflow

    def _rebuild_migrate(self, s: GridMDState) -> GridMDState:
        """Sort-free re-binning: allocation in plain PyTorch, then one
        kernel-B2 launch that moves every field. A particle that moved
        further than one cell raises ``overflow`` and is kept in place.
        Coordinates are wrapped back into [0, box) here, the only place
        they ever are, and empty slots are re-filled with the sentinel."""
        xw, yw, scode, occ, overflow = self._migration_dest(s)
        dtype = s.xg.dtype
        fields = [xw, yw, s.vxg, s.vyg, s.fxg, s.fyg, s.pid.to(dtype)]
        fills = [self.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
        if s.crx is not None:
            fields += [s.crx, s.cry, s.cvx, s.cvy]
            fills += [0.0, 0.0, 0.0, 0.0]
        out = migrate(scode, torch.stack(fields), fills)
        comp = {}
        if s.crx is not None:
            comp = dict(crx=out[7], cry=out[8], cvx=out[9], cvy=out[10])
        return s.replace(
            xg=out[0], yg=out[1], vxg=out[2], vyg=out[3], fxg=out[4], fyg=out[5],
            occ=occ, pid=out[6].to(torch.int32),
            dispx=torch.zeros_like(s.xg), dispy=torch.zeros_like(s.xg),
            dmax2=torch.zeros_like(s.dmax2), overflow=overflow, **comp,
        )

    def _needs_rebuild(self, s: GridMDState, frac: float = 0.5) -> torch.Tensor:
        """Gate on the scalar displacement max kept by the windows. NaN-safe:
        a NaN ``dmax2`` asks for a rebuild."""
        return ~(s.dmax2 <= (frac * self.skin) ** 2)

    # -- MD step ---------------------------------------------------------------
    @staticmethod
    def _kadd(x, c, inc):
        """Kahan-compensated x += inc with residual c. Kept as separate
        eager ops: an algebraic simplification would cancel the residual."""
        y = inc - c
        t = x + y
        c = (t - x) - y
        return t, c

    def _make_window(self, force_fn, n_inner: int):
        """Leapfrog window: ``window(s) -> s`` advancing ``n_inner``
        velocity-Verlet steps (NVE) with one force call and one elementwise
        pass per step. If any particle's displacement since the rebuild
        exceeded skin/2 mid-window, the state's ``overflow`` flag is raised
        (NaN-safe: ``~(NaN <= t)`` is True)."""
        dt = self.dt
        comp = bool(self.compensated)
        kadd = self._kadd

        def window(s: GridMDState) -> GridMDState:
            vhx = s.vxg + 0.5 * dt * s.fxg
            vhy = s.vyg + 0.5 * dt * s.fyg
            x, y, crx, cry, cvx, cvy = s.xg, s.yg, s.crx, s.cry, s.cvx, s.cvy
            dpx, dpy = s.dispx, s.dispy
            dm = dpx * dpx + dpy * dpy
            fx, fy = s.fxg, s.fyg
            for _ in range(n_inner):
                incx = dt * vhx
                incy = dt * vhy
                if comp:
                    x, crx = kadd(x, crx, incx)
                    y, cry = kadd(y, cry, incy)
                else:
                    x = x + incx
                    y = y + incy
                dpx = dpx + incx
                dpy = dpy + incy
                dm = torch.maximum(dm, dpx * dpx + dpy * dpy)
                fx, fy = force_fn(x, y)
                if comp:
                    vhx, cvx = kadd(vhx, cvx, dt * fx)
                    vhy, cvy = kadd(vhy, cvy, dt * fy)
                else:
                    vhx = vhx + dt * fx
                    vhy = vhy + dt * fy
            dmax2 = torch.max(dm)
            violation = ~(dmax2 <= (0.5 * self.skin) ** 2)
            return s.replace(
                xg=x, yg=y,
                vxg=vhx - 0.5 * dt * fx,
                vyg=vhy - 0.5 * dt * fy,
                fxg=fx, fyg=fy,
                crx=crx, cry=cry, cvx=cvx, cvy=cvy,
                dispx=dpx, dispy=dpy,
                dmax2=dmax2,
                overflow=s.overflow | violation,
                time=s.time + n_inner * dt,
            )

        return window

    def _window_for(self, s: GridMDState, n_inner: int):
        """The ``n_inner``-step window (one force kernel in 2D; the 3D
        engine picks between two by the state's occupancy)."""
        return self._make_window(self.force_kernel, n_inner)

    def make_chunk_step(self, n_inner: int, gate_frac: float = 0.25):
        """``chunk(s) -> s``: a rebuild if the gate trips (one host read of
        ``dmax2``), then an ``n_inner``-step window. Size ``n_inner`` with
        :meth:`auto_chunk_params` for the same ``gate_frac``: the window
        must fit in the remaining ``(1/2 - gate_frac)`` skin margin."""
        window = self._make_window(self.force_kernel, n_inner)

        def chunk(s: GridMDState) -> GridMDState:
            if bool(self._needs_rebuild(s, frac=gate_frac)):
                s = self._rebuild_migrate(s)
            return window(s)

        return chunk

    def make_production_run(self, n_steps: int, n_inner: int, gate_frac: float = 0.25):
        """``run(s) -> s`` advancing exactly ``n_steps`` (``n_inner`` must
        divide it): windows run until the rebuild gate trips, checked
        between windows with one host read of ``dmax2``; then a rebuild, and
        again. The same windows, gate cadence and rebuilds as the JAX
        package's nested ``while_loop``, including one trailing rebuild."""
        if n_steps % n_inner:
            raise ValueError(f"n_inner {n_inner} must divide n_steps {n_steps}")
        window = self._make_window(self.force_kernel, n_inner)

        def run(s: GridMDState) -> GridMDState:
            done = 0
            while done < n_steps:
                while done < n_steps and not bool(self._needs_rebuild(s, frac=gate_frac)):
                    s = window(s)
                    done += n_inner
                s = self._rebuild_migrate(s)
            return s

        return run

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
        return 0.5 * torch.sum((s.vxg**2 + s.vyg**2) * s.occ)

    def potential_energy(self, s: GridMDState) -> torch.Tensor:
        """One energy-kernel pass. Each pair's shifted LJ energy is counted
        on both partners, hence the 0.5."""
        _, _, e, _ = self.energy_kernel(s.xg, s.yg)
        return 0.5 * torch.sum(e)

    def virial(self, s: GridMDState) -> torch.Tensor:
        """Pair virial ``W = sum_pairs 24*eps*(2(s/r)^12 - (s/r)^6)`` from
        the energy-kernel pass (each pair on both partners, hence 0.5)."""
        _, _, _, w = self.energy_kernel(s.xg, s.yg)
        return 0.5 * torch.sum(w)

    def pressure(self, s: GridMDState) -> torch.Tensor:
        """Instantaneous virial pressure ``P = (2*KE + W) / (d * V)``, d = 2."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (2.0 * self.box**2)

    def particle_order(self, s: GridMDState, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        pid = s.pid.reshape(-1)
        tgt = torch.where(pid >= 0, pid, self.n).long()
        out = torch.zeros((self.n + 1, 2), dtype=a.dtype, device=a.device)
        out[tgt] = torch.stack((a.reshape(-1), b.reshape(-1)), dim=1)
        return out[: self.n]

    def positions(self, s: GridMDState) -> torch.Tensor:
        """(N, 2) positions in particle order, wrapped into [0, box)."""
        return torch.remainder(self.particle_order(s, s.xg, s.yg), self.box)

    def velocities(self, s: GridMDState) -> torch.Tensor:
        return self.particle_order(s, s.vxg, s.vyg)
