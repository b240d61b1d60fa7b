"""Grid-resident LJ molecular dynamics (3D).

Port of the JAX package's ``ops/kernels/grid_md3.py`` (``GridMD3State``,
``GridMD3``), single device. It is the 2D engine (``grid_md.py``; read its
docstring first) with a third coordinate, and shares its leapfrog / BAOAB
Langevin window and its drivers:

- All particle state lives permanently in the cell-grid layout
  ``(ncx, cap, ncy * ncz)`` of the force kernels B4/B5 (``cell_cuda3``):
  the (y, z) cell plane is flattened into the last axis, without the TPU's
  128-lane padding, so viewed as ``(ncx, cap, ncy, ncz)`` a (y, z) cell
  shift is ``torch.roll`` on two axes. Empty slots hold the x sentinel.
- Leapfrog windows, coordinates unwrapped between rebuilds, the skin/2
  violation flag (NaN-safe), Kahan compensation of positions and velocities.
- The rebuild is sort-free over the 27 directions: an allocation in plain
  PyTorch (``_migration_dest3``) gives each slot a source-frame code, and
  one launch of B6 (``migrate_cuda3``; B7 with ``migrate_compact=False``)
  moves the fields from where they lie, fills the slots the allocation
  left empty and raises its mover flag on the card when a cell has more
  than ``migrate_k_mov`` movers, the state in which the JAX package's
  compacted kernel drops particles. B6 here moves every particle whatever
  the count, so the flag loses nothing: the state counts the rebuilds it
  rose in (``mover_flags``, on the device) and keeps it out of
  ``overflow``, which stays for lost or misplaced physics (a cell's
  capacity, a far mover, the skin, pure static mode's bound).
- ``max_occ``, the largest cell occupancy of the last (re)binning, is a 0-d
  int32 tensor on the device. B4 (the counted kernel at the capacity's
  shared memory) reads it there through a pointer as its bound.
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

Host control flow: the JAX package's ``lax.cond``/``while_loop`` drivers
are Python loops here. The gated driver reads ``dmax2`` once per window. In
the hybrid mode (``static_cov="auto"``), the choice between B5 (while
``max_occ <= cov``) and B4 reads ``max_occ`` once per rebuild period.

The row-sharded engine (``parallel/grid_md3_sharded.py``) overrides the
hooks this engine shares with the 2D one (``GridMD._all_max`` and the
rest): the sums and maxima over ranks, the rows past each end of the held
x-rows and the row offset. The JAX package's ``_rebuild_migrate_rows`` (its
plain-jnp rebuild oracle) is not ported: ``_rebuild`` is the port's.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

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
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import (
    SENTINEL_FACTOR,
    GridMD,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda3 import migrate3
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace

# the 27 migration directions, in the class order of the allocation
# (index == dcode = ((dx+1)*3 + (dy+1))*3 + (dz+1))
_DIRS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class GridMD3State:
    """All (ncx, cap, ncy*ncz) leaves live on ``GridMD3.device``.
    ``dmax2``, ``overflow``, ``time``, ``max_occ``, ``mover_flags`` and
    ``list_overflows`` are 0-d tensors."""

    xg: torch.Tensor
    yg: torch.Tensor
    zg: torch.Tensor
    vxg: torch.Tensor
    vyg: torch.Tensor
    vzg: torch.Tensor
    fxg: torch.Tensor
    fyg: torch.Tensor
    fzg: torch.Tensor
    occ: torch.Tensor  # float 1.0/0.0
    pid: torch.Tensor  # int32 particle id, sentinel -1
    dispx: torch.Tensor  # displacement since the last rebuild
    dispy: torch.Tensor
    dispz: torch.Tensor
    dmax2: torch.Tensor  # running max of |disp|^2 since the rebuild
    overflow: torch.Tensor  # bool
    time: torch.Tensor
    max_occ: torch.Tensor  # int32 max cell occupancy of the last (re)binning
    mover_flags: torch.Tensor  # int32 rebuilds whose B6 found > migrate_k_mov movers in a cell
    # Kahan compensation residuals (compensated=True)
    crx: Optional[torch.Tensor] = None
    cry: Optional[torch.Tensor] = None
    crz: Optional[torch.Tensor] = None
    cvx: Optional[torch.Tensor] = None
    cvy: Optional[torch.Tensor] = None
    cvz: Optional[torch.Tensor] = None
    # the Langevin noise stream (grid_md's module docstring)
    rng_seed: Optional[int] = None
    rng_counter: int = 0
    # int32 targets whose partners overflowed a partner list's capacity
    # (they ran the counted loop: nothing is lost)
    list_overflows: Optional[torch.Tensor] = None
    plist: Optional[PartnerList3] = None  # the partner list of this binning
    # steps run since the binning (host-side); None: unknown, as in a state
    # that neither init nor a rebuild made, which builds no partner list
    since_binning: Optional[int] = None

    def replace(self, **changes) -> "GridMD3State":
        return dataclasses.replace(self, **changes)


class GridMD3:
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
        if grid_fn.dim != 3:
            raise ValueError("GridMD3 is 3D (grid_md.GridMD covers 2D)")
        if grid_fn.n >= (1 << 24):
            raise ValueError("particle ids ride the rebuild as float32: n must be < 2^24")
        self.compensated = compensated
        self.migrate_compact = migrate_compact
        self.migrate_k_mov = migrate_k_mov
        self.grid_fn = grid_fn
        self.cps = grid_fn.cells_per_side
        self.cap = grid_fn.capacity
        self.plane = self.cps * self.cps
        self.box = grid_fn.box
        self.skin = grid_fn.skin
        self.n = grid_fn.n
        self.dt = dt
        self.device = torch.device(device)
        self.sentinel = SENTINEL_FACTOR * float(grid_fn.box)
        self.grid_shape = (self.cps, self.cap, self.plane)
        self.size = self.cps * self.cap * self.plane
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
        self._roll_index = {}
        self._params = CellForce3Params.from_grid(grid_fn, sigma, epsilon)
        self.partner_list = self.device.type == "cuda" if partner_list is None else bool(partner_list)
        self.list_r2 = list_radius2(grid_fn.cutoff, self.skin, self.box)
        self.list_cap = list_capacity(self.n, self.box, self.list_r2)

    @property
    def _pure_static(self) -> bool:
        return self.static_cov is not None and not self._hybrid

    # the row-sharding hooks, shared with the 2D engine
    _row0 = GridMD._row0
    n_rows = GridMD.n_rows
    _held = GridMD._held
    _row_ext = staticmethod(GridMD._row_ext)
    _all_max = staticmethod(GridMD._all_max)
    _all_sum = staticmethod(GridMD._all_sum)
    _gather_rows = staticmethod(GridMD._gather_rows)
    _noise_seed = staticmethod(GridMD._noise_seed)

    # -- layout helpers ------------------------------------------------------
    def _slot3(self, position: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat grid slot for each particle + overflow flag. Particles of a
        cell take slots in particle order (stable sort), as in the JAX
        package."""
        cps, cap = self.cps, self.cap
        coords = torch.div(position, self.box / cps, rounding_mode="floor")
        coords = coords.to(torch.int32).clamp(0, cps - 1)
        ids = (coords[:, 0] * cps + coords[:, 1]) * cps + coords[:, 2]
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
        cx = torch.div(cell_id, self.plane, rounding_mode="floor")
        lane = cell_id % self.plane  # cy * ncz + cz
        return ((cx * cap + aa) * self.plane + lane).long(), overflow

    def prepare(self, state: GridMD3State) -> GridMD3State:
        """Placement hook (parity with the JAX package's ``prepare``)."""
        return state

    def _max_occ(self, occ: torch.Tensor) -> torch.Tensor:
        """Global max cell occupancy (the slot axis is 1), 0-d int32."""
        return self._all_max(occ.sum(1).max().to(torch.int32))

    def init(self, position: torch.Tensor, velocity: torch.Tensor, seed: Optional[int] = None) -> GridMD3State:
        """``seed`` arms the state's noise stream, which Langevin windows
        need and NVE ones ignore."""
        position = position.to(self.device)
        velocity = velocity.to(self.device)
        slot, overflow = self._slot3(position)
        slot, ids = self._held(slot)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = torch.full((self.size,), fill, dtype=dtype, device=self.device)
            z[slot] = v if ids is None else v[ids]
            return z.view(self.grid_shape)

        xg = put(position[:, 0], fill=self.sentinel)
        yg, zg = put(position[:, 1]), put(position[:, 2])
        vxg, vyg, vzg = (put(velocity[:, k]) for k in range(3))
        occ = put(torch.ones(self.n, dtype=dtype, device=self.device))
        pid = torch.full((self.size,), -1, dtype=torch.int32, device=self.device)
        pid[slot] = torch.arange(self.n, dtype=torch.int32, device=self.device) if ids is None else ids.to(torch.int32)
        max_occ = self._max_occ(occ)
        if self._pure_static:
            overflow = overflow | (max_occ > self.static_cov)
        fxg, fyg, fzg = self.force_kernel(xg, yg, zg, max_occ)
        comp = {}
        if self.compensated:
            comp = {k: torch.zeros(self.grid_shape, dtype=dtype, device=self.device)
                    for k in ("crx", "cry", "crz", "cvx", "cvy", "cvz")}
        zero = torch.zeros((), dtype=dtype, device=self.device)
        return GridMD3State(
            xg=xg, yg=yg, zg=zg, vxg=vxg, vyg=vyg, vzg=vzg, fxg=fxg, fyg=fyg, fzg=fzg,
            occ=occ, pid=pid.view(self.grid_shape),
            dispx=torch.zeros_like(xg), dispy=torch.zeros_like(xg), dispz=torch.zeros_like(xg),
            dmax2=zero, overflow=overflow, time=zero.clone(), max_occ=max_occ,
            mover_flags=torch.zeros((), dtype=torch.int32, device=self.device), rng_seed=seed,
            list_overflows=torch.zeros((), dtype=torch.int32, device=self.device), since_binning=0, **comp,
        )

    # -- migration rebuild (sort-free) ----------------------------------------
    def _roll_cells_index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat gather indices from a (27, rows + 2, ncy, ncz) per-cell array
        (the held x-rows with one row past each end, ``_row_ext``) into the
        (27, rows, ncy, ncz) one: the first rolls class j's cells forward by
        its direction (``out[j, X] = v[j, X - d_j]``), the second back
        (``out[j, X] = v[j, X + d_j]``), y and z periodically. One gather
        replaces the JAX package's 27 rolls (``roll_cells``) and gives the
        same integers."""
        key = str(device)
        if key not in self._roll_index:
            c, rows = self.cps, self.n_rows
            ar = torch.arange(c, device=device)
            d = torch.tensor(_DIRS, device=device).view(27, 3, 1, 1, 1)
            xyz = torch.stack(torch.meshgrid(torch.arange(rows, device=device), ar, ar, indexing="ij"))[None]
            j = torch.arange(27, device=device).view(27, 1, 1, 1) * ((rows + 2) * c * c)

            def flat(p):
                # x is row 1 + X -+ dx of the extended rows; y and z wrap
                return j + ((1 + p[:, 0]) * c + p[:, 1] % c) * c + p[:, 2] % c

            self._roll_index[key] = (flat(xyz - d).reshape(-1), flat(xyz + d).reshape(-1))
        return self._roll_index[key]

    def _migration_dest3(self, s: GridMD3State):
        """Allocation phase of the rebuild. Returns the wrapped coordinates,
        the source-frame code grid ``dcode * cap + target_a`` (-1 where
        empty or invalid) that the migrate kernel consumes, the post-rebuild
        occupancy grid and the overflow flag. The same allocation as the JAX
        package's, class by class in the same order, so the codes are
        bit-identical (see ``GridMD._migration_dest`` for the argument)."""
        cps, cap, box, plane = self.cps, self.cap, self.box, self.plane
        rows = self.n_rows
        dev = s.xg.device
        i32 = torch.int32
        occ_b = s.occ > 0.5

        # unwrapped drift is < skin/2 since the last rebuild; sentinel slots
        # give garbage here, gated by occ_b everywhere below
        xw = torch.remainder(s.xg, box)
        yw = torch.remainder(s.yg, box)
        zw = torch.remainder(s.zg, box)

        cx = torch.arange(self._row0, self._row0 + rows, dtype=i32, device=dev).view(rows, 1, 1)
        col = torch.arange(plane, dtype=i32, device=dev).view(1, 1, plane)
        cy = torch.div(col, cps, rounding_mode="floor")
        cz = col % cps
        cell = box / cps
        txc = torch.div(xw, cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        tyc = torch.div(yw, cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        tzc = torch.div(zw, cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        # migration direction in {-1, 0, 1} with periodic wrap
        dxc = (txc - cx + 1 + cps) % cps - 1
        dyc = (tyc - cy + 1 + cps) % cps - 1
        dzc = (tzc - cz + 1 + cps) % cps - 1
        moved_far = occ_b & ((dxc.abs() > 1) | (dyc.abs() > 1) | (dzc.abs() > 1))
        overflow = s.overflow | torch.any(moved_far)
        # a far-mover (flagged above) stays in its source cell
        dxc = torch.where(moved_far, 0, dxc)
        dyc = torch.where(moved_far, 0, dyc)
        dzc = torch.where(moved_far, 0, dzc)

        dcode = ((dxc + 1) * 3 + (dyc + 1)) * 3 + (dzc + 1)  # class in 0..26
        dm = (torch.arange(27, dtype=i32, device=dev).view(27, 1, 1, 1) == dcode[None]) & occ_b[None]
        dmi = dm.to(i32)
        inc = torch.cumsum(dmi, dim=2, dtype=i32)  # along the slot axis
        ranks = inc - dmi  # exclusive in-cell rank within the class
        counts = self._row_ext(inc[:, :, cap - 1, :], 1)  # (27, rows + 2, plane)
        fwd, back = self._roll_cells_index(dev)
        # per-class counts at the TARGET cell, exclusive-prefixed in class
        # order: the first free slot before each class arrives
        rc = counts.reshape(-1)[fwd].view(27, rows, 1, plane)
        bases_t = torch.cumsum(rc, dim=0, dtype=i32) - rc
        base_src = self._row_ext(bases_t, 1).reshape(-1)[back].view(27, rows, 1, plane)
        picked = torch.where(dm, base_src + ranks, 0).sum(0, dtype=i32)
        target_a = torch.where(occ_b, picked, -1)

        overflow = overflow | torch.any((target_a >= cap) & occ_b)
        valid = occ_b & (target_a >= 0) & (target_a < cap)
        # classes occupy disjoint code ranges [j*cap, (j+1)*cap)
        scode = torch.where(valid, dcode * cap + target_a, -1).to(i32)

        # post-rebuild occupancy: slots fill compactly from 0
        tot = torch.clamp(rc.sum(0, dtype=i32), max=cap)  # (rows, 1, plane)
        slot_i = torch.arange(cap, dtype=i32, device=dev).view(1, cap, 1)
        occ_new = (slot_i < tot).to(s.occ.dtype)
        return xw, yw, zw, scode, occ_new, overflow

    def _rebuild_migrate(self, s: GridMD3State) -> GridMD3State:
        """Sort-free re-binning: allocation in plain PyTorch (the
        ``md.alloc`` span), then one migrate launch (B6, or B7 with
        ``migrate_compact=False``) that moves every field from where it lies
        and raises the mover flag on the card. A particle that moved further
        than one cell raises ``overflow`` and is kept in place; so do a cell
        over its capacity and, in pure static mode, a new ``max_occ`` above
        ``static_cov``. B6's mover flag adds one to ``mover_flags`` instead:
        no particle is lost. Coordinates are wrapped back into [0, box)
        here, the only place they ever are, and empty slots are re-filled
        with the sentinel."""
        with trace.span("md.rebuild"):
            with trace.span("md.alloc"):
                xw, yw, zw, scode, occ_new, overflow = self._migration_dest3(s)
                new_mo = self._max_occ(occ_new)
            dtype = s.xg.dtype
            fields = [xw, yw, zw, s.vxg, s.vyg, s.vzg, s.fxg, s.fyg, s.fzg, s.pid.to(dtype)]
            fills = [self.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
            if s.crx is not None:
                fields += [s.crx, s.cry, s.crz, s.cvx, s.cvy, s.cvz]
                fills += [0.0] * 6
            if self._pure_static:
                overflow = overflow | (new_mo > self.static_cov)
            out, mov_of = self._migrate(scode, fields, fills, occ_new)
            # one reduction over the ranks for both flags
            overflow, mov_of = self._all_max(torch.stack([overflow, mov_of]))
            comp = {}
            if s.crx is not None:
                comp = dict(crx=out[10], cry=out[11], crz=out[12], cvx=out[13], cvy=out[14], cvz=out[15])
            zeros = torch.zeros_like(s.xg)
            return s.replace(
                xg=out[0], yg=out[1], zg=out[2], vxg=out[3], vyg=out[4], vzg=out[5],
                fxg=out[6], fyg=out[7], fzg=out[8],
                occ=occ_new, pid=out[9].to(torch.int32),
                dispx=zeros, dispy=zeros, dispz=zeros,
                dmax2=torch.zeros_like(s.dmax2),
                overflow=overflow, max_occ=new_mo, mover_flags=s.mover_flags + mov_of,
                plist=None, since_binning=0, **comp,
            )

    def _migrate(self, scode: torch.Tensor, fields, fills, occ: torch.Tensor):
        """The rebuild's permutation of the field planes and its mover
        flag: B6, or B7 with ``migrate_compact=False``; ``occ`` is the
        allocation's occupancy of the output."""
        k_mov = self.migrate_k_mov if self.migrate_compact else None
        return migrate3(scode, fields, fills, k_mov=k_mov, occ=occ)

    # -- rebuild (sort-based oracle) -------------------------------------------
    def _rebuild(self, s: GridMD3State) -> GridMD3State:
        """Re-binning by a stable sort of cell ids (the JAX package's
        oracle): correct for any displacement. Overflows a cell's capacity
        loudly, and in pure static mode a new ``max_occ`` above
        ``static_cov``."""
        cps, cap, plane = self.cps, self.cap, self.plane
        dev = s.xg.device
        occ = s.occ.reshape(-1)
        coords = [torch.remainder(g, self.box).reshape(-1) for g in (s.xg, s.yg, s.zg)]
        n_cells = cps * cps * cps
        cell = self.box / cps

        def cellc(v):
            return torch.div(v, cell, rounding_mode="floor").to(torch.int32).clamp(0, cps - 1)

        ids = torch.where(occ > 0.5, (cellc(coords[0]) * cps + cellc(coords[1])) * cps + cellc(coords[2]), n_cells)
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(self.size, dtype=torch.int32, device=dev) - seg.to(torch.int32)
        real = sorted_ids < n_cells
        overflow = s.overflow | torch.any(real & (rank >= cap))
        rank = rank.clamp(max=cap - 1)
        cxs = torch.div(sorted_ids, plane, rounding_mode="floor")
        new_slot = (cxs * cap + rank) * plane + sorted_ids % plane
        new_slot = torch.where(real, new_slot, self.size).long()  # empties to a dropped slot

        def scat(v, fill=0.0):
            out = torch.full((self.size + 1,), fill, dtype=v.dtype, device=dev)
            out[new_slot] = v.reshape(-1)[order]
            return out[: self.size].view(self.grid_shape)

        comp = {}
        if s.crx is not None:
            comp = {k: scat(getattr(s, k)) for k in ("crx", "cry", "crz", "cvx", "cvy", "cvz")}
        occ_new = scat(s.occ)
        new_mo = self._max_occ(occ_new)
        if self._pure_static:
            overflow = overflow | (new_mo > self.static_cov)
        zeros = torch.zeros_like(s.xg)
        return s.replace(
            xg=scat(coords[0], fill=self.sentinel), yg=scat(coords[1]), zg=scat(coords[2]),
            vxg=scat(s.vxg), vyg=scat(s.vyg), vzg=scat(s.vzg),
            fxg=scat(s.fxg), fyg=scat(s.fyg), fzg=scat(s.fzg),
            occ=occ_new, pid=scat(s.pid, fill=-1),
            dispx=zeros, dispy=zeros, dispz=zeros,
            dmax2=torch.zeros_like(s.dmax2), overflow=overflow, max_occ=new_mo,
            plist=None, since_binning=0, **comp,
        )

    _needs_rebuild = GridMD._needs_rebuild

    # -- MD step ---------------------------------------------------------------
    # the leapfrog / BAOAB window over AXES, and the drivers, are the 2D
    # engine's (see GridMD._make_window)
    def _make_window(self, force_fn, n_inner: int, thermostat=None):
        """``GridMD._make_window``; the window also counts the steps run
        since the binning (``since_binning``), which the partner list's
        lifetime reads."""
        window = GridMD._make_window(self, force_fn, n_inner, thermostat)

        def counted(s):
            since = None if s.since_binning is None else s.since_binning + n_inner
            return window(s).replace(since_binning=since)

        return counted

    def _force_args(self, s: GridMD3State) -> tuple:
        """B4 reads the occupancy bound on the device; it is constant
        between rebuilds (the binning is fixed)."""
        return (s.max_occ,)

    def _window_for(self, s: GridMD3State, n_inner: int, thermostat=None):
        """The ``n_inner``-step window for the state's binning. In hybrid
        mode: B5's while ``max_occ <= cov``, else B4's, which costs one
        host read of ``max_occ``; ``max_occ`` only changes at a rebuild, so
        the drivers call this once per rebuild period. With the partner
        list on and ``n_inner >= 2``, the window runs that kernel's list
        form: on a state fresh from its binning it builds the list first
        (the ``md.list`` span), and it falls back to the counted loop where
        the state has no list for its binning or the window would end past
        the list's lifetime (``cell_cuda3.LIST_STEPS``)."""
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
                return window(s)
            plist = s.plist

            def force(xg, yg, zg, max_occ):
                return grid_force3(xg, yg, zg, self._params, max_occ, static_cov=cov, plist=plist)

            return self._make_window(force, n_inner, thermostat)(s)

        return listed

    step_nocheck = GridMD.step_nocheck
    step = GridMD.step
    make_chunk_step = GridMD.make_chunk_step
    make_production_run = GridMD.make_production_run

    def make_production_run_fixed(self, n_steps: int, cadence: int, thermostat=None):
        """``GridMD.make_production_run_fixed``; the state it returns holds
        no partner list. Its next call rebins first, so the list is dead,
        and a caller holding the state across that call would keep it
        alive beside the next binning's."""
        run = GridMD.make_production_run_fixed(self, n_steps, cadence, thermostat)
        return lambda s: run(s).replace(plist=None)

    auto_cadence = GridMD.auto_cadence
    auto_chunk_params = GridMD.auto_chunk_params
    auto_inner_steps = GridMD.auto_inner_steps

    # -- observables / export ---------------------------------------------------
    def kinetic_energy(self, s: GridMD3State) -> torch.Tensor:
        return self._all_sum(0.5 * torch.sum((s.vxg**2 + s.vyg**2 + s.vzg**2) * s.occ))

    def potential_energy(self, s: GridMD3State) -> torch.Tensor:
        """One energy-kernel pass. Each pair's shifted LJ energy is counted
        on both partners, hence the 0.5."""
        _, _, _, e, _ = self.energy_kernel(s.xg, s.yg, s.zg, s.max_occ)
        return self._all_sum(0.5 * torch.sum(e))

    def virial(self, s: GridMD3State) -> torch.Tensor:
        """Pair virial ``W = sum_pairs 24*eps*(2(s/r)^12 - (s/r)^6)`` from
        the energy-kernel pass (each pair on both partners, hence 0.5)."""
        _, _, _, _, w = self.energy_kernel(s.xg, s.yg, s.zg, s.max_occ)
        return self._all_sum(0.5 * torch.sum(w))

    def pressure(self, s: GridMD3State) -> torch.Tensor:
        """Instantaneous virial pressure ``P = (2*KE + W) / (3 * V)``."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (3.0 * self.box**3)

    def particle_order(self, s: GridMD3State, *grids: torch.Tensor) -> torch.Tensor:
        """(N, len(grids)) values of the grids in particle order."""
        pid = self._gather_rows(s.pid).reshape(-1)
        tgt = torch.where(pid >= 0, pid, self.n).long()
        out = torch.zeros((self.n + 1, len(grids)), dtype=grids[0].dtype, device=grids[0].device)
        out[tgt] = torch.stack([self._gather_rows(g).reshape(-1) for g in grids], dim=1)
        return out[: self.n]

    def positions(self, s: GridMD3State) -> torch.Tensor:
        """(N, 3) positions in particle order, wrapped into [0, box)."""
        return torch.remainder(self.particle_order(s, s.xg, s.yg, s.zg), self.box)

    def velocities(self, s: GridMD3State) -> torch.Tensor:
        return self.particle_order(s, s.vxg, s.vyg, s.vzg)

    def forces(self, s: GridMD3State) -> torch.Tensor:
        """(N, 3) total forces in particle order."""
        return self.particle_order(s, s.fxg, s.fyg, s.fzg)
