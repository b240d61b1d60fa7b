"""Kernel B1: 2D Lennard-Jones forces on the cell grid, and its halo form.

Replaces the TPU kernel ``ops/kernels/cell_pallas.py:_newton_kernel`` of the
JAX package (built by ``make_grid_force_kernel``) and, as B1 halo, its
explicit-halo call ``.raw`` (``cell_pallas.py:346``) that the row-sharded
engine runs on each device's rows. The CUDA source is
``csrc/cell_force.cu``. B1 and B1 halo are its tile kernel
(``cell_force_tile_kernel``): one block a tile of cells, the neighbour
cells staged in shared memory with occupied slots only, one thread per
occupied target; bit-equal to B1's loop (``cell_force_kernel``: one thread
a slot over 9 cells x ``cap`` partner slots), which stays in the library as
its yardstick. The source's header says what bounds each on an H100 and
how the designs answer that.

Grids are ``(cps, cap, cps)`` float32: the TPU's 128-lane padding is gone.
Empty slots hold the x sentinel ``2.5 * box`` (y = 0), which the validity
test ``0 < r2 < cutoff^2`` rejects, so no occupancy mask is read. The tile
kernel takes each cell's count as its number of non-sentinel slots (the
sentinel -+ box on a halo row across the x seam): the engines fill a
cell's slots from 0 at every rebuild.

- :func:`grid_force_reference`: the plain PyTorch version, used for CPU
  tensors and as the kernels' reference on the card;
- :func:`grid_force`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the tile kernel or raises;
- :func:`grid_force_halo_reference` / :func:`grid_force_halo`: the same
  for B1 halo, on one rank's ``rows`` cell rows with one halo row on each
  side, ``(rows + 2, cap, cps)`` in and ``(rows, cap, cps)`` out. The
  caller puts the x seam into the halo rows (``-box`` on the first rank's
  previous row, ``+box`` on the last rank's next row); rows do not wrap.
  Over P row blocks the result is bit-equal to B1 on the whole grid;
- :func:`grid_force_halo_edges`: B1 halo on the local ``(rows, cap, cps)``
  grids and the four exchanged edge rows, which the kernel reads where
  they lie (the row-sharded engine's force);
- :func:`grid_force_loop` / :func:`grid_force_halo_loop`: B1's and B1
  halo's loop on the card, which no path runs;
- :func:`tile_shape`: the tile and threads of a block of the tile kernel;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES`` / ``HALO_LAUNCHES`` /
  ``HALO_ENERGY_LAUNCHES``: launches of the tile kernel as B1's force-only
  and energy variants and as B1 halo's (either input form);
  ``LOOP_LAUNCHES`` / ``LOOP_ENERGY_LAUNCHES`` / ``HALO_LOOP_LAUNCHES`` /
  ``HALO_LOOP_ENERGY_LAUNCHES``: the same of the loop; each counted where a
  wrapper launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn

# Empty grid slots store x = SENTINEL_FACTOR * box (y = 0). With the
# kernel's ``0 < r2 < cutoff^2`` validity test this excludes every pair
# that touches an empty slot, without occupancy masks.
SENTINEL_FACTOR = 2.5

LAUNCHES = 0
ENERGY_LAUNCHES = 0
HALO_LAUNCHES = 0
HALO_ENERGY_LAUNCHES = 0
LOOP_LAUNCHES = 0
LOOP_ENERGY_LAUNCHES = 0
HALO_LOOP_LAUNCHES = 0
HALO_LOOP_ENERGY_LAUNCHES = 0


@dataclass(frozen=True)
class CellForceParams:
    """Grid shape and LJ constants of one force kernel."""

    cps: int
    cap: int
    box: float
    cutoff2: float
    sigma2: float
    epsilon: float
    shift: float  # U(cutoff), subtracted from every pair energy

    @property
    def fscale(self) -> float:
        return 24.0 * self.epsilon / self.sigma2

    @property
    def sentinel(self) -> float:
        return SENTINEL_FACTOR * self.box

    @classmethod
    def from_grid(cls, grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0):
        if grid_fn.dim != 2:
            raise ValueError("the cell force kernel is 2D")
        sc6 = (sigma / grid_fn.cutoff) ** 6
        return cls(
            cps=grid_fn.cells_per_side,
            cap=grid_fn.capacity,
            box=float(grid_fn.box),
            cutoff2=float(grid_fn.cutoff) ** 2,
            sigma2=float(sigma) ** 2,
            epsilon=float(epsilon),
            shift=float(4.0 * epsilon * (sc6 * sc6 - sc6)),
        )


def grid_force_reference(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, with_energy: bool = False, listed=None
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: ``(fx, fy)``, or ``(fx, fy, e, w)``
    with ``with_energy``. For each of the 9 neighbour offsets the partner
    grid is the rolled grid plus the seam offset (+-box where the cell row
    or column wraps), and the (cps, a, b, cps) pair block is summed over b.
    Works in any float dtype. ``listed``: a ``(9, cps, cap, cap, cps)``
    mask of the pairs that count at each offset (B3's list form), None:
    all."""
    return _pair_sums(xg, yg, _grid_partners(xg, yg, p), p, with_energy, listed)


def _grid_partners(xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams):
    """``partners(dx)`` of the whole grid: the grids rolled by row offset
    ``dx``, x seam added."""
    idx = torch.arange(p.cps, device=xg.device)

    def partners(dx):
        # +box where the row index wraps past the top, -box past the bottom
        seam = ((idx + dx >= p.cps).to(xg.dtype) - (idx + dx < 0).to(xg.dtype)) * p.box
        return torch.roll(xg, -dx, 0) + seam[:, None, None], torch.roll(yg, -dx, 0)

    return partners


def grid_force_halo_reference(
    xh: torch.Tensor, yh: torch.Tensor, p: CellForceParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of B1 halo: ``(rows + 2, cap, cps)`` grids with
    their halo rows (seam offsets included) in, B1's outputs on the
    ``rows`` local rows out."""
    rows = xh.shape[0] - 2
    return _pair_sums(
        xh[1:-1], yh[1:-1], lambda dx: (xh[1 + dx : 1 + dx + rows], yh[1 + dx : 1 + dx + rows]),
        p, with_energy,
    )


def _offset_partners(partners, p: CellForceParams, like: torch.Tensor):
    """The 9 offsets in the loop's order (dx, then dy): ``(dx, dy, xp, yp)``
    with the partner grids ``(rows, 1, cap, cps)`` of every target, in the
    device and dtype of ``like``; ``partners(dx)`` gives the partner grids
    of row offset ``dx`` (x seam included), the column offsets roll along
    the last axis with their y seam."""
    idx = torch.arange(p.cps, device=like.device)

    def seam(d):
        # +box where index + d wraps past the top, -box past the bottom
        return ((idx + d >= p.cps).to(like.dtype) - (idx + d < 0).to(like.dtype)) * p.box

    for dx in (-1, 0, 1):
        xr, yr = partners(dx)
        for dy in (-1, 0, 1):
            xp = torch.roll(xr, -dy, 2)[:, None, :, :]
            yp = (torch.roll(yr, -dy, 2) + seam(dy)[None, None, :])[:, None, :, :]
            yield dx, dy, xp, yp


def _pair_sums(xg, yg, partners, p: CellForceParams, with_energy: bool, listed=None):
    """The pair sums of the plain versions over :func:`_offset_partners`.
    ``listed``: the pairs that count at each offset
    (``grid_force_reference``)."""
    xi = xg[:, :, None, :]
    yi = yg[:, :, None, :]
    zero = torch.zeros((), dtype=xg.dtype, device=xg.device)
    fscale = p.fscale
    fx = torch.zeros_like(xg)
    fy = torch.zeros_like(xg)
    if with_energy:
        e = torch.zeros_like(xg)
        w = torch.zeros_like(xg)

    for o, (_, _, xp, yp) in enumerate(_offset_partners(partners, p, xg)):
        ddx = xi - xp
        ddy = yi - yp
        r2 = ddx * ddx + ddy * ddy
        valid = (r2 > 0.0) & (r2 < p.cutoff2)
        if listed is not None:
            valid = valid & listed[o]
        inv = p.sigma2 / r2
        s6 = inv * inv * inv
        if with_energy:
            s12 = s6 * s6
            fmag = torch.where(valid, (2.0 * s12 - s6) * inv, zero) * fscale
            e += torch.where(valid, 4.0 * p.epsilon * (s12 - s6) - p.shift, zero).sum(2)
            w += (torch.where(valid, 2.0 * s12 - s6, zero) * (fscale * p.sigma2)).sum(2)
        else:
            fmag = torch.where(valid, s6 * inv * (2.0 * fscale * s6 - fscale), zero)
        fx += (fmag * ddx).sum(2)
        fy += (fmag * ddy).sum(2)
    if with_energy:
        return fx, fy, e, w
    return fx, fy


def check_grid(t: torch.Tensor, name: str, shape: tuple, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` grid of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _lib_fn(name: str, argtypes: list):
    fn = getattr(_build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _tile_launcher(halo: bool):
    if halo:  # x_prev, x, x_next, y_prev, y, y_next, fx, fy, e, w, n_rows, cps, cap
        head = [_P] * 10 + [_I] * 3
    else:  # x, y, fx, fy, e, w, cps, cap
        head = [_P] * 6 + [_I] * 2
    return _lib_fn("jtps_cell_force_halo" if halo else "jtps_cell_force", head + [_F] * 7 + [_I] * 4 + [_P])


@functools.lru_cache(maxsize=None)
def _loop_launcher(halo: bool):
    head = [_P] * 6 + [_I] * (3 if halo else 2)
    return _lib_fn("jtps_cell_force_halo_loop" if halo else "jtps_cell_force_loop",
                   head + [_F] * 6 + [_I] * 2 + [_P])


def tile_shape(p: CellForceParams, rows: int, with_energy: bool, device) -> Tuple[int, int, int]:
    """``(H, W, threads)``: the tile of H cell rows x W columns, and the
    threads, that a block of the tile kernel takes by default on ``rows``
    output rows on CUDA ``device`` (``pick_tile`` in ``csrc/cell_force.cu``:
    the balanced widths of at most 4 rows and 32 columns, fewer rows while
    its blocks are not all resident at once)."""
    return _tile_shape(rows, p.cps, p.cap, bool(with_energy), torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _tile_shape(rows: int, cps: int, cap: int, with_energy: bool, index: int) -> Tuple[int, int, int]:
    fn = _lib_fn("jtps_cell_force_tile", [_I] * 5 + [ctypes.POINTER(_I)] * 3)
    h, w, t = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(rows, cps, cap, int(with_energy), index, ctypes.byref(h), ctypes.byref(w), ctypes.byref(t)),
                 "cell_force tile choice")
    return h.value, w.value, t.value


def _outputs(like: torch.Tensor, rows: int, p: CellForceParams, with_energy: bool):
    """The output grids and their pointers (``None`` for e and w without
    the energy)."""
    outs = [torch.empty((rows, p.cap, p.cps), dtype=like.dtype, device=like.device)
            for _ in range(4 if with_energy else 2)]
    ptrs = [o.data_ptr() for o in outs] + ([] if with_energy else [None, None])
    return tuple(outs), ptrs


def _consts(p: CellForceParams, sentinel: bool = True) -> tuple:
    head = (p.box, p.sentinel) if sentinel else (p.box,)
    return head + (p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift)


def _tile_forces(x_rows, y_rows, p: CellForceParams, with_energy: bool, halo: bool, tile=None):
    """Launches the tile kernel on CUDA rows: ``x_rows`` / ``y_rows`` are
    ``(local,)`` for the whole grid, ``(prev, local, next)`` for the halo
    form. ``tile`` ``(H, W)`` overrides the default tile (for measuring the
    choice)."""
    local = x_rows[1] if halo else x_rows[0]
    rows = local.shape[0]
    if tile is not None and not (1 <= tile[0] <= rows and 1 <= tile[1] <= p.cps and tile[0] * tile[1] <= 1024):
        raise ValueError(f"tile {tile}: 1 to {rows} rows x 1 to {p.cps} columns, at most 1024 cells")
    outs, out_ptrs = _outputs(local, rows, p, with_energy)
    ptrs = [t.data_ptr() for t in (*x_rows, *y_rows)] + out_ptrs
    dims = (rows, p.cps, p.cap) if halo else (p.cps, p.cap)
    h, w = tile if tile is not None else (0, 0)
    status = _tile_launcher(halo)(*ptrs, *dims, *_consts(p), int(with_energy), h, w, local.device.index,
                                  torch.cuda.current_stream(local.device).cuda_stream)
    _build.check(status, "cell_force halo kernel" if halo else "cell_force kernel")
    return outs


def _cuda_only(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {t.device}")


def grid_force(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, with_energy: bool = False, tile=None
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy)`` (or ``(fx, fy, e, w)``) totals on the cell grid: the
    tile kernel on the card (``tile`` ``(H, W)`` overrides its tile)."""
    global LAUNCHES, ENERGY_LAUNCHES
    shape = (p.cps, p.cap, p.cps)
    check_grid(xg, "xg", shape, xg.device)
    check_grid(yg, "yg", shape, xg.device)
    if xg.device.type == "cpu":
        return grid_force_reference(xg, yg, p, with_energy)
    _cuda_only(xg, "grid_force")
    outs = _tile_forces((xg,), (yg,), p, with_energy, False, tile)
    if with_energy:
        ENERGY_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return outs


def grid_force_loop(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """:func:`grid_force` through B1's loop (one thread a slot over every
    partner slot), which no path runs: the tile kernel's and B3's yardstick."""
    global LOOP_LAUNCHES, LOOP_ENERGY_LAUNCHES
    shape = (p.cps, p.cap, p.cps)
    check_grid(xg, "xg", shape, xg.device)
    check_grid(yg, "yg", shape, xg.device)
    if xg.device.type == "cpu":
        return grid_force_reference(xg, yg, p, with_energy)
    _cuda_only(xg, "grid_force_loop")
    outs, out_ptrs = _outputs(xg, p.cps, p, with_energy)
    status = _loop_launcher(False)(
        xg.data_ptr(), yg.data_ptr(), *out_ptrs, p.cps, p.cap, *_consts(p, sentinel=False),
        int(with_energy), xg.device.index, torch.cuda.current_stream(xg.device).cuda_stream,
    )
    _build.check(status, "cell_force loop kernel")
    if with_energy:
        LOOP_ENERGY_LAUNCHES += 1
    else:
        LOOP_LAUNCHES += 1
    return outs


def _halo_rows(xh: torch.Tensor, yh: torch.Tensor, p: CellForceParams) -> int:
    """Checks ``(rows + 2, cap, cps)`` grids; returns ``rows``."""
    rows = xh.shape[0] - 2 if isinstance(xh, torch.Tensor) and xh.dim() == 3 else 0
    if rows < 1:
        shape = tuple(xh.shape) if isinstance(xh, torch.Tensor) else type(xh).__name__
        raise ValueError(f"xh: expected (rows + 2, cap, cps) with rows >= 1, got {shape}")
    shape = (rows + 2, p.cap, p.cps)
    check_grid(xh, "xh", shape, xh.device)
    check_grid(yh, "yh", shape, xh.device)
    return rows


def grid_force_halo(
    xh: torch.Tensor, yh: torch.Tensor, p: CellForceParams, with_energy: bool = False, tile=None
) -> Tuple[torch.Tensor, ...]:
    """B1 halo: ``(fx, fy)`` (or ``(fx, fy, e, w)``) on the local rows of
    ``(rows + 2, cap, cps)`` grids that carry one halo row on each side (the
    tile kernel reads the three parts through their own pointers)."""
    global HALO_LAUNCHES, HALO_ENERGY_LAUNCHES
    _halo_rows(xh, yh, p)
    if xh.device.type == "cpu":
        return grid_force_halo_reference(xh, yh, p, with_energy)
    _cuda_only(xh, "grid_force_halo")
    outs = _tile_forces((xh[0], xh[1:-1], xh[-1]), (yh[0], yh[1:-1], yh[-1]), p, with_energy, True, tile)
    if with_energy:
        HALO_ENERGY_LAUNCHES += 1
    else:
        HALO_LAUNCHES += 1
    return outs


def grid_force_halo_edges(
    xg: torch.Tensor, yg: torch.Tensor, x_prev: torch.Tensor, y_prev: torch.Tensor,
    x_next: torch.Tensor, y_next: torch.Tensor, p: CellForceParams, with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """B1 halo on one rank's ``(rows, cap, cps)`` grids and the exchanged
    edge rows, ``(cap, cps)`` each: the previous rank's last row and the
    next rank's first row, x seam included. The same outputs as
    :func:`grid_force_halo` on the rows stacked, with no copy on the card."""
    global HALO_LAUNCHES, HALO_ENERGY_LAUNCHES
    if not isinstance(xg, torch.Tensor) or xg.dim() != 3 or xg.shape[0] < 1:
        raise ValueError(f"xg: expected (rows, cap, cps) with rows >= 1, got {getattr(xg, 'shape', xg)}")
    dev = xg.device
    check_grid(xg, "xg", (xg.shape[0], p.cap, p.cps), dev)
    check_grid(yg, "yg", tuple(xg.shape), dev)
    for t, name in ((x_prev, "x_prev"), (y_prev, "y_prev"), (x_next, "x_next"), (y_next, "y_next")):
        check_grid(t, name, (p.cap, p.cps), dev)
    if dev.type == "cpu":
        return grid_force_halo_reference(torch.cat([x_prev[None], xg, x_next[None]]),
                                         torch.cat([y_prev[None], yg, y_next[None]]), p, with_energy)
    _cuda_only(xg, "grid_force_halo_edges")
    outs = _tile_forces((x_prev, xg, x_next), (y_prev, yg, y_next), p, with_energy, True)
    if with_energy:
        HALO_ENERGY_LAUNCHES += 1
    else:
        HALO_LAUNCHES += 1
    return outs


def grid_force_halo_loop(
    xh: torch.Tensor, yh: torch.Tensor, p: CellForceParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """:func:`grid_force_halo` through B1 halo's loop, which no path runs:
    the tile kernel's yardstick."""
    global HALO_LOOP_LAUNCHES, HALO_LOOP_ENERGY_LAUNCHES
    rows = _halo_rows(xh, yh, p)
    if xh.device.type == "cpu":
        return grid_force_halo_reference(xh, yh, p, with_energy)
    _cuda_only(xh, "grid_force_halo_loop")
    outs, out_ptrs = _outputs(xh, rows, p, with_energy)
    status = _loop_launcher(True)(
        xh.data_ptr(), yh.data_ptr(), *out_ptrs, rows, p.cps, p.cap, *_consts(p, sentinel=False),
        int(with_energy), xh.device.index, torch.cuda.current_stream(xh.device).cuda_stream,
    )
    _build.check(status, "cell_force halo loop kernel")
    if with_energy:
        HALO_LOOP_ENERGY_LAUNCHES += 1
    else:
        HALO_LOOP_LAUNCHES += 1
    return outs


def make_grid_force_kernel(
    grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0, with_energy: bool = False
):
    """``(xg, yg) -> (fx, fy)`` (or ``(fx, fy, e, w)``), the counterpart of
    the JAX package's ``cell_pallas.make_grid_force_kernel``."""
    return functools.partial(
        grid_force, p=CellForceParams.from_grid(grid_fn, sigma, epsilon), with_energy=with_energy
    )
