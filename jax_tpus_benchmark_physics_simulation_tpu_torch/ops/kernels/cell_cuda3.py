"""Kernels B4 and B5: 3D Lennard-Jones forces on the cell grid, and their
halo forms.

Replace the TPU kernels ``ops/kernels/cell_pallas3.py:_newton_kernel3``
(B4, partner slots bounded at run time by the max cell occupancy) and
``:_static_kernel3`` (B5, the bound ``cov`` fixed at compile time) of the
JAX package, both built by ``make_grid_force_kernel3``, and, as B4/B5
halo, their explicit-halo call ``.raw`` (``cell_pallas3.py:722``) that the
row-sharded engine runs on each device's x-rows. The CUDA source is ``csrc/cell_force3.cu``. Both are the
counted kernel (``cell_force3_counted_kernel<COV, ...>``): one block a
strip of z-cells, the 3 x 3 neighbour lines staged in shared memory with
occupied slots only, one thread per occupied target. B5 is it at
``COV = cov``; B4 at ``COV = 0``, its shared memory sized for the capacity
and its bound ``max_occ`` read on the card through a pointer. Each is
bit-equal to its full loop over the bound's slots
(``cell_force3_kernel<COV, ...>``), which stays in the library as its
yardstick. The source's header says what bounds them on an H100 and how
the design answers that.

Grids are ``(ncx, cap, ncy * ncz)`` float32, the (y, z) cell plane flattened
without the TPU's 128-lane padding. Empty slots hold the x sentinel
``2.5 * box`` (y = z = 0), which the validity test ``0 < r2 < cutoff^2``
rejects, so no occupancy mask is read. Slots at or past the bound get zero.
The counted kernel takes each cell's count as its number of non-sentinel
slots below the bound: the engines fill a cell's slots from 0 at every
(re)binning, and the x-rows the halo exchange attaches are such rows.

- :func:`grid_force3_reference`: the plain PyTorch version, used for CPU
  tensors and as the kernels' reference on the card;
- :func:`grid_force3`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- :func:`grid_force3_halo_reference` / :func:`grid_force3_halo`: the same
  on one rank's ``rows`` x-rows with one halo x-row on each side,
  ``(rows + 2, cap, ncy * ncz)`` in and ``(rows, cap, ncy * ncz)`` out. The
  caller puts the x seam into the halo rows; x does not wrap. Over P row
  blocks the result is bit-equal to the full kernels;
- :func:`grid_force3_loop` / :func:`grid_force3_static_loop`: B4's and
  B5's full loops on the card, which no path runs: the counted kernel's
  bit-exact and timing yardsticks;
- :func:`strip_width`: the z-cells a block of the counted kernel takes (on
  the card);
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: launches of B4 and of its energy
  variant, ``COUNTED_LAUNCHES``: of B5 (the counted kernel, either
  variant), and ``HALO_LAUNCHES`` / ``HALO_ENERGY_LAUNCHES`` /
  ``HALO_COUNTED_LAUNCHES`` the same of the halo forms;
  ``LOOP_LAUNCHES`` / ``HALO_LOOP_LAUNCHES``: of B4's loop and
  ``STATIC_LAUNCHES`` / ``HALO_STATIC_LAUNCHES``: of B5's full loop (either
  variant); each counted where a wrapper launches its kernel;
- ``MAX_CAP``: the largest capacity B4's shared memory holds.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import check_grid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import SENTINEL_FACTOR

LAUNCHES = 0
ENERGY_LAUNCHES = 0
COUNTED_LAUNCHES = 0
HALO_LAUNCHES = 0
HALO_ENERGY_LAUNCHES = 0
HALO_COUNTED_LAUNCHES = 0
STATIC_LAUNCHES = 0
HALO_STATIC_LAUNCHES = 0
LOOP_LAUNCHES = 0
HALO_LOOP_LAUNCHES = 0
# the compile-time bounds csrc/cell_force3.cu instantiates for B5
STATIC_COVS = (8, 16, 24, 32, 40, 48, 56, 64)
MAX_STRIP = 32  # z-cells of a counted block: one warp's prefix sum
# B4's largest capacity: the largest multiple of 8 whose strip of one
# z-cell, with the energy, fits the H100's 232,448 bytes of shared memory
# a block (Strip3::bytes in csrc/cell_force3.cu: 345 * cap + 440)
MAX_CAP = 672


@dataclass(frozen=True)
class CellForce3Params:
    """Grid shape and LJ constants of one 3D force kernel (cubic grid:
    ``ncx = ncy = ncz = cps``)."""

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

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.cps, self.cap, self.cps * self.cps)

    @classmethod
    def from_grid(cls, grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0):
        if grid_fn.dim != 3:
            raise ValueError("the 3D cell force kernel needs a 3D grid")
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


def grid_force3_reference(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    bound: Optional[int] = None,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernels: ``(fx, fy, fz)``, or
    ``(fx, fy, fz, e, w)`` with ``with_energy``, covering slots ``< bound``
    (default: all) on both sides of a pair. For each of the 27 neighbour
    offsets the partner grid is the rolled grid plus the seam offsets (+-box
    on each axis whose cell index wraps), and the (ncx, a, b, ncy, ncz) pair
    block is summed over b. Works in any float dtype."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else min(max(int(bound), 0), cap)
    idx = torch.arange(c, device=xg.device)
    x4, y4, z4 = (g.view(c, cap, c, c)[:, :bound] for g in (xg, yg, zg))

    def partners(dx):
        # +box where the x index wraps past the top, -box past the bottom
        seam = ((idx + dx >= c).to(xg.dtype) - (idx + dx < 0).to(xg.dtype)) * p.box
        return torch.roll(x4, -dx, 0) + seam[:, None, None, None], torch.roll(y4, -dx, 0), torch.roll(z4, -dx, 0)

    return _pair_sums3(x4, y4, z4, partners, p, bound, with_energy)


def grid_force3_halo_reference(
    xh: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    p: CellForce3Params,
    bound: Optional[int] = None,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of B4/B5 halo: ``(rows + 2, cap, ncy*ncz)``
    grids with their halo x-rows (seam offsets included) in, the full
    kernels' outputs on the ``rows`` local rows out."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else min(max(int(bound), 0), cap)
    rows = xh.shape[0] - 2
    h4 = [g.view(rows + 2, cap, c, c)[:, :bound] for g in (xh, yh, zh)]
    return _pair_sums3(
        *(g[1:-1] for g in h4), lambda dx: tuple(g[1 + dx : 1 + dx + rows] for g in h4), p, bound, with_energy
    )


def _pair_sums3(x4, y4, z4, partners, p: CellForce3Params, bound: int, with_energy: bool):
    """The pair sums of the plain versions on ``(rows, bound, c, c)`` views:
    ``partners(dx)`` gives the partner views of x offset ``dx`` (x seam
    included); the (y, z) offsets roll with their seams. Returns full
    ``(rows, cap, c * c)`` grids, zero at slots ``>= bound``."""
    c, cap = p.cps, p.cap
    rows = x4.shape[0]
    dt, dev = x4.dtype, x4.device
    idx = torch.arange(c, device=dev)
    xi, yi, zi = x4[:, :, None], y4[:, :, None], z4[:, :, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    fscale = p.fscale
    out = [torch.zeros_like(x4) for _ in range(5 if with_energy else 3)]

    def seam(d):
        # +box where index + d wraps past the top, -box past the bottom
        return ((idx + d >= c).to(dt) - (idx + d < 0).to(dt)) * p.box

    for dx in (-1, 0, 1):
        xr, yr, zr = partners(dx)
        for dy in (-1, 0, 1):
            xr2 = torch.roll(xr, -dy, 2)
            yr2 = torch.roll(yr, -dy, 2) + seam(dy)[None, None, :, None]
            zr2 = torch.roll(zr, -dy, 2)
            for dz in (-1, 0, 1):
                xp = torch.roll(xr2, -dz, 3)[:, None]
                yp = torch.roll(yr2, -dz, 3)[:, None]
                zp = (torch.roll(zr2, -dz, 3) + seam(dz)[None, None, None, :])[:, None]
                ddx = xi - xp
                ddy = yi - yp
                ddz = zi - zp
                r2 = ddx * ddx + ddy * ddy + ddz * ddz
                valid = (r2 > 0.0) & (r2 < p.cutoff2)
                inv = p.sigma2 / r2
                s6 = inv * inv * inv
                if with_energy:
                    s12 = s6 * s6
                    fmag = torch.where(valid, (2.0 * s12 - s6) * inv, zero) * fscale
                    out[3] += torch.where(valid, 4.0 * p.epsilon * (s12 - s6) - p.shift, zero).sum(2)
                    out[4] += (torch.where(valid, 2.0 * s12 - s6, zero) * (fscale * p.sigma2)).sum(2)
                else:
                    fmag = torch.where(valid, s6 * inv * (2.0 * fscale * s6 - fscale), zero)
                out[0] += (fmag * ddx).sum(2)
                out[1] += (fmag * ddy).sum(2)
                out[2] += (fmag * ddz).sum(2)
    full = []
    for o in out:
        g = torch.zeros((rows, cap, c, c), dtype=dt, device=dev)
        g[:, :bound] = o
        full.append(g.view(rows, cap, c * c))
    return tuple(full)


def strip_width(p: CellForce3Params, rows: int, cov: Optional[int], with_energy: bool, device) -> int:
    """The z-cells a block of the counted kernel takes on ``rows`` output
    x-rows at bound ``cov`` (None: B4, shared memory for the capacity) on
    CUDA ``device``: the widest ``ceil(ncz / k)`` whose blocks are all
    resident on the card at once, from the occupancy calculator, else the
    widest balanced one of at most 16 that fits (``pick_strip`` in
    ``csrc/cell_force3.cu``)."""
    return _strip_width(cov or 0, p.cap, bool(with_energy), rows, p.cps, torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _strip_width(cov: int, cap: int, with_energy: bool, rows: int, cps: int, index: int) -> int:
    fn = _build.library().jtps_cell_force3_counted_strip
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    w = ctypes.c_int(0)
    _build.check(fn(cov, cap, int(with_energy), rows, cps, cps, index, ctypes.byref(w)), "cell_force3 strip choice")
    return w.value


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force3
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _counted_launcher():
    fn = _build.library().jtps_cell_force3_counted
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _forces3(grids, p: CellForce3Params, max_occ, with_energy: bool, static_cov, halo: bool,
             loop: bool = False, strip: Optional[int] = None):
    """Checks the arguments of :func:`grid_force3` (``halo=False``) or
    :func:`grid_force3_halo` (``halo=True``: each grid carries one halo
    x-row on each side) and runs the plain version on the CPU or a kernel
    on the card: the counted kernel, B4 or with ``static_cov`` B5, in
    strips of ``strip`` z-cells (default: :func:`strip_width`; another
    width is for measuring the choice), or with ``loop`` the full loop.
    Returns the outputs and whether a kernel launched."""
    dev = grids[0].device
    rows = grids[0].shape[0] - 2 if halo else p.cps
    if rows < 1:
        raise ValueError(f"xg: expected at least one local x-row, got shape {tuple(grids[0].shape)}")
    shape = (rows + 2 if halo else rows, p.cap, p.cps * p.cps)
    for t, name in zip(grids, ("xg", "yg", "zg")):
        check_grid(t, name, shape, dev)
    if static_cov is not None and not 0 < static_cov <= p.cap:
        raise ValueError(f"static_cov {static_cov} must lie in [1, capacity {p.cap}]")
    if static_cov is None and not loop and p.cap > MAX_CAP:
        raise ValueError(f"capacity {p.cap}: B4's shared memory holds capacities up to MAX_CAP = {MAX_CAP}")
    if max_occ is not None and static_cov is None:
        if max_occ.dtype != torch.int32 or max_occ.numel() != 1:
            raise TypeError(f"max_occ: expected one int32, got {max_occ.dtype} {tuple(max_occ.shape)}")
        if max_occ.device != dev:
            raise ValueError(f"max_occ: on {max_occ.device}, expected {dev}")
    if strip is not None and (loop or not 1 <= strip <= min(MAX_STRIP, p.cps)):
        raise ValueError(f"strip {strip}: the counted kernel takes 1 to {min(MAX_STRIP, p.cps)} z-cells")
    if dev.type == "cpu":
        bound = static_cov if static_cov is not None else max_occ
        bound = None if bound is None else int(bound)
        ref = grid_force3_halo_reference if halo else grid_force3_reference
        return ref(*grids, p, bound, with_energy), False
    if dev.type != "cuda":
        raise ValueError(f"the 3D force kernels run on cpu or cuda tensors, not {dev}")
    if static_cov is not None and static_cov not in STATIC_COVS:
        raise ValueError(f"the B5 kernel is built for static_cov in {STATIC_COVS}, not {static_cov}")
    outs = [torch.empty((rows, p.cap, p.cps * p.cps), dtype=grids[0].dtype, device=dev)
            for _ in range(5 if with_energy else 3)]
    ptrs = [g.data_ptr() for g in grids] + [o.data_ptr() for o in outs[:3]]
    ptrs += [o.data_ptr() for o in outs[3:]] if with_energy else [None, None]
    ptrs.append(None if (max_occ is None or static_cov is not None) else max_occ.data_ptr())
    consts = (p.box, p.sentinel, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape_args = (static_cov or 0, rows, p.cap, p.cps, p.cps, *consts, int(with_energy), int(halo))
    if loop:
        status = _launcher()(*ptrs, *shape_args, dev.index, stream)
    else:
        w = strip_width(p, rows, static_cov, with_energy, dev) if strip is None else strip
        status = _counted_launcher()(*ptrs, *shape_args, w, dev.index, stream)
    _build.check(status, "cell_force3 halo kernel" if halo else "cell_force3 kernel")
    return tuple(outs), True


def grid_force3(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy, fz)`` (or ``(fx, fy, fz, e, w)``) totals on the cell grid.

    B4 (``static_cov=None``) covers slots below ``max_occ``, a 0-d int32
    tensor on the grids' device (None: the full capacity, at most
    ``MAX_CAP``); B5 covers slots below ``static_cov`` and ignores
    ``max_occ``. On the card both are the counted kernel: the grids' cells
    must fill their slots from 0."""
    global LAUNCHES, ENERGY_LAUNCHES, COUNTED_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, max_occ, with_energy, static_cov, halo=False)
    if launched:
        if static_cov is not None:
            COUNTED_LAUNCHES += 1
        elif with_energy:
            ENERGY_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return outs


def grid_force3_halo(
    xh: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """B4/B5 halo: :func:`grid_force3` on the local x-rows of
    ``(rows + 2, cap, ncy * ncz)`` grids that carry one halo x-row on each
    side; ``max_occ`` is the bound over all ranks."""
    global HALO_LAUNCHES, HALO_ENERGY_LAUNCHES, HALO_COUNTED_LAUNCHES
    outs, launched = _forces3((xh, yh, zh), p, max_occ, with_energy, static_cov, halo=True)
    if launched:
        if static_cov is not None:
            HALO_COUNTED_LAUNCHES += 1
        elif with_energy:
            HALO_ENERGY_LAUNCHES += 1
        else:
            HALO_LAUNCHES += 1
    return outs


def grid_force3_loop(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    halo: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """B4 (``halo``: B4 halo) as its full loop: every slot's thread over 27
    cells x ``max_occ`` partner slots (None: the capacity). No path runs
    it; it is the counted kernel's yardstick, bit-equal to it on grids
    whose cells fill their slots from 0. A CPU tensor takes the plain
    version."""
    global LOOP_LAUNCHES, HALO_LOOP_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, max_occ, with_energy, None, halo=halo, loop=True)
    if launched:
        if halo:
            HALO_LOOP_LAUNCHES += 1
        else:
            LOOP_LAUNCHES += 1
    return outs


def grid_force3_static_loop(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    static_cov: int,
    with_energy: bool = False,
    halo: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """B5 (``halo``: B5 halo) as its full loop: every slot's thread over 27
    cells x ``static_cov`` partner slots. No path runs it; it is the counted
    kernel's yardstick, bit-equal to it on grids whose cells fill their
    slots from 0. A CPU tensor takes the plain version."""
    global STATIC_LAUNCHES, HALO_STATIC_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, None, with_energy, static_cov, halo=halo, loop=True)
    if launched:
        if halo:
            HALO_STATIC_LAUNCHES += 1
        else:
            STATIC_LAUNCHES += 1
    return outs


def make_grid_force_kernel3(
    grid_fn: CellGridFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
):
    """``(xg, yg, zg, max_occ=None) -> (fx, fy, fz)`` (or ``(..., e, w)``),
    the counterpart of the JAX package's
    ``cell_pallas3.make_grid_force_kernel3``: B4, or B5 with ``static_cov``
    (which then ignores ``max_occ``)."""
    p = CellForce3Params.from_grid(grid_fn, sigma, epsilon)

    def kernel(xg, yg, zg, max_occ=None):
        return grid_force3(xg, yg, zg, p, max_occ, with_energy, static_cov)

    return kernel
