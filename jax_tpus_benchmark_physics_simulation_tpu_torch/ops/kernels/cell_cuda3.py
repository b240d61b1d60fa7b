"""Kernels B4 and B5: 3D Lennard-Jones forces on the cell grid.

Replace the TPU kernels ``ops/kernels/cell_pallas3.py:_newton_kernel3`` (B4,
partner slots bounded at run time by the max cell occupancy) and
``:_static_kernel3`` (B5, the bound ``cov`` fixed at compile time) of the
JAX package, both built by ``make_grid_force_kernel3``. The CUDA source is
``csrc/cell_force3.cu``: one template, with the bound as the template
parameter ``COV`` (0 for B4, which reads ``max_occ`` through a device
pointer) and the energy/virial variant as a template flag. Its header says
what bounds it on an H100 and how the design answers that.

Grids are ``(ncx, cap, ncy * ncz)`` float32, the (y, z) cell plane flattened
without the TPU's 128-lane padding. Empty slots hold the x sentinel
``2.5 * box`` (y = z = 0), which the validity test ``0 < r2 < cutoff^2``
rejects, so no occupancy mask is read. Slots at or past the bound get zero.

- :func:`grid_force3_reference`: the plain PyTorch version, used for CPU
  tensors and as the kernels' reference on the card;
- :func:`grid_force3`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES`` / ``STATIC_LAUNCHES``: launches of B4,
  of B4's energy variant and of B5 (either variant), counted where the
  wrapper launches them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import SENTINEL_FACTOR

LAUNCHES = 0
ENERGY_LAUNCHES = 0
STATIC_LAUNCHES = 0
# the compile-time bounds csrc/cell_force3.cu instantiates for B5
STATIC_COVS = (8, 16, 24, 32, 40, 48, 56, 64)


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
    dt, dev = xg.dtype, xg.device
    idx = torch.arange(c, device=dev)
    x4, y4, z4 = (g.view(c, cap, c, c)[:, :bound] for g in (xg, yg, zg))
    xi, yi, zi = x4[:, :, None], y4[:, :, None], z4[:, :, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    fscale = p.fscale
    out = [torch.zeros_like(x4) for _ in range(5 if with_energy else 3)]

    def seam(d):
        # +box where index + d wraps past the top, -box past the bottom
        return ((idx + d >= c).to(dt) - (idx + d < 0).to(dt)) * p.box

    for dx in (-1, 0, 1):
        xr = torch.roll(x4, -dx, 0) + seam(dx)[:, None, None, None]
        yr = torch.roll(y4, -dx, 0)
        zr = torch.roll(z4, -dx, 0)
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
        g = torch.zeros((c, cap, c, c), dtype=dt, device=dev)
        g[:, :bound] = o
        full.append(g.view(c, cap, c * c))
    return tuple(full)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force3
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_grid(t: torch.Tensor, name: str, p: CellForce3Params, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != p.grid_shape:
        raise ValueError(f"{name}: expected shape {p.grid_shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


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
    tensor on the grids' device (None: the full capacity); B5 covers slots
    below ``static_cov`` and ignores ``max_occ``."""
    global LAUNCHES, ENERGY_LAUNCHES, STATIC_LAUNCHES
    dev = xg.device
    for t, name in ((xg, "xg"), (yg, "yg"), (zg, "zg")):
        _check_grid(t, name, p, dev)
    if static_cov is not None and not 0 < static_cov <= p.cap:
        raise ValueError(f"static_cov {static_cov} must lie in [1, capacity {p.cap}]")
    if max_occ is not None and static_cov is None:
        if max_occ.dtype != torch.int32 or max_occ.numel() != 1:
            raise TypeError(f"max_occ: expected one int32, got {max_occ.dtype} {tuple(max_occ.shape)}")
        if max_occ.device != dev:
            raise ValueError(f"max_occ: on {max_occ.device}, expected {dev}")
    if dev.type == "cpu":
        bound = static_cov if static_cov is not None else max_occ
        return grid_force3_reference(xg, yg, zg, p, None if bound is None else int(bound), with_energy)
    if dev.type != "cuda":
        raise ValueError(f"grid_force3 runs on cpu or cuda tensors, not {dev}")
    if static_cov is not None and static_cov not in STATIC_COVS:
        raise ValueError(f"the B5 kernel is built for static_cov in {STATIC_COVS}, not {static_cov}")
    outs = [torch.empty_like(xg) for _ in range(5 if with_energy else 3)]
    ew = outs[3:] if with_energy else [None, None]
    status = _launcher()(
        xg.data_ptr(), yg.data_ptr(), zg.data_ptr(),
        *(o.data_ptr() for o in outs[:3]),
        *(None if o is None else o.data_ptr() for o in ew),
        None if (max_occ is None or static_cov is not None) else max_occ.data_ptr(),
        static_cov or 0, p.cps, p.cap, p.cps, p.cps,
        p.box, p.sentinel, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift,
        int(with_energy), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "cell_force3 kernel")
    if static_cov is not None:
        STATIC_LAUNCHES += 1
    elif with_energy:
        ENERGY_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return tuple(outs)


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
