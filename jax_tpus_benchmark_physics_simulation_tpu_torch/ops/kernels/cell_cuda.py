"""Kernel B1: 2D Lennard-Jones forces on the cell grid.

Replaces the TPU kernel ``ops/kernels/cell_pallas.py:_newton_kernel`` of the
JAX package (built by ``make_grid_force_kernel``). The CUDA source is
``csrc/cell_force.cu``; its header says what bounds it on an H100 (at
N=100k, 234k slots x 9*16 partners a step with the grid in L2: pair
arithmetic and one divide per pair) and how the design answers that.

Grids are ``(cps, cap, cps)`` float32: the TPU's 128-lane padding is gone.
Empty slots hold the x sentinel ``2.5 * box`` (y = 0), which the validity
test ``0 < r2 < cutoff^2`` rejects, so no occupancy mask is read.

- :func:`grid_force_reference`: the plain PyTorch version, used for CPU
  tensors and as the kernel's reference on the card;
- :func:`grid_force`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: kernel launches of the force-only and
  the energy variant, counted where the wrapper launches them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn

LAUNCHES = 0
ENERGY_LAUNCHES = 0


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
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: ``(fx, fy)``, or ``(fx, fy, e, w)``
    with ``with_energy``. For each of the 9 neighbour offsets the partner
    grid is the rolled grid plus the seam offset (+-box where the cell row
    or column wraps), and the (cps, a, b, cps) pair block is summed over b.
    Works in any float dtype."""
    cps = p.cps
    idx = torch.arange(cps, device=xg.device)
    xi = xg[:, :, None, :]
    yi = yg[:, :, None, :]
    zero = torch.zeros((), dtype=xg.dtype, device=xg.device)
    fscale = p.fscale
    fx = torch.zeros_like(xg)
    fy = torch.zeros_like(xg)
    if with_energy:
        e = torch.zeros_like(xg)
        w = torch.zeros_like(xg)

    def seam(d):
        # +box where index + d wraps past the top, -box past the bottom
        return ((idx + d >= cps).to(xg.dtype) - (idx + d < 0).to(xg.dtype)) * p.box

    for dx in (-1, 0, 1):
        xr = torch.roll(xg, -dx, 0) + seam(dx)[:, None, None]
        yr = torch.roll(yg, -dx, 0)
        for dy in (-1, 0, 1):
            xp = torch.roll(xr, -dy, 2)[:, None, :, :]
            yp = (torch.roll(yr, -dy, 2) + seam(dy)[None, None, :])[:, None, :, :]
            ddx = xi - xp
            ddy = yi - yp
            r2 = ddx * ddx + ddy * ddy
            valid = (r2 > 0.0) & (r2 < p.cutoff2)
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


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 2
        + [ctypes.c_float] * 6
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check_grid(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous float32 grid of ``shape`` on
    ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def grid_force(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy)`` (or ``(fx, fy, e, w)``) totals on the cell grid."""
    global LAUNCHES, ENERGY_LAUNCHES
    shape = (p.cps, p.cap, p.cps)
    check_grid(xg, "xg", shape, xg.device)
    check_grid(yg, "yg", shape, xg.device)
    if xg.device.type == "cpu":
        return grid_force_reference(xg, yg, p, with_energy)
    if xg.device.type != "cuda":
        raise ValueError(f"grid_force runs on cpu or cuda tensors, not {xg.device}")
    fx = torch.empty_like(xg)
    fy = torch.empty_like(xg)
    e = torch.empty_like(xg) if with_energy else None
    w = torch.empty_like(xg) if with_energy else None
    status = _launcher()(
        xg.data_ptr(), yg.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        e.data_ptr() if with_energy else None,
        w.data_ptr() if with_energy else None,
        p.cps, p.cap, p.box, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift,
        int(with_energy), xg.device.index,
        torch.cuda.current_stream(xg.device).cuda_stream,
    )
    _build.check(status, "cell_force kernel")
    if with_energy:
        ENERGY_LAUNCHES += 1
        return fx, fy, e, w
    LAUNCHES += 1
    return fx, fy


def make_grid_force_kernel(
    grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0, with_energy: bool = False
):
    """``(xg, yg) -> (fx, fy)`` (or ``(fx, fy, e, w)``), the counterpart of
    the JAX package's ``cell_pallas.make_grid_force_kernel``."""
    return functools.partial(
        grid_force, p=CellForceParams.from_grid(grid_fn, sigma, epsilon), with_energy=with_energy
    )
