"""Kernel B3: 2D Lennard-Jones forces on the lane-packed cell grid.

Replaces the TPU kernel ``ops/kernels/cell_pallas_packed.py:_packed_kernel``
of the JAX package (built by ``make_grid_force_kernel_packed``). It computes
B1's function (``cell_cuda``) on the layout where R consecutive cell rows
share one block: grids are ``(cps / R, cap, R * cps)`` float32 and slot
``(g, a, lane)`` holds slot ``a`` of cell ``(g * R + lane // cps, lane %
cps)``. The TPU's 128-lane padding is gone. The CUDA source is B1's,
``csrc/cell_force.cu``, built with ``PACKED = true``; its header says what
bounds it on an H100.

- :func:`choose_rows_per_block`: the JAX package's packing rule, copied
  (its module imports jax), so both packages pick the same R;
- :func:`grid_force_packed_reference`: the plain PyTorch version, used for
  CPU tensors and as the kernel's reference on the card: B1's plain version
  on the grids unpacked to ``(cps, cap, cps)``;
- :func:`grid_force_packed`: the wrapper. A CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: kernel launches of the force-only and
  the energy variant, counted where the wrapper launches them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import (
    CellForceParams,
    check_grid,
    grid_force_reference,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn

LAUNCHES = 0
ENERGY_LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_rows_per_block(cps: int, max_lanes: int = 4096) -> int:
    """Packing factor for a (cps x cps) cell grid, the JAX package's rule:
    the divisor R of cps maximizing the TPU's lane utilization
    ``R*cps / round_up(R*cps, 128)`` subject to ``R*cps <= max_lanes``,
    smallest R on ties; 1 when packing would gain < 5%. (49 at cps 49, 7 at
    cps 385, 1 at cps 121.)"""
    base_u = cps / _round_up(cps, 128)
    best_r, best_u = 1, base_u
    for r in range(2, cps + 1):
        if cps % r or r * cps > max_lanes:
            continue
        u = (r * cps) / _round_up(r * cps, 128)
        if u > best_u + 1e-9:
            best_r, best_u = r, u
    if best_u < base_u + 0.05:
        return 1
    return best_r


def unpack(g: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """``(cps/R, cap, R*cps)`` packed grid -> ``(cps, cap, cps)``, a copy
    unless R = 1."""
    if rows_per_block == 1:
        return g
    n_blocks, cap, lanes = g.shape
    cps = lanes // rows_per_block
    return g.view(n_blocks, cap, rows_per_block, cps).permute(0, 2, 1, 3).reshape(cps, cap, cps)


def pack(g: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """The inverse of :func:`unpack`."""
    if rows_per_block == 1:
        return g
    cps, cap, _ = g.shape
    n_blocks = cps // rows_per_block
    return (g.view(n_blocks, rows_per_block, cap, cps).permute(0, 2, 1, 3)
            .reshape(n_blocks, cap, rows_per_block * cps))


def grid_force_packed_reference(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, rows_per_block: int,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: ``(fx, fy)``, or ``(fx, fy, e,
    w)`` with ``with_energy``, on the packed layout. The force on a slot
    does not depend on where the slots sit, so this is B1's plain version
    on the unpacked grids, packed back."""
    out = grid_force_reference(unpack(xg, rows_per_block), unpack(yg, rows_per_block), p, with_energy)
    return tuple(pack(t, rows_per_block) for t in out)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 6
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def grid_force_packed(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, rows_per_block: int,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy)`` (or ``(fx, fy, e, w)``) totals on the packed grid."""
    global LAUNCHES, ENERGY_LAUNCHES
    r = rows_per_block
    if r < 1 or p.cps % r:
        raise ValueError(f"rows_per_block {r} must divide cells_per_side {p.cps}")
    shape = (p.cps // r, p.cap, r * p.cps)
    check_grid(xg, "xg", shape, xg.device)
    check_grid(yg, "yg", shape, xg.device)
    if xg.device.type == "cpu":
        return grid_force_packed_reference(xg, yg, p, r, with_energy)
    if xg.device.type != "cuda":
        raise ValueError(f"grid_force_packed runs on cpu or cuda tensors, not {xg.device}")
    fx = torch.empty_like(xg)
    fy = torch.empty_like(xg)
    e = torch.empty_like(xg) if with_energy else None
    w = torch.empty_like(xg) if with_energy else None
    status = _launcher()(
        xg.data_ptr(), yg.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        e.data_ptr() if with_energy else None,
        w.data_ptr() if with_energy else None,
        p.cps, p.cap, r, p.box, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift,
        int(with_energy), xg.device.index,
        torch.cuda.current_stream(xg.device).cuda_stream,
    )
    _build.check(status, "cell_force_packed kernel")
    if with_energy:
        ENERGY_LAUNCHES += 1
        return fx, fy, e, w
    LAUNCHES += 1
    return fx, fy


def make_grid_force_kernel_packed(
    grid_fn: CellGridFn, rows_per_block: int, sigma: float = 1.0, epsilon: float = 1.0,
    with_energy: bool = False,
):
    """``(xg, yg) -> (fx, fy)`` (or ``(fx, fy, e, w)``) on the packed
    layout, the counterpart of the JAX package's
    ``cell_pallas_packed.make_grid_force_kernel_packed``."""
    return functools.partial(
        grid_force_packed, p=CellForceParams.from_grid(grid_fn, sigma, epsilon),
        rows_per_block=rows_per_block, with_energy=with_energy,
    )
