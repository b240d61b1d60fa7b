"""The least time an H100 could take for a kernel's work: the larger of the
operations over the card's float32 peak and the bytes over its memory rate.

:func:`bound` is the rule; :func:`pairwise_bounds` and
:func:`gravity_bounds` count the all-pairs kernels' work (B8, B9), which
depends on N and d alone. ``chip_smoke.py`` counts the cell-grid kernels'
work on each run's own state.
"""

from __future__ import annotations

from typing import Tuple

# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
# rsqrt results a second on the special-function units: 16 a clock an SM
# (the CUDA programming guide's throughput table, compute capability 9.0),
# 132 SMs, the H100 SXM's 1.98 GHz boost clock
SFU_RSQRT_PER_S = 16 * 132 * 1.98e9

Bound = Tuple[float, str]


def bound(flops: float, nbytes: float) -> Bound:
    """``(bound_ms, bound_by)``: the larger of the operations over the
    float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def pairwise_bounds(n: int, dim: int) -> Tuple[Bound, Bound]:
    """Bounds of B8 and its energy variant: N^2 (4d + 12) operations, the
    JAX package's own cost estimate for the all-pairs kernel
    (pairwise_pallas.py:139-143) with N for its padded n_pad, and 4 more a
    pair with the energy (s12 - s6, the 4 eps product, the shift, the sum);
    the positions in, the forces (and energies) out."""
    pairs = float(n) * n
    return (bound(pairs * (4 * dim + 12), 4 * n * 2 * dim),
            bound(pairs * (4 * dim + 16), 4 * n * (2 * dim + 1)))


def gravity_bounds(n: int, dim: int) -> Tuple[Bound, Bound]:
    """Bounds of B9 and its potential variant: N^2 (5d + 4) operations (d
    differences, d squares and d sums with the softening, the rsqrt, two
    products for inv_r^3, g m_j times inv_r^3, d products and d sums; g m_j
    is formed once per j and the j == i selects are not operations), N^2
    (5d + 6) with the potential (its product and sum); positions and masses
    in, accelerations (and potentials) out."""
    pairs = float(n) * n
    return (bound(pairs * (5 * dim + 4), 4 * n * (2 * dim + 1)),
            bound(pairs * (5 * dim + 6), 4 * n * (2 * dim + 2)))


def rsqrt_ms(n: int) -> float:
    """B9's second floor: one rsqrt a pair, N^2 of them, on the
    special-function units."""
    return 1e3 * float(n) * n / SFU_RSQRT_PER_S
