"""Analytic FLOP models, kept formula-compatible with the reference so
TFLOPS numbers are comparable (tpus_benchmark...:52-57). A copy of the JAX
package's ``bench/flops.py``: the same formulas in both packages.

The 1.1 factor on the matmul ops is the reference's ~10% fudge for the
elementwise chain between the two matmuls (:53) — kept, and documented, so
"TFLOPS" means the same thing in both codebases.
"""

from __future__ import annotations

import math


def matmul_chain_flops(n: int) -> float:
    """Two n^3 matmuls (2n^3 flops each) + ~10% elementwise (reference :52-53)."""
    return (2 * n**3 * 2) * 1.1


def fft2d_flops(n: int) -> float:
    """Reference :55 — 10 N^2 log2 N (fft + ifft + error, 5N log N each-ish)."""
    return 10.0 * n * n * math.log2(n) if n > 1 else 0.0


def fft3d_flops(n: int, depth: int) -> float:
    """Reference :56-57 — 15 N^2 log2 N per depth slice."""
    return (15.0 * n * n * math.log2(n) if n > 1 else 0.0) * depth


def conv_flops(batch: int, size: int, kh: int, kw: int, cin: int, cout: int) -> float:
    """2 * B * H * W * Kh * Kw * Cin * Cout (SAME padding, stride 1)."""
    return 2.0 * batch * size * size * kh * kw * cin * cout
