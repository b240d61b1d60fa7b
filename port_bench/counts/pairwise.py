"""The work of the all-pairs force (kernel B8), counted from N and d alone:
every particle against every other, N^2 (4d + 12) operations (the JAX
package's own cost estimate for its all-pairs kernel, with N for its
padded n_pad: d differences, d minimum-image roundings, d squares and sums,
the reciprocal, s^6, the force magnitude, d products and d sums), the
positions read once and the forces written once."""

from __future__ import annotations

from port_bench.counts import roofline


def force_bound(n: int, dim: int) -> roofline.Bound:
    """Bound of one all-pairs force call (forces only)."""
    return roofline.bound(float(n) * n * (4 * dim + 12), roofline.WORD * n * 2 * dim)
