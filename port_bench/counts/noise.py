"""The work of the Langevin noise kernel (``langevin_noise_kernel<D>``),
counted from the grid's shape: it reads the int32 particle-id plane and
writes D float32 noise planes, ``(4 + 4 D)`` bytes a grid slot (28.5 MB at
``lj2d-nvt-n1m``'s 2,371,600 slots in 2D, 8.5 us at 3.35 TB/s), each byte
once.

Beside it, the operations, which the roofline share does not use (the
bytes bound the kernel by far): one Philox4x32-10 call a particle, 98
integer operations (10 rounds of two 32 x 32 -> 64 products, a low and a
high half each, and four xors; nine key bumps of two adds), and Box-Muller
on D / 2 rounded up word pairs: ~0.1 G integer operations a launch at
N=1M, ~1.5 us at the float32 peak's rate and ~3 us at the half rate of the
card's integer multiplies, under the 8.5 us of bytes."""

from __future__ import annotations

from port_bench.counts import roofline

PHILOX_OPS = 10 * (2 * 2 + 4) + 9 * 2  # 98 a call


def noise_bound(dim: int, n_slots: int) -> roofline.Bound:
    """Bound of one noise launch over ``n_slots`` grid slots."""
    return roofline.bound(0.0, roofline.WORD * (1 + dim) * n_slots)
