"""Random streams of the port.

The JAX package's ``make_key(seed, impl)`` picks a PRNG implementation
(rbg on a TPU, threefry elsewhere), a TPU speed choice. Here every draw
comes from a seeded ``torch.Generator`` on the device that draws: mt19937
on the CPU, Philox on the card, so the two devices give different numbers
from one seed (and both differ from ``jax.random``). The grid engines'
Langevin noise is the exception: counter-based, keyed by particle and
step (``ops/kernels/noise_cuda.py``), the same on both devices to float32
rounding. ``VMCDMCConfig.prng_impl``
is accepted and selects nothing.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)
