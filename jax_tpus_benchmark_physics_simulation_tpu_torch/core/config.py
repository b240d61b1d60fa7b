"""Typed configuration for the LJ fluid workload.

A copy of ``MDConfig`` and ``override`` from the JAX package's
``core/config.py``, field for field, so a config means the same run in both
packages. It is copied rather than imported because importing anything from
the JAX package imports jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MDConfig:
    """2D Lennard-Jones fluid (reference: molecular_dynamics...:13-31)."""

    n: int = 400
    rho: float = 0.8
    kt: float = 1.0
    dt: float = 1e-3
    eq_steps: int = 10_000
    prod_steps: int = 10_000
    sample_every: int = 100
    seed: int = 42
    dim: int = 2
    sigma: float = 1.0
    epsilon: float = 1.0
    cutoff: Optional[float] = None  # None = full O(N^2) like the reference
    force_impl: str = "auto"  # auto | dense_xla | dense_pallas | neighbor | cell | grid
    dtype: str = "float32"
    rdf_dr: float = 0.05  # molecular_dynamics...:157
    init: str = "uniform"  # uniform (reference) | lattice
    remove_com_drift: bool = False  # reference never removes COM drift
    # Verlet skin. None = auto: 0.4 for the 2D grid engine.
    skin: Optional[float] = None
    pallas_block: int = 256  # B8's tile on the TPU; the port's B8 has its own (256)
    # Kahan-compensated integration (grid path): kills the f32 secular
    # energy drift. Default on: correctness first.
    compensated: bool = True
    # NVT ensemble: "langevin" (BAOAB, grid engine only) | "none" = NVE.
    thermostat: str = "none"
    gamma: float = 1.0  # Langevin friction (1/time units)

    @property
    def box_size(self) -> float:
        return (self.n / self.rho) ** (1.0 / self.dim)


def override(cfg, **kwargs):
    """Return a copy of a frozen config with fields replaced."""
    valid = {f.name for f in dataclasses.fields(cfg)}
    bad = set(kwargs) - valid
    if bad:
        raise TypeError(f"unknown config fields for {type(cfg).__name__}: {sorted(bad)}")
    return dataclasses.replace(cfg, **kwargs)
