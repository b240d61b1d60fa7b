"""Typed configuration for the ported workloads.

Copies of ``MDConfig``, ``NBodyConfig``, ``EM3Config``, ``VMCDMCConfig``,
``BenchConfig`` and ``override`` from the JAX package's ``core/config.py``,
field for field with the same defaults, so a config means the same run in
both packages. They are copied
rather than imported because importing anything from the JAX package
imports jax. ``BenchConfig`` has no device field: the device travels as an
argument.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


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


@dataclass(frozen=True)
class NBodyConfig:
    """N-body BH merger (reference interactive prompts nbody...:29-39)."""

    n_bodies: int = 3
    masses: tuple = (30.0, 30.0, 30.0)
    initial_distance: float = 100.0
    initial_velocity: float = 0.1
    sim_time: float = 200.0
    d_gw_mpc: float = 410.0
    num_steps: int = 1000  # hardcoded at nbody...:113
    compute_chaos: bool = True
    g: float = 1.0
    c: float = 1.0
    lyapunov_method: str = "tangent"  # tangent (variational) | two_trajectory (reference)
    integrator: str = "rk4"  # rk4 (reference) | dopri5 (adaptive)
    rtol: float = 1e-6  # dopri5 tolerances
    atol: float = 1e-9


@dataclass(frozen=True)
class EM3Config:
    """Three-particle gravity + non-uniform EM (three_particles...:9-17)."""

    dt: float = 0.01
    n_steps: int = 1000
    g: float = 1.0
    bz: float = 1.0
    bk: float = 0.0
    ex: float = 0.0
    ey: float = 0.0
    # "boris" (default, correct for the velocity-dependent magnetic force) |
    # "reference": the reference's pseudo-Verlet (three_particles...:69-76)
    integrator: str = "boris"


@dataclass(frozen=True)
class VMCDMCConfig:
    """VMC/DMC quantum harmonic oscillator (vmc_dmc...:347-361).

    ``epoch_chunk``: epochs between host reads (progress, snapshots and the
    histories' chunks); in the JAX package also the scan length fused into
    one device program, here every epoch is eager ops. ``prng_impl``: kept
    so a config means the same in both packages, but it selects nothing
    here: every draw comes from a ``torch.Generator`` (mt19937 on the CPU,
    Philox on the card).
    """

    n_walkers: int = 10_000
    n_epochs: int = 3000
    n_equil: int = 100
    step_size: float = 2.0
    lr: float = 0.02
    n_dmc: int = 500
    dmc_dt: float = 0.01
    dim: int = 3
    seed: int = 42
    alpha_init: float = 1.0
    alpha_min: float = 0.01  # clamp at vmc_dmc...:94
    resampler: str = "systematic"  # systematic | multinomial (reference)
    epoch_chunk: int = 50
    snapshot_every: int = 0  # 0 = no walker snapshots; >0 for GIF frames
    prng_impl: str = "auto"  # accepted, ignored (see above)
    # harmonic (reference) | anharmonic (V += lam*sum x^4, autodiff local
    # energy, {alpha, beta} trial)
    potential: str = "harmonic"
    lam: float = 0.2  # quartic coupling for potential="anharmonic"


@dataclass(frozen=True)
class BenchConfig:
    """Op benchmark suite (tpus_benchmark...:28-47).

    ``warmup``: untimed executions of the timing loop (each covers ``steps``
    op iterations); ``repeats``: timed executions (best-of). The conv
    defaults (64x128x128x32 -> 64) are sized compute-bound, unlike the
    reference's never-run 8x64x64x3 conv. ``ops``: None = all ops, else
    case-insensitive op names to run (e.g. ``("2D", "Bandwidth")``).
    """

    warmup: int = 1
    repeats: int = 3
    steps: int = 2500
    matrix_size: int = 4096
    matrix_depth: int = 6
    conv_size: int = 128
    batch_size: int = 64
    conv_cin: int = 32
    conv_cout: int = 64
    precision: str = "float32"  # float32 | bfloat16
    max_cores: int = 0  # 0 = auto up to available
    ops: Optional[Tuple[str, ...]] = None
    csv: Optional[str] = None
    plot: Optional[str] = "tpu_benchmark_results.png"


def override(cfg, **kwargs):
    """Return a copy of a frozen config with fields replaced."""
    valid = {f.name for f in dataclasses.fields(cfg)}
    bad = set(kwargs) - valid
    if bad:
        raise TypeError(f"unknown config fields for {type(cfg).__name__}: {sorted(bad)}")
    return dataclasses.replace(cfg, **kwargs)
