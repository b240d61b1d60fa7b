"""Variational and diffusion Monte Carlo (port of the JAX package's ``mc``):
the same exports."""

from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.models import (
    HarmonicOscillator,
    generic_local_energy,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.metropolis import (
    make_metropolis_sweep,
    equilibrate,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.resampling import (
    resample_multinomial,
    resample_systematic,
    RESAMPLERS,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.vmc import run_vmc, VMCResult
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.dmc import run_dmc, DMCResult

__all__ = [
    "HarmonicOscillator",
    "generic_local_energy",
    "make_metropolis_sweep",
    "equilibrate",
    "resample_multinomial",
    "resample_systematic",
    "RESAMPLERS",
    "run_vmc",
    "VMCResult",
    "run_dmc",
    "DMCResult",
]
