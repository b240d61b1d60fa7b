"""Thermodynamic observables (port of the JAX package's ``thermo.py``)."""

from __future__ import annotations

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass[:, None] * state.velocity**2)


def temperature(state: ParticleState) -> torch.Tensor:
    """Instantaneous kT from equipartition: 2 KE / (N * dim)."""
    n, d = state.position.shape
    return 2.0 * kinetic_energy(state) / (n * d)
