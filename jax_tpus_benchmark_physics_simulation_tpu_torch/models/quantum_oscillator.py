"""Workload: VMC -> DMC for the D-dimensional quantum harmonic oscillator.

Port of the JAX package's ``models/quantum_oscillator.py`` (reference:
vmc_dmc_jax_quantum_harmonic_oscillator.py): VMC optimizes alpha, then DMC
refines the ground-state energy from the optimized ensemble, continuing
VMC's random stream (vmc_dmc...:217-221). Every epoch and step is eager
PyTorch ops on the device; no custom kernel runs on this path. Physics
oracle: exact E_0 = D/2 at alpha = 0.5 (vmc_dmc...:173-175); the anharmonic
model's is its 1D diagonalization.

Not ported yet: checkpoints (``ckpt_dir``) and ``walker_sharding``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.runner import synchronize
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.adam import tree_leaves
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.dmc import DMCResult, run_dmc
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.models import AnharmonicOscillator, HarmonicOscillator
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.vmc import VMCResult, run_vmc


@dataclass
class QuantumResult:
    vmc: VMCResult
    dmc: DMCResult
    exact_energy: float
    exact_alpha: Optional[float]
    vmc_wall_s: float
    dmc_wall_s: float

    @property
    def vmc_energy(self) -> float:
        return float(self.vmc.energy_history[-1])

    @property
    def vmc_alpha(self) -> float:
        """The ``alpha`` leaf (the first in JAX's sorted-key order)."""
        return float(tree_leaves(self.vmc.params)[0])


def make_model(cfg: VMCDMCConfig):
    """'harmonic' is the reference (vmc_dmc...:30-47); 'anharmonic' the
    generic-trial-psi path."""
    if cfg.potential == "harmonic":
        return HarmonicOscillator(dim=cfg.dim)
    if cfg.potential == "anharmonic":
        return AnharmonicOscillator(dim=cfg.dim, lam=cfg.lam)
    raise ValueError(f"unknown potential: {cfg.potential!r}")


def run(
    cfg: Optional[VMCDMCConfig] = None,
    progress_cb: Optional[Callable[[int, float, float], None]] = None,
    device="cuda",
) -> QuantumResult:
    """VMC, then DMC from its ensemble, on ``device``; each phase's wall
    time ends with a synchronize."""
    cfg = cfg or VMCDMCConfig()
    device = torch.device(device)
    model = make_model(cfg)

    t0 = time.perf_counter()
    vmc_res = run_vmc(model, cfg, progress_cb=progress_cb, device=device)
    synchronize(device)
    vmc_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    dmc_res = run_dmc(model, vmc_res.params, vmc_res.walkers, vmc_res.generator, cfg)
    synchronize(device)
    dmc_wall = time.perf_counter() - t0

    return QuantumResult(
        vmc=vmc_res,
        dmc=dmc_res,
        exact_energy=model.exact_energy(),
        exact_alpha=model.exact_params(),
        vmc_wall_s=vmc_wall,
        dmc_wall_s=dmc_wall,
    )
