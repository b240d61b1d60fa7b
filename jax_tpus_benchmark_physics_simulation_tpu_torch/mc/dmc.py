"""Diffusion Monte Carlo with on-device branching.

Port of the JAX package's ``mc/dmc.py`` (reference: ``dmc_step_body`` and
its ``lax.scan``, vmc_dmc...:238-280), single-device branch. Per step: local
energies -> weights exp(-(E_L - E_ref) dt) -> sanitize -> resample
(branching, population fixed) -> drift + diffusion move. JAX's scan is a
host loop of eager steps here; nothing in a step reads the host. Walker
snapshots come at a stride (``snapshot_every``), as in JAX.

Each step is two parts, as in ``mc/metropolis.py``: the pure update
(:func:`make_dmc_update`, which takes the resampler's uniforms and the
diffusion's normals) and the step, which draws them. Not ported yet: the
sharded DMC (``walker_sharding``, shard-local branching).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.resampling import RESAMPLERS_FROM


@dataclass
class DMCResult:
    walkers: torch.Tensor  # final ensemble (n_walkers, dim)
    energy_history: torch.Tensor  # E_ref per step, (n_steps,)
    walker_snapshots: Optional[torch.Tensor]  # (n_snaps, n_walkers, dim) or None

    def mean_energy(self, burn_in: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean +- standard error after burn-in (vmc_dmc...:317-321): the
        population std (``jnp.std``'s ddof 0, its formula: the mean of the
        squared deviations) over a float32 sqrt of the count; NaN when
        nothing is left after burn-in, as in JAX."""
        e = self.energy_history[burn_in:]
        n = torch.full((), float(e.shape[0]), dtype=e.dtype, device=e.device)
        mean = torch.sum(e) / n
        c = e - mean
        return mean, torch.sqrt(torch.sum(c * c) / n) / torch.sqrt(n)


def make_dmc_update(model, params, dt: float, resampler: str = "systematic"):
    """``update(walkers, u, noise) -> (walkers, E_ref)``: one DMC step at
    given draws, ``u`` the resampler's uniforms (``(n,)`` multinomial, 0-d
    systematic) and ``noise`` standard normals ``(n, dim)``."""
    resample = RESAMPLERS_FROM[resampler]
    # jnp.sqrt(dt): a float32 square root of float32(dt), exact in a Python float
    sqrt_dt = float(np.sqrt(np.float32(dt)))

    def update(walkers: torch.Tensor, u: torch.Tensor, noise: torch.Tensor):
        e_local = model.local_energy(params, walkers)
        e_ref = torch.mean(e_local)
        weights = torch.exp(-(e_local - e_ref) * dt)
        walkers = resample(walkers, weights, u)
        drift = model.drift_force(params, walkers) * dt
        walkers = walkers + drift + noise * sqrt_dt
        return walkers, e_ref

    return update


def make_dmc_step(model, params, dt: float, resampler: str = "systematic"):
    """One DMC step: ``step(walkers, generator) -> (walkers, E_ref)``, the
    resampler's uniforms drawn first, then the diffusion's normals."""
    update = make_dmc_update(model, params, dt, resampler)

    def step(walkers: torch.Tensor, generator: torch.Generator):
        n, dim = walkers.shape
        kw = dict(dtype=walkers.dtype, device=walkers.device, generator=generator)
        u = torch.rand((n,) if resampler == "multinomial" else (), **kw)
        noise = torch.randn((n, dim), **kw)
        return update(walkers, u, noise)

    return step


def _make_program(step, cfg: VMCDMCConfig):
    """The whole run, ``program(walkers, generator) -> (walkers, e_hist,
    snaps-or-None)``. With ``0 < snapshot_every <= n_dmc`` a snapshot
    follows every ``snapshot_every`` steps, and the remainder steps run
    after the last."""
    snap_every = cfg.snapshot_every
    with_snaps = bool(snap_every) and 0 < snap_every <= cfg.n_dmc
    last_snap = (cfg.n_dmc // snap_every) * snap_every if with_snaps else 0

    def program(walkers: torch.Tensor, generator: torch.Generator):
        e_refs, snaps = [], []
        for i in range(1, cfg.n_dmc + 1):
            walkers, e_ref = step(walkers, generator)
            e_refs.append(e_ref)
            if with_snaps and i % snap_every == 0 and i <= last_snap:
                snaps.append(walkers)
        e_hist = torch.stack(e_refs) if e_refs else walkers.new_zeros((0,))
        return walkers, e_hist, (torch.stack(snaps) if with_snaps else None)

    return program


def run_dmc(model, params, walkers: torch.Tensor, generator: torch.Generator, cfg: VMCDMCConfig) -> DMCResult:
    """Whole DMC run from ``walkers``, drawing from ``generator`` (on the
    walkers' device)."""
    step = make_dmc_step(model, params, cfg.dmc_dt, cfg.resampler)
    walkers, e_hist, snaps = _make_program(step, cfg)(walkers, generator)
    return DMCResult(walkers=walkers, energy_history=e_hist, walker_snapshots=snaps)
