"""Variational Monte Carlo with REINFORCE-style parameter optimization.

Port of the JAX package's ``mc/vmc.py`` (reference: ``vmc_epoch_step`` and
its host epoch loop, vmc_dmc...:69-97, 141-170). JAX scans ``epoch_chunk``
epochs in one device program; here every epoch is eager ops, and
``epoch_chunk`` only sets how often the host reads progress, snapshots and
the histories' chunks. Nothing in an epoch reads the host.

Gradient estimator (reference :86-89):
  grad E = 2 < (E_L - <E_L>) * d(log psi)/d(theta) >
with the per-walker gradient from ``torch.func.vmap(torch.func.grad(log_psi))``
and optax's Adam written op for op (``mc/adam.py``). After the Adam step
every leaf is clamped at ``alpha_min``, ``beta`` too, as in JAX
(``jax.tree.map`` over the params).

Not ported yet: ``ckpt_dir`` (checkpoints) and ``walker_sharding``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.adam import (
    AdamState,
    adam_init,
    adam_update,
    apply_updates,
    tree_leaves,
    tree_map,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.metropolis import equilibrate, make_metropolis_sweep
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.prng import make_generator


@dataclass
class VMCResult:
    params: Any  # optimized variational parameters (alpha, or {alpha, beta})
    walkers: torch.Tensor  # final walker ensemble
    generator: torch.Generator  # the stream, carried on into DMC (JAX: the key)
    energy_history: torch.Tensor  # (n_epochs,)
    params_history: Any  # (n_epochs,) per leaf
    grad_history: Any  # (n_epochs,) per leaf
    accept_history: torch.Tensor  # (n_epochs,)
    walker_snapshots: Optional[torch.Tensor] = None  # (n_snapshots, n_walkers, dim)


def make_epoch_step(model, cfg: VMCDMCConfig):
    """One VMC epoch: ``n_equil`` Metropolis sweeps, energy and REINFORCE
    gradient, the Adam update, the params clamp (vmc_dmc...:94).
    ``epoch_step(walkers, params, generator, opt_state) -> ((walkers,
    params, opt_state), (e_mean, params, grad_e, accept))``."""
    sweep = make_metropolis_sweep(model.log_psi, cfg.step_size)

    def epoch_step(walkers, params, generator: torch.Generator, opt_state: AdamState):
        walkers, accept = equilibrate(sweep, walkers, params, generator, cfg.n_equil)
        energies = model.local_energy(params, walkers)  # (n_walkers,)
        e_mean = torch.mean(energies)
        # REINFORCE over any params tree: per-walker d log psi / d params,
        # contracted with the centered energies along the walker axis
        per_walker_grad = torch.func.vmap(torch.func.grad(model.log_psi, argnums=0), in_dims=(None, 0))(
            params, walkers)
        centered = energies - e_mean
        # a tensor divisor: on the card PyTorch multiplies by a Python scalar's reciprocal
        n_w = torch.full((), float(energies.shape[0]), dtype=energies.dtype, device=energies.device)
        grad_e = tree_map(lambda g: 2.0 * torch.tensordot(centered, g, dims=([0], [0])) / n_w, per_walker_grad)
        updates, opt_state = adam_update(grad_e, opt_state, cfg.lr)
        params = apply_updates(params, updates)
        params = tree_map(lambda p: torch.clamp_min(p, cfg.alpha_min), params)
        return (walkers, params, opt_state), (e_mean, params, grad_e, accept)

    return epoch_step


def _along(fn, trees: list):
    """``fn`` (``torch.stack`` or ``torch.cat``) over a list of trees, leaf by
    leaf."""
    return tree_map(lambda *xs: fn(xs), trees[0], *trees[1:])


def run_vmc(
    model,
    cfg: VMCDMCConfig,
    generator: Optional[torch.Generator] = None,
    progress_cb: Optional[Callable[[int, float, float], None]] = None,
    device="cuda",
) -> VMCResult:
    """Full VMC optimization on ``device`` (the generator's device when one
    is given). ``progress_cb(epoch, energy, alpha)`` is called once a chunk
    of ``epoch_chunk`` epochs, the host's only reads; with
    ``snapshot_every`` the chunk is the gcd of both, so every requested
    snapshot epoch ends a chunk."""
    if generator is None:
        generator = make_generator(cfg.seed, device)
    device = generator.device
    walkers = torch.randn((cfg.n_walkers, cfg.dim), dtype=torch.float32, device=device, generator=generator)
    # richer trial wavefunctions provide their own params (the anharmonic
    # model's {alpha, beta}); the reference model is a bare alpha
    if hasattr(model, "init_params"):
        params = model.init_params(cfg.alpha_init, device=device)
    else:
        params = torch.tensor(cfg.alpha_init, dtype=torch.float32, device=device)
    opt_state = adam_init(params)
    epoch_step = make_epoch_step(model, cfg)

    chunk = max(1, cfg.epoch_chunk)
    if cfg.snapshot_every:
        chunk = math.gcd(chunk, cfg.snapshot_every)
    e_hist, p_hist, g_hist, a_hist, snapshots = [], [], [], [], []
    done = 0
    while done < cfg.n_epochs:
        n = min(chunk, cfg.n_epochs - done)
        records = []
        for _ in range(n):
            (walkers, params, opt_state), rec = epoch_step(walkers, params, generator, opt_state)
            records.append(rec)
        es, ps, gs, accs = (_along(torch.stack, [r[i] for r in records]) for i in range(4))
        e_hist.append(es)
        p_hist.append(ps)
        g_hist.append(gs)
        a_hist.append(accs)
        done += n
        if cfg.snapshot_every and (done % cfg.snapshot_every == 0 or done == cfg.n_epochs):
            snapshots.append(walkers)
        if progress_cb is not None:
            progress_cb(done, float(es[-1]), float(tree_leaves(ps)[0][-1]))
    if not e_hist:  # no epoch ran: one probe epoch fills the histories, its carry is dropped (as JAX)
        _, (es, ps, gs, accs) = epoch_step(walkers, params, generator, opt_state)
        e_hist, p_hist, g_hist, a_hist = ([_along(torch.stack, [x])] for x in (es, ps, gs, accs))

    return VMCResult(
        params=params,
        walkers=walkers,
        generator=generator,
        energy_history=torch.cat(e_hist),
        params_history=_along(torch.cat, p_hist),
        grad_history=_along(torch.cat, g_hist),
        accept_history=torch.cat(a_hist),
        walker_snapshots=torch.stack(snapshots) if snapshots else None,
    )
