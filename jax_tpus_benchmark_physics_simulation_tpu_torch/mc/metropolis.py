"""Metropolis sampling of walker ensembles.

Port of the JAX package's ``mc/metropolis.py`` (reference:
``metropolis_step`` at vmc_dmc...:51-67): a uniform +-step/2 proposal,
accepted with exp(2 delta log psi). Each sweep is two parts: the pure
update (:func:`make_metropolis_update`), which takes its draws, and the
sweep (:func:`make_metropolis_sweep`), which draws them from a
``torch.Generator`` and calls the update, so a test can feed JAX's own
draws into the update. The accept rate stays on the device: no sweep
reads the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def make_metropolis_update(log_psi: Callable, step_size: float):
    """Returns ``update(walkers, params, u_prop, u_acc) -> (walkers,
    accept_rate)``: ``u_prop`` uniform in [-0.5, 0.5), shape ``(n, dim)``;
    ``u_acc`` uniform in [0, 1), shape ``(n,)``."""

    def update(walkers: torch.Tensor, params, u_prop: torch.Tensor, u_acc: torch.Tensor):
        proposal = walkers + step_size * u_prop
        log_ratio = 2.0 * (log_psi(params, proposal) - log_psi(params, walkers))
        accept = u_acc < torch.exp(log_ratio)
        new_walkers = torch.where(accept[:, None], proposal, walkers)
        return new_walkers, torch.mean(accept.to(walkers.dtype))

    return update


def make_metropolis_sweep(log_psi: Callable, step_size: float):
    """Returns ``sweep(walkers, params, generator) -> (walkers,
    accept_rate)``: one Metropolis update of every walker with draws from
    ``generator`` (on the walkers' device)."""
    update = make_metropolis_update(log_psi, step_size)

    def sweep(walkers: torch.Tensor, params, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        n, dim = walkers.shape
        kw = dict(dtype=walkers.dtype, device=walkers.device, generator=generator)
        u_prop = torch.rand((n, dim), **kw) - 0.5
        u_acc = torch.rand((n,), **kw)
        return update(walkers, params, u_prop, u_acc)

    return sweep


def equilibrate(
    sweep: Callable,
    walkers: torch.Tensor,
    params,
    generator: torch.Generator,
    n_sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs ``n_sweeps`` sweeps (vmc_dmc...:73-80). Returns ``(walkers, mean
    accept rate)``, the rate a 0-d tensor on the device."""
    acc = torch.zeros((), dtype=walkers.dtype, device=walkers.device)
    for _ in range(n_sweeps):
        walkers, a = sweep(walkers, params, generator)
        acc = acc + a
    # a tensor divisor: on the card PyTorch multiplies by a Python scalar's reciprocal
    return walkers, acc / torch.full((), float(max(n_sweeps, 1)), dtype=acc.dtype, device=acc.device)
