"""Lyapunov exponent estimation.

Port of the JAX package's ``ops/observables/lyapunov.py``:

- :func:`lyapunov_tangent`: the Benettin tangent-space method, a unit
  perturbation pushed through the forward-mode derivative of the step
  function each step (``jax.jvp`` inside a ``lax.scan`` in JAX),
  renormalized, with the log stretch factors summed. The derivative is
  ``torch.autograd.forward_ad``'s dual tensors, the mechanism under
  ``torch.func.jvp``, which gives the same numbers but wraps every call
  (five times the host time a step on a CPU). A random start direction comes from a
  ``torch.Generator`` in place of a ``jax.random`` key: the same seed gives
  other numbers than JAX.
- :func:`lyapunov_two_trajectory`: the reference's estimator (lambda = mean
  over t of log(delta(t)/d0)/t), for parity checks.

The constant ``d0`` is a 0-d tensor where it divides: PyTorch computes
``tensor / python_float`` and ``python_float / tensor`` other than as one
IEEE division on some devices, and JAX divides.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD


def initial_tangent(
    flat0: torch.Tensor, d0: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """The start perturbation: ``d0`` along the first coordinate (nbody...:178)
    or, with a generator, ``d0`` times a random unit vector."""
    if generator is None:
        delta0 = torch.zeros_like(flat0)
        delta0[0] = d0
        return delta0
    v = torch.randn(flat0.shape, generator=generator, dtype=flat0.dtype, device=flat0.device)
    return d0 * v / torch.sqrt(torch.sum(v * v))


def jvp(fn: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor, v: torch.Tensor):
    """``(fn(y), J_fn(y) v)`` by forward-mode differentiation."""
    with fwAD.dual_level():
        out = fwAD.unpack_dual(fn(fwAD.make_dual(y, v)))
        return out.primal, out.tangent


def lyapunov_tangent(
    step_fn: Callable[[torch.Tensor], torch.Tensor],
    state0: torch.Tensor,
    num_steps: int,
    dt: float,
    d0: float = 1e-6,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Largest Lyapunov exponent via the variational (tangent-space) method.

    ``step_fn`` maps a flat state to the next (time-independent step).
    Returns lambda_max = (1 / (num_steps * dt)) * sum_k log(||J delta_k|| / d0).
    """
    d0_t = torch.tensor(d0, dtype=state0.dtype, device=state0.device)
    delta = initial_tangent(state0, d0, generator)
    y = state0
    log_stretches = torch.empty(num_steps, dtype=state0.dtype, device=state0.device)
    for k in range(num_steps):
        y, jdelta = jvp(step_fn, y, delta)
        norm = torch.sqrt(torch.sum(jdelta * jdelta))
        log_stretches[k] = torch.log(norm / d0_t)
        delta = jdelta * (d0_t / torch.clamp(norm, min=1e-300))
    return torch.sum(log_stretches) / (num_steps * dt)


def lyapunov_two_trajectory(
    t: torch.Tensor,  # (T,)
    traj: torch.Tensor,  # (T, state_dim) flat trajectories
    traj_pert: torch.Tensor,  # (T, state_dim)
    d0: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference estimator (nbody...:197-206).

    Returns ``(lyap, n_valid)``; lambda = mean over valid t of
    log(delta(t)/d0)/t with validity mask t > 1e-10 and delta > 1e-15.
    """
    diff = traj - traj_pert
    delta = torch.sqrt(torch.sum(diff * diff, dim=1))
    valid = (t > 1e-10) & (delta > 1e-15)
    d0_t = torch.tensor(d0, dtype=delta.dtype, device=delta.device)
    logs = torch.log(torch.clamp(delta, min=1e-300) / d0_t) / torch.where(valid, t, 1.0)
    vals = torch.where(valid, logs, 0.0)
    n_valid = torch.sum(valid)
    lyap = torch.sum(vals) / torch.clamp(n_valid, min=1)
    return lyap, n_valid
