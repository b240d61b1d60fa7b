"""Integrators (port of the JAX package's ``ops/integrators.py``): velocity
Verlet as ``state -> state`` step functions, and classic RK4 on a flat ODE
vector for the n-body workload. The Boris push and the reference EM step
belong to the EM three-body workload and are not ported yet."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState

ForceFn = Callable[[torch.Tensor], torch.Tensor]  # R -> F, shape (N, D)


def velocity_verlet(
    force_fn: ForceFn, dt: float, wrap_fn: Optional[Callable] = None
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)``. ``init_fn`` fills the cached force;
    ``step_fn`` makes one kick-drift-kick step from the cached force, with
    one ``force_fn`` call a step."""

    def init_fn(state: ParticleState) -> ParticleState:
        return state.replace(force=force_fn(state.position))

    def step_fn(state: ParticleState) -> ParticleState:
        inv_m = 1.0 / state.mass[:, None]
        v_half = state.velocity + 0.5 * dt * state.force * inv_m
        r_new = state.position + dt * v_half
        if wrap_fn is not None:
            r_new = wrap_fn(r_new)
        f_new = force_fn(r_new)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        return state.replace(position=r_new, velocity=v_new, force=f_new, time=state.time + dt)

    return init_fn, step_fn


def rk4_step_fn(ode_fn: Callable, dt: float) -> Callable:
    """Classic fixed-step RK4 ``step(y, t)`` for ``dy/dt = ode_fn(t, y)`` on
    a flat tensor ``y``, with the JAX package's k-combination order (that of
    nbody...:79-85): each stage coefficient is a Python float times a
    tensor, the final sum ``((k1 + 2 k2) + 2 k3) + k4``."""

    def step(y: torch.Tensor, t):
        k1 = ode_fn(t, y)
        k2 = ode_fn(t + 0.5 * dt, y + 0.5 * dt * k1)
        k3 = ode_fn(t + 0.5 * dt, y + 0.5 * dt * k2)
        k4 = ode_fn(t + dt, y + dt * k3)
        return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return step
