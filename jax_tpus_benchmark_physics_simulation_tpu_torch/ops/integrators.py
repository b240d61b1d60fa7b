"""Integrators (port of the JAX package's ``ops/integrators.py``): velocity
Verlet as ``state -> state`` step functions, classic RK4 on a flat ODE
vector for the n-body workload, and for the EM three-body workload the
Boris push (``boris2d``) and the reference's pseudo-Verlet
(``em_reference_step``, a parity oracle), each with JAX's op order."""

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


def boris2d(
    position_accel_fn: Callable[[torch.Tensor], torch.Tensor],
    b_field_fn: Callable[[torch.Tensor], torch.Tensor],
    dt: float,
) -> Tuple[Callable, Callable]:
    """Boris push: half electric/gravity kick, magnetic rotation, half kick,
    drift (replaces the reference's improper scheme, three_particles...:69-76).

    ``position_accel_fn(R)`` gives the velocity-independent acceleration
    (gravity + qE/m); ``b_field_fn(R)`` gives q B_z / m per particle, (N,).
    Returns ``(init_fn, step_fn)``."""

    def init_fn(state: ParticleState) -> ParticleState:
        return state

    def rotate(v: torch.Tensor, omega_dt_half: torch.Tensor) -> torch.Tensor:
        # t = tan(theta/2) ~ omega dt/2, s = 2t/(1+t^2), a tensor over a
        # tensor (one IEEE division, as in JAX); v x zhat = (v_y, -v_x)
        t = omega_dt_half
        s = 2.0 * t / (1.0 + t * t)
        v_cross = torch.stack([v[:, 1], -v[:, 0]], dim=1)
        v_prime = v + v_cross * t[:, None]
        vp_cross = torch.stack([v_prime[:, 1], -v_prime[:, 0]], dim=1)
        return v + vp_cross * s[:, None]

    def step_fn(state: ParticleState) -> ParticleState:
        a_pos = position_accel_fn(state.position)
        omega = b_field_fn(state.position)  # q B_z / m
        v_minus = state.velocity + 0.5 * dt * a_pos
        v_plus = rotate(v_minus, 0.5 * dt * omega)
        v_new = v_plus + 0.5 * dt * a_pos
        r_new = state.position + dt * v_new
        return state.replace(position=r_new, velocity=v_new, time=state.time + dt)

    return init_fn, step_fn


def em_reference_step(accel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], dt: float) -> Callable:
    """The reference's step (three_particles...:69-76): half-kick, drift,
    recompute a(R_new, V_half), half-kick."""

    def step_fn(state: ParticleState) -> ParticleState:
        acc = accel_fn(state.position, state.velocity)
        v_half = state.velocity + 0.5 * dt * acc
        r_new = state.position + dt * v_half
        acc_new = accel_fn(r_new, v_half)
        v_new = v_half + 0.5 * dt * acc_new
        return state.replace(position=r_new, velocity=v_new, time=state.time + dt)

    return step_fn
