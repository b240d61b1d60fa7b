"""Workload: N charged particles under mutual gravity + non-uniform EM field.

Port of the JAX package's ``models/em_three_particles.py`` (reference:
three_particles_em_nonuni_single-host_workload.py). JAX's one ``lax.scan``
over the steps is a host loop of eager steps here
(``core/runner.run_trajectory_with_initial``), with the same ``(n_steps +
1, N, 2)`` trajectory. No custom kernel runs on this path: at three
particles every op is launch latency.

Default integrator is a Boris push (correct for velocity-dependent magnetic
forces); ``integrator="reference"`` reproduces the reference's pseudo-Verlet
(:69-76) for parity testing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import EM3Config
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.runner import run_trajectory_with_initial, synchronize
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.em import Lorentz2D
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.gravity import Gravity
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators import boris2d, em_reference_step


def default_initial_state(dtype=torch.float32, device="cuda") -> ParticleState:
    """Reference initial conditions (three_particles...:87-91): unit-mass,
    unit-charge particles on an equilateral triangle with circulating
    velocities."""
    kw = dict(dtype=dtype, device=device)
    pos = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.5, 0.866]], **kw)
    vel = torch.tensor([[0.0, 0.1], [0.0, -0.1], [-0.1, 0.0]], **kw)
    return ParticleState.create(pos, vel, mass=torch.ones(3, **kw), charge=torch.ones(3, **kw))


def build_step(cfg: EM3Config, state: ParticleState):
    """Returns ``(init_fn, step_fn)`` for the configured integrator."""
    gravity = Gravity(g=cfg.g, mode="r2_floor")
    em = Lorentz2D(bz=cfg.bz, bk=cfg.bk, ex=cfg.ex, ey=cfg.ey)
    mass, charge = state.mass, state.charge

    if cfg.integrator == "boris":
        def pos_accel(r):
            qm = charge / mass
            return gravity.acceleration(r, mass) + qm[:, None] * em.e_field(r)

        def omega(r):  # q B_z / m per particle
            return (charge / mass) * em.b_field(r)

        return boris2d(pos_accel, omega, cfg.dt)

    if cfg.integrator == "reference":
        def accel(r, v):
            return gravity.acceleration(r, mass) + em.acceleration(r, v, mass, charge)

        return (lambda s: s), em_reference_step(accel, cfg.dt)

    raise ValueError(f"unknown integrator: {cfg.integrator}")


def simulate(cfg: EM3Config, state: ParticleState):
    """Runs ``cfg.n_steps`` steps. Returns ``(final_state, trajectory)`` with
    trajectory shape ``(n_steps + 1, N, 2)`` (initial frame first, the
    reference's layout at :81-85)."""
    init_fn, step_fn = build_step(cfg, state)
    state = init_fn(state)
    return run_trajectory_with_initial(step_fn, state, cfg.n_steps, observe_fn=lambda s: s.position)


@dataclass
class EM3Result:
    trajectory: torch.Tensor  # (n_steps + 1, N, 2)
    final_state: ParticleState
    wall_time_s: float


def run(cfg: Optional[EM3Config] = None, state: Optional[ParticleState] = None, device="cuda") -> EM3Result:
    """One untimed ``simulate`` (warm-up), then a timed one between two
    synchronizes: the reference's warm-up-then-measure rule. ``state``
    defaults to :func:`default_initial_state` on ``device`` (float32); a
    given state runs on its own device."""
    cfg = cfg or EM3Config()
    state = state if state is not None else default_initial_state(device=device)
    device = state.position.device

    simulate(cfg, state)
    synchronize(device)

    t0 = time.perf_counter()
    final, traj = simulate(cfg, state)
    synchronize(device)
    wall = time.perf_counter() - t0

    return EM3Result(trajectory=traj, final_state=final, wall_time_s=wall)
