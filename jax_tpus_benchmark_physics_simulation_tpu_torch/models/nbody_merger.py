"""Workload: N-body black-hole merger with GW waveform + Lyapunov exponent.

Port of the JAX package's ``models/nbody_merger.py``: RK4 (or adaptive
dopri5) on the flat state ``[pos (2n), vel (2n)]`` with the dense
``Gravity(mode="min_distance")`` acceleration, the GW strain on the
trajectory, and the Lyapunov exponent (tangent method through
``torch.func.jvp``, or the reference's two trajectories).

JAX's ``lax.scan`` over the steps is a host loop here, one RK4 step (four
ODE evaluations, each a few dozen small ops on n bodies) after another, its
output written in place into a preallocated ``(T, 4n)`` trajectory. No
custom kernel runs on this path: at n = 3 every op is launch latency.
Checkpointing (``ckpt_dir`` in JAX) is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import NBodyConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.runner import synchronize
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.gravity import Gravity
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators import rk4_step_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators_adaptive import dopri5_integrate
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.gw import gw_strain
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.lyapunov import (
    lyapunov_tangent,
    lyapunov_two_trajectory,
)


def init_state_flat(cfg: NBodyConfig, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Reference ICs (nbody...:99-108): bodies on a ring of diameter
    ``initial_distance`` with tangential velocities, in the ``[pos...,
    vel...]`` layout; built in float64 with numpy and rounded to ``dtype``,
    as the JAX package's ``jnp.asarray`` does (float32, or float64 under
    ``jax_enable_x64``)."""
    n = cfg.n_bodies
    pos = np.zeros((n, 2))
    vel = np.zeros((n, 2))
    for i in range(n):
        angle = 2 * np.pi * i / n
        pos[i] = [cfg.initial_distance * np.cos(angle) / 2, cfg.initial_distance * np.sin(angle) / 2]
        vel[i] = [-cfg.initial_velocity * np.sin(angle), cfg.initial_velocity * np.cos(angle)]
    flat = np.concatenate([pos.ravel(), vel.ravel()])
    return torch.from_numpy(flat).to(device=device, dtype=dtype)


def time_grid(cfg: NBodyConfig, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The output times ``0, dt, ..., sim_time`` (``jnp.linspace`` in JAX;
    in float32 a third of the points differ from it in the last bit)."""
    return torch.linspace(0.0, cfg.sim_time, cfg.num_steps + 1, dtype=dtype, device=device)


def make_ode(cfg: NBodyConfig, masses: torch.Tensor):
    """dy/dt for flat y = [pos (2n), vel (2n)] (reference layout nbody...:69-77)."""
    n = cfg.n_bodies
    gravity = Gravity(g=cfg.g, mode="min_distance")

    def ode(t, y):
        pos = y[: 2 * n].reshape(n, 2)
        vel = y[2 * n :].reshape(n, 2)
        acc = gravity.acceleration(pos, masses)
        return torch.cat([vel.reshape(-1), acc.reshape(-1)])

    return ode


def simulate(cfg: NBodyConfig, y0: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    """The full trajectory on the output grid, ``(num_steps + 1, 4n)`` with
    ``y0`` first. ``rk4``: fixed steps, the reference's arithmetic;
    ``dopri5``: adaptive embedded RK45 to each output time."""
    ode = make_ode(cfg, masses)
    if cfg.integrator == "dopri5":
        ts = time_grid(cfg, y0.device, y0.dtype)
        return dopri5_integrate(ode, y0, ts, rtol=cfg.rtol, atol=cfg.atol).ys

    dt = cfg.sim_time / cfg.num_steps
    step = rk4_step_fn(ode, dt)
    ys = torch.empty((cfg.num_steps + 1,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    ys[0] = y0
    y = y0
    for i in range(cfg.num_steps):
        y = step(y, i * dt)
        ys[i + 1] = y
    return ys


def simulate_with_waveform(cfg: NBodyConfig, y0: torch.Tensor, masses: torch.Tensor):
    """``(ys, t, positions_t, h_plus)``: the trajectory and its GW strain."""
    ys = simulate(cfg, y0, masses)
    n = cfg.n_bodies
    t = time_grid(cfg, y0.device, y0.dtype)
    positions_t = ys[:, : 2 * n].reshape(-1, n, 2)
    h_plus = gw_strain(t, positions_t, masses, cfg.d_gw_mpc, g=cfg.g, c=cfg.c)
    return ys, t, positions_t, h_plus


def lyapunov(cfg: NBodyConfig, y0: torch.Tensor, masses: torch.Tensor, d0: float = 1e-6) -> torch.Tensor:
    """Largest Lyapunov exponent. ``tangent``: the Benettin variational
    method along the RK4 steps; ``two_trajectory``: the reference estimator
    (nbody...:175-208), one extra trajectory from ``y0 + d0*e_0``. Where
    ``y0[0] + d0`` rounds back to ``y0[0]`` (the default start, 50.0, in
    float32, whose ulp there is 3.8e-6) the two trajectories are one and
    the estimate would be exactly 0: that raises ``ValueError`` instead."""
    dt = cfg.sim_time / cfg.num_steps
    ode = make_ode(cfg, masses)
    step = rk4_step_fn(ode, dt)

    if cfg.lyapunov_method == "tangent":
        return lyapunov_tangent(lambda y: step(y, 0.0), y0, cfg.num_steps, dt, d0=d0)

    ys = simulate(cfg, y0, masses)
    y0_pert = y0.clone()
    y0_pert[0] += d0
    if torch.equal(y0_pert, y0):
        raise ValueError(
            f"two_trajectory Lyapunov: y0[0] + d0 = {float(y0[0])!r} + {d0!r} rounds back to "
            f"y0[0] in {y0.dtype}, so both trajectories are one and the estimate would be 0; "
            "use the tangent method, a larger d0 or float64"
        )
    ys_pert = simulate(cfg, y0_pert, masses)
    lyap, _ = lyapunov_two_trajectory(time_grid(cfg, y0.device, y0.dtype), ys, ys_pert, d0=d0)
    return lyap


@dataclass
class NBodyResult:
    t: torch.Tensor  # (T,)
    positions: torch.Tensor  # (T, n, 2)
    trajectory_flat: torch.Tensor  # (T, 4n)
    h_plus: torch.Tensor  # (T,)
    lyapunov: Optional[float]
    sim_wall_s: float


def run(cfg: Optional[NBodyConfig] = None, device="cuda", dtype=torch.float32) -> NBodyResult:
    """Warm up, then time ``simulate_with_waveform``; then the Lyapunov
    exponent (untimed, as in the JAX package). The warm-up is a short run
    of the same functions (at most 10 steps of the same dt), not a second
    full simulation. ``dtype`` is the state's and the masses' (float32 as
    in the JAX package; float64 for an oracle run)."""
    cfg = cfg or NBodyConfig()
    device = torch.device(device)
    masses = torch.tensor(cfg.masses, dtype=dtype, device=device)
    y0 = init_state_flat(cfg, device, dtype)

    warm_steps = min(cfg.num_steps, 10)
    warm = override(cfg, num_steps=warm_steps, sim_time=cfg.sim_time * warm_steps / cfg.num_steps)
    simulate_with_waveform(warm, y0, masses)
    synchronize(device)

    t0 = time.perf_counter()
    ys, t, positions_t, h_plus = simulate_with_waveform(cfg, y0, masses)
    synchronize(device)
    wall = time.perf_counter() - t0

    lyap = None
    if cfg.compute_chaos:
        lyap = float(lyapunov(cfg, y0, masses))
    return NBodyResult(t=t, positions=positions_t, trajectory_flat=ys, h_plus=h_plus,
                       lyapunov=lyap, sim_wall_s=wall)
