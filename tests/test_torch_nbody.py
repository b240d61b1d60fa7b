"""The port's n-body workload (``models/nbody_merger.py``, RK4, dopri5, GW
strain, Lyapunov) against the JAX package on the CPU.

The default configuration (3 bodies, separation 100, v 0.1) is chaotic:
its tangent Lyapunov exponent is ~0.15, and a one-ulp change of y0 grows to
O(1) after ~700 of its 1000 steps. So the default run is compared over its
first 300 steps (where the two packages agree to ~1e-7 relative), and the
full length only on a non-chaotic two-body circular orbit.

Tolerances, each for float32 arithmetic done op for op but by two libraries
(``pow``, sums and matmuls may round differently in the last bit): states
at rtol 1e-5 with an atol of 1e-5 x the largest |position| (velocity);
strains at rtol 1e-5 with an atol of 1e-5 x max |h|."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import NBodyConfig as JaxNBodyConfig
from jax_tpus_benchmark_physics_simulation_tpu.core.config import override as jax_override
from jax_tpus_benchmark_physics_simulation_tpu.models import nbody_merger as jnb
from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators import rk4_step_fn as jax_rk4_step_fn
from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators_adaptive import dopri5_integrate as jax_dopri5
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables.gw import gw_strain as jax_gw_strain
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import NBodyConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import nbody_merger as nb
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators import rk4_step_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators_adaptive import dopri5_integrate
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.gw import MPC_TO_M, gw_strain
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.lyapunov import (
    initial_tangent,
    lyapunov_tangent,
)

RTOL = 1e-5


def _configs(**kw):
    """The same configuration in both packages."""
    return jax_override(JaxNBodyConfig(), **kw), override(NBodyConfig(), **kw)


def _inputs(jc, tc):
    """``(y0, masses)`` for each package."""
    return ((jnb.init_state_flat(jc), jnp.asarray(jc.masses, jnp.float32)),
            (nb.init_state_flat(tc, "cpu"), torch.tensor(tc.masses, dtype=torch.float32)))


def _two_body(**kw):
    """Equal masses on a circular orbit (``tests/test_nbody.py``'s
    ``two_body_circular_cfg``): one period in 2000 steps."""
    m, d, g = 4.0, 2.0, 1.0
    v = float(np.sqrt(g * m / (2 * d)))
    period = float(2 * np.pi * (d / 2) / v)
    base = dict(n_bodies=2, masses=(m, m), initial_distance=d, initial_velocity=v,
                sim_time=period, num_steps=2000, compute_chaos=False)
    base.update(kw)
    return _configs(**base)


def _states_close(got, want, n_bodies: int):
    """Positions and velocities each at rtol 1e-5, atol 1e-5 x their max."""
    got, want = np.asarray(got), np.asarray(want)
    for sl in (slice(0, 2 * n_bodies), slice(2 * n_bodies, 4 * n_bodies)):
        w = want[..., sl]
        np.testing.assert_allclose(got[..., sl], w, rtol=RTOL, atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("n_bodies", [3, 5])
def test_init_state_flat_equal(n_bodies):
    jc, tc = _configs(n_bodies=n_bodies, masses=(30.0,) * n_bodies)
    y_j, y_t = np.asarray(jnb.init_state_flat(jc)), nb.init_state_flat(tc, "cpu")
    assert y_t.dtype == torch.float32 and y_t.shape == (4 * n_bodies,)
    np.testing.assert_array_equal(y_t.numpy(), y_j)


def test_rk4_step_matches_jax():
    """One RK4 step of the default ODE from y0, and the raw ODE: equal to
    float32 roundoff (on this CPU they are bit-equal)."""
    jc, tc = _configs()
    (yj, mj), (yt, mt) = _inputs(jc, tc)
    dt = jc.sim_time / jc.num_steps
    np.testing.assert_allclose(nb.make_ode(tc, mt)(0.0, yt).numpy(),
                               np.asarray(jnb.make_ode(jc, mj)(0.0, yj)), rtol=1e-6, atol=1e-9)
    got = rk4_step_fn(nb.make_ode(tc, mt), dt)(yt, 0.0)
    want = jax_rk4_step_fn(jnb.make_ode(jc, mj), dt)(yj, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_simulate_default_first_300_steps_match_jax():
    jc, tc = _configs(num_steps=300, sim_time=60.0, compute_chaos=False)  # dt 0.2 as the default
    (yj, mj), (yt, mt) = _inputs(jc, tc)
    ys_t = nb.simulate(tc, yt, mt)
    assert ys_t.shape == (301, 12) and ys_t.dtype == torch.float32
    _states_close(ys_t.numpy(), jnb.simulate(jc, yj, mj), 3)


def test_simulate_two_body_orbit_full_length_matches_jax():
    jc, tc = _two_body()
    (yj, mj), (yt, mt) = _inputs(jc, tc)
    ys_t = nb.simulate(tc, yt, mt)
    _states_close(ys_t.numpy(), jnb.simulate(jc, yj, mj), 2)
    # the orbit closes after one period, as the JAX package's Kepler oracle checks
    np.testing.assert_allclose(ys_t[-1].numpy(), yt.numpy(), atol=5e-3)


def test_dopri5_two_body_matches_jax():
    """Adaptive steps to 51 output times on the two-body orbit. The error
    norm of an attempt near 1 can flip accept/reject at roundoff, so the
    attempt counts may differ by a few (one on this CPU); the trajectories
    agree at the tolerance. The same ``ts`` go to both."""
    jc, tc = _two_body(num_steps=50, integrator="dopri5")
    (yj, mj), (yt, mt) = _inputs(jc, tc)
    ts = np.linspace(0.0, jc.sim_time, 51).astype(np.float32)
    rj = jax_dopri5(jnb.make_ode(jc, mj), yj, jnp.asarray(ts), rtol=1e-6, atol=1e-9)
    rt = dopri5_integrate(nb.make_ode(tc, mt), yt, torch.from_numpy(ts), rtol=1e-6, atol=1e-9)
    assert not rt.steps_exceeded and not bool(rj.steps_exceeded)
    assert abs(rt.steps_taken - int(rj.steps_taken)) <= 3
    assert rt.ode_evals == 1 + 6 * rt.steps_taken
    _states_close(rt.ys.numpy(), rj.ys, 2)
    # the model's dopri5 path (its own output times) agrees too
    _states_close(nb.simulate(tc, yt, mt).numpy(), jnb.simulate(jc, yj, mj), 2)


def test_dopri5_max_steps_flag_is_loud():
    res = dopri5_integrate(lambda t, y: -y, torch.tensor([1.0]), torch.tensor([0.0, 10.0]),
                           rtol=1e-12, atol=1e-14, max_steps_per_interval=3)
    assert res.steps_exceeded and res.steps_taken == 3


def test_gw_strain_matches_jax():
    """On the JAX trajectory of the default configuration's first 300 steps
    (both packages get the same positions and times), at the default
    observer distance and at 100 Mpc."""
    jc, _ = _configs(num_steps=300, sim_time=60.0, compute_chaos=False)
    masses = jnp.asarray(jc.masses, jnp.float32)
    _, t, positions, _ = jnb.simulate_with_waveform(jc, jnb.init_state_flat(jc), masses)
    args_t = (torch.tensor(np.asarray(t)), torch.tensor(np.asarray(positions)),
              torch.tensor(jc.masses, dtype=torch.float32))
    assert MPC_TO_M == 3.086e22
    for d_gw in (jc.d_gw_mpc, 100.0):
        h_j = np.asarray(jax_gw_strain(t, positions, masses, d_gw))
        h_t = gw_strain(*args_t, d_gw)
        assert h_t.dtype == torch.float32 and 1e-25 < np.abs(h_j).max() < 1e-22
        np.testing.assert_allclose(h_t.numpy(), h_j, rtol=RTOL, atol=RTOL * np.abs(h_j).max())


@pytest.mark.parametrize("method,d0", [("tangent", 1e-6), ("two_trajectory", 1e-6), ("two_trajectory", 1e-2)])
def test_lyapunov_matches_jax(method, d0):
    """300 steps of the default configuration. With d0 = 1e-6 the two-
    trajectory start y0[0] + d0 rounds back to y0[0] (50.0 has an ulp of
    3.8e-6 in float32): both packages return exactly 0. The estimator takes
    the difference of two trajectories d0 apart at coordinates ~50, so its
    float32 roundoff is ~ulp(50) / d0 relative: d0 = 1e-2 keeps that below
    the rtol (at d0 = 1e-4 the packages differ by 4%)."""
    jc, tc = _configs(num_steps=300, sim_time=60.0, lyapunov_method=method)
    (yj, mj), (yt, mt) = _inputs(jc, tc)
    lam_t = float(nb.lyapunov(tc, yt, mt, d0=d0))
    lam_j = float(jnb.lyapunov(jc, yj, mj, d0=d0))
    assert np.isfinite(lam_t)
    if method == "two_trajectory" and d0 == 1e-6:
        assert lam_t == lam_j == 0.0
    else:
        np.testing.assert_allclose(lam_t, lam_j, rtol=1e-4)


def test_lyapunov_generator_start():
    """The generator branch: a random start direction of norm d0, and a
    finite exponent."""
    jc, tc = _configs(num_steps=20, sim_time=4.0)
    _, (yt, mt) = _inputs(jc, tc)
    delta0 = initial_tangent(yt, 1e-6, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(torch.linalg.vector_norm(delta0.double())), 1e-6, rtol=1e-6)
    assert int((delta0 != 0).sum()) == yt.numel()
    step = rk4_step_fn(nb.make_ode(tc, mt), 0.2)
    lam = lyapunov_tangent(lambda y: step(y, 0.0), yt, 20, 0.2, generator=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(lam))


def test_run_end_to_end_matches_jax():
    jc, tc = _configs(sim_time=20.0, num_steps=50)
    res = nb.run(tc, device="cpu")
    assert res.positions.shape == (51, 3, 2) and res.h_plus.shape == (51,)
    assert res.trajectory_flat.shape == (51, 12) and res.t.shape == (51,)
    assert res.sim_wall_s > 0 and bool(torch.isfinite(res.h_plus).all())
    res_j = jnb.run(jc)
    _states_close(res.trajectory_flat.numpy(), res_j.trajectory_flat, 3)
    h_j = np.asarray(res_j.h_plus)
    np.testing.assert_allclose(res.h_plus.numpy(), h_j, rtol=RTOL, atol=RTOL * np.abs(h_j).max())
    np.testing.assert_allclose(res.lyapunov, res_j.lyapunov, rtol=1e-4)


def test_nbody_cli_on_cpu(capsys):
    assert cli.main(["nbody", "--device", "cpu", "--num_steps", "50"]) == 0
    out = capsys.readouterr().out
    assert "kernels: none: plain PyTorch on 3 bodies" in out
    assert "ms per RK4 step" in out
    assert "Lyapunov exponent (tangent):" in out
