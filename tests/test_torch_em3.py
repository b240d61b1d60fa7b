"""The port's EM three-particle workload (``ops/forces/em.py``,
``ops/integrators.boris2d`` / ``em_reference_step``,
``models/em_three_particles.py`` and the CLI's ``em3``) against the JAX
package on the CPU.

Inputs come from numpy seeds. XLA on the CPU contracts ``a * b + c`` into a
fused multiply-add where it can (e.g. ``bz + bk * x``, the kicks ``v + 0.5
dt a``) and its ``pow`` (gravity's ``r2 ** -1.5``) rounds differently from
``torch.pow``; so one-step quantities are held at rtol 1e-6 (float32)
instead of bit equality.

Whole runs. The default orbit (1000 steps, dt 0.01) has close encounters,
so float32 is compared over its first 50 steps only, at the tolerance of
JAX's own ``tests/test_em3.py`` (rtol 1e-4, atol 1e-5; measured here: 6e-8
at step 50, 5e-4 over all 1000 steps). In float64 (``jax.enable_x64`` on
JAX's side) the orbit allows all 1000 steps. Measured on this CPU, as the
largest |difference| of a coordinate, beside what one ulp of one start
coordinate (each of the six, up and down) moves the port's own orbit:

- Boris: port against JAX 1.41e-12 over 1000 steps, one ulp 1.05e-11;
- reference integrator: 4.24e-12 over the first 400 steps (one ulp
  7.57e-11), then a close encounter near step 550: 3.07e-06 over 1000 steps
  (one ulp 5.45e-05).

The tolerances below are ten times the one-ulp spread (rounded up): Boris
1e-10 over 1000 steps; reference 1e-9 over 400 steps and 5e-4 over 1000.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import EM3Config as JaxEM3Config
from jax_tpus_benchmark_physics_simulation_tpu.core.config import override as jax_override
from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState as JaxParticleState
from jax_tpus_benchmark_physics_simulation_tpu.models import em_three_particles as jem
from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.em import Lorentz2D as JaxLorentz2D
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import EM3Config, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import particle_state_from_numpy
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import em_three_particles as em
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces import Lorentz2D

RTOL = 1e-6
F64_ATOL = {"boris": ((1000, 1e-10),), "reference": ((400, 1e-9), (1000, 5e-4))}
FIELD = dict(bz=1.3, bk=0.4, ex=0.2, ey=-0.7)


def _configs(**kw):
    return jax_override(JaxEM3Config(), **kw), override(EM3Config(), **kw)


def _seeded_state(seed: int, n: int = 5):
    """Positions, velocities, masses and charges from a numpy seed, as numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, size=(n, 2)).astype(np.float32)
    vel = rng.normal(0.0, 0.3, size=(n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    charge = rng.uniform(-1.5, 1.5, size=n).astype(np.float32)
    return pos, vel, mass, charge


def _both_states(seed: int):
    pos, vel, mass, charge = _seeded_state(seed)
    js = JaxParticleState.create(jnp.asarray(pos), jnp.asarray(vel), mass=jnp.asarray(mass),
                                 charge=jnp.asarray(charge))
    ts = particle_state_from_numpy(pos, vel, device="cpu", mass=mass, charge=charge)
    return js, ts


def test_particle_state_from_numpy_mass_and_charge():
    pos, vel, mass, charge = _seeded_state(0)
    st = particle_state_from_numpy(pos, vel, device="cpu", mass=mass, charge=charge)
    np.testing.assert_array_equal(st.mass.numpy(), mass)
    np.testing.assert_array_equal(st.charge.numpy(), charge)
    plain = particle_state_from_numpy(pos, vel, device="cpu")
    assert torch.equal(plain.mass, torch.ones(5)) and torch.equal(plain.charge, torch.zeros(5))


@pytest.mark.parametrize("seed", [0, 1])
def test_lorentz2d_fields_and_acceleration(seed):
    pos, vel, mass, charge = _seeded_state(seed)
    j, t = JaxLorentz2D(**FIELD), Lorentz2D(**FIELD)
    tp, tv, tm, tq = (torch.from_numpy(a) for a in (pos, vel, mass, charge))
    np.testing.assert_allclose(t.b_field(tp).numpy(), np.asarray(j.b_field(jnp.asarray(pos))), rtol=RTOL)
    e_t = t.e_field(tp)
    assert e_t.shape == (5, 2) and e_t.dtype == torch.float32
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(j.e_field(jnp.asarray(pos))))
    a_j = np.asarray(j.acceleration(*(jnp.asarray(a) for a in (pos, vel, mass, charge))))
    np.testing.assert_allclose(t.acceleration(tp, tv, tm, tq).numpy(), a_j, rtol=RTOL,
                               atol=RTOL * np.abs(a_j).max())


@pytest.mark.parametrize("integrator", ["boris", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_step_matches_jax(integrator, seed):
    """One step of ``boris2d`` / ``em_reference_step`` from a seeded state
    with unequal masses and charges of both signs, through ``build_step``."""
    jc, tc = _configs(integrator=integrator, **FIELD)
    js, ts = _both_states(seed)
    _, j_step = jem.build_step(jc, js)
    _, t_step = em.build_step(tc, ts)
    j1, t1 = j_step(js), t_step(ts)
    for name in ("position", "velocity"):
        want = np.asarray(getattr(j1, name))
        np.testing.assert_allclose(getattr(t1, name).numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert float(t1.time) == pytest.approx(float(j1.time), rel=1e-7)


@pytest.mark.parametrize("integrator", ["boris", "reference"])
def test_simulate_float32_first_50_steps(integrator):
    """JAX's own parity test's window and tolerance (tests/test_em3.py)."""
    jc, tc = _configs(n_steps=50, integrator=integrator)
    jf, jt = jem.simulate(jc, jem.default_initial_state())
    tf, tt = em.simulate(tc, em.default_initial_state(device="cpu"))
    assert tt.shape == (51, 3, 2) and tt.dtype == torch.float32
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tf.velocity.numpy(), np.asarray(jf.velocity), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("integrator", ["boris", "reference"])
def test_simulate_float64_all_steps(integrator):
    """The default 1000 steps in float64 in both packages, to the measured
    tolerances of the module docstring."""
    jc, tc = _configs(integrator=integrator)
    with jax.enable_x64(True):
        s0 = jem.default_initial_state(jnp.float64)
        assert s0.position.dtype == jnp.float64
        _, jt = jem.simulate(jc, s0)
        jt = np.asarray(jt)
    _, tt = em.simulate(tc, em.default_initial_state(torch.float64, "cpu"))
    assert tt.dtype == torch.float64 and tt.shape == jt.shape == (1001, 3, 2)
    diff = np.abs(tt.numpy() - jt)
    for steps, atol in F64_ATOL[integrator]:
        assert diff[: steps + 1].max() <= atol, (integrator, steps, diff[: steps + 1].max())


def test_run_shape_finite_and_timed():
    cfg = override(EM3Config(), n_steps=50)
    res = em.run(cfg, device="cpu")
    assert res.trajectory.shape == (51, 3, 2)
    assert bool(torch.isfinite(res.trajectory).all())
    assert res.wall_time_s > 0
    assert res.final_state.position.device.type == "cpu"
    torch.testing.assert_close(res.trajectory[-1], res.final_state.position, rtol=0, atol=0)


def test_pure_magnetic_conserves_energy():
    """G = 0, E = 0: the magnetic force does no work, Boris keeps the speed
    (JAX's test_em3, same bound)."""
    cfg = override(EM3Config(), g=0.0, bz=1.0, n_steps=2000, integrator="boris")
    state = em.default_initial_state(device="cpu")
    final, _ = em.simulate(cfg, state)
    ke0 = float(torch.sum(state.velocity**2))
    ke1 = float(torch.sum(final.velocity**2))
    np.testing.assert_allclose(ke1, ke0, rtol=1e-5)


def test_boris_and_reference_agree_at_small_dt():
    """Both integrators converge to one trajectory as dt -> 0 (t_end 0.4,
    before the close encounter; JAX's test_em3, same bound)."""

    def final_pos(integrator):
        cfg = override(EM3Config(), dt=0.001, n_steps=400, integrator=integrator)
        _, traj = em.simulate(cfg, em.default_initial_state(device="cpu"))
        return traj[-1].numpy()

    np.testing.assert_allclose(final_pos("boris"), final_pos("reference"), atol=1e-3)


def test_unknown_integrator_raises():
    with pytest.raises(ValueError, match="unknown integrator"):
        em.build_step(override(EM3Config(), integrator="leapfrog"), em.default_initial_state(device="cpu"))


@pytest.mark.parametrize("argv", [["--n_steps", "30"], ["--n_steps", "10", "--integrator", "reference"]])
def test_cli_em3_cpu(argv, capsys):
    """JAX's tests/test_cli.py sizes, on the CPU."""
    assert cli.main(["em3", *argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n = argv[1]
    assert f"em3: {n} steps in " in out and "ms per step" in out
    assert f"trajectory ({int(n) + 1}, 3, 2), finite True" in out


def test_cli_em3_without_card_exits_2(capsys):
    """``--device cuda`` (the default) without a card: exit 2, as ``md``."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    assert cli.main(["em3", "--n_steps", "5"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
