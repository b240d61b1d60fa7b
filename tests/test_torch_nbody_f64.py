"""The n-body Lyapunov estimates of the port against the JAX package in
float64, and the port's guard on the two-trajectory start.

In float32 the default orbit (3 bodies, 1000 RK4 steps) gives a tangent
exponent of 0.1159 in the port and 0.1507 in JAX: a one-ulp change of the
start grows to O(1) in the last third of the run, so float32 cannot tell a
fault of the formulas from chaos. In float64 (``jax.enable_x64`` on the JAX
side, float64 tensors on the port's) roundoff starts 2^29 times smaller:
the trajectories agree to ~1e-13 relative for 500 steps, a close encounter
near step 550 then amplifies the difference to ~2e-4, and the two full
tangent exponents agree to ~3e-5 relative (both 0.15839). The tolerances
below hold those with a few times' margin.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import NBodyConfig as JaxNBodyConfig
from jax_tpus_benchmark_physics_simulation_tpu.models import nbody_merger as jnb
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import NBodyConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import nbody_merger as nb

# relative difference of the trajectories over the first 500 steps, and of
# the full-length tangent exponents (measured: 8e-14 and 2.8e-5)
TRAJ_RTOL = 1e-10
LYAP_RTOL = 1e-4


def test_default_orbit_float64_matches_jax():
    """RK4 ``simulate`` and the tangent ``lyapunov`` of the default
    configuration, all 1000 steps, in float64 in both packages."""
    cfg = NBodyConfig()
    with jax.enable_x64(True):
        jc = JaxNBodyConfig()
        y0_j = jnb.init_state_flat(jc)
        m_j = jnp.asarray(jc.masses, jnp.float64)
        assert y0_j.dtype == jnp.float64
        ys_j = np.asarray(jnb.simulate(jc, y0_j, m_j))
        lam_j = float(jnb.lyapunov(jc, y0_j, m_j))
    y0 = nb.init_state_flat(cfg, "cpu", torch.float64)
    masses = torch.tensor(cfg.masses, dtype=torch.float64)
    np.testing.assert_array_equal(y0.numpy(), np.asarray(y0_j))
    ys = nb.simulate(cfg, y0, masses)
    assert ys.dtype == torch.float64 and ys.shape == ys_j.shape == (1001, 12)
    scale = np.abs(ys_j[:501]).max(axis=1, keepdims=True)
    assert np.abs(ys.numpy()[:501] - ys_j[:501]).max() <= TRAJ_RTOL * scale.min()
    lam = float(nb.lyapunov(cfg, y0, masses))
    assert 0.15 < lam_j < 0.17
    np.testing.assert_allclose(lam, lam_j, rtol=LYAP_RTOL)


def test_run_takes_float64():
    """``run`` keeps the dtype it is given: state, strain and output times."""
    cfg = override(NBodyConfig(), num_steps=20, sim_time=4.0)
    res = nb.run(cfg, device="cpu", dtype=torch.float64)
    assert res.trajectory_flat.dtype == res.h_plus.dtype == res.t.dtype == torch.float64
    assert np.isfinite(res.lyapunov)


def test_two_trajectory_start_that_rounds_away_is_refused(capsys):
    """``y0[0] + 1e-6`` is 50.0 again in float32: the port raises where
    JAX's estimate is a silent 0.0, and the CLI says so and exits 2. In
    float64 the same perturbation survives and the estimate is positive."""
    cfg = override(NBodyConfig(), num_steps=40, sim_time=8.0, lyapunov_method="two_trajectory")
    y0 = nb.init_state_flat(cfg, "cpu")
    assert float(y0[0] + 1e-6) == float(y0[0]) == 50.0
    with pytest.raises(ValueError, match="rounds back"):
        nb.lyapunov(cfg, y0, torch.tensor(cfg.masses))
    with pytest.raises(ValueError, match="rounds back"):
        nb.run(cfg, device="cpu")
    assert cli.main(["nbody", "--device", "cpu", "--num_steps", "40", "--lyapunov", "two_trajectory"]) == 2
    captured = capsys.readouterr()
    assert "rounds back" in captured.err and "Lyapunov exponent" not in captured.out
    res = nb.run(cfg, device="cpu", dtype=torch.float64)
    assert np.isfinite(res.lyapunov) and res.lyapunov != 0.0
