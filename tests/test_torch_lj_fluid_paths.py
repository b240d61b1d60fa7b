"""The slice as a whole: the port's ``lj_fluid`` off the grid engine
(``dense_xla``, ``dense_pallas`` = B8, ``neighbor``, ``cell``) against the
JAX package's on the CPU, where B8's wrapper takes its plain version and
the JAX package runs its Pallas kernel in interpret mode; plus
``resolve_impl``, ``MDResult.transport`` and the ``md`` CLI at its
defaults."""

import math

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
    MDConfig as JaxMDConfig,
    override as jax_override,
)
from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState as JaxParticleState
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid as jax_lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables import msd as jax_msd
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core import runner
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import particle_state_from_numpy
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables import msd
from tests.torch_parity import lattice_positions, periodic_distance, velocities

PATHS = dict(n=256, rho=0.6, init="lattice", eq_steps=40, prod_steps=100, sample_every=20, dt=1e-3)


@pytest.mark.parametrize("impl,cutoff", [("dense_xla", None), ("dense_pallas", None),
                                         ("neighbor", 2.5), ("cell", 2.5)])
def test_equilibrate_production_match_jax(impl, cutoff):
    """40 + 100 steps from one numpy state on each path: histories at rtol
    1e-4 and positions at 1e-4 * box (the same physics summed in another
    order), the same overflow flags, the same sample shapes."""
    kw = dict(PATHS, force_impl=impl, cutoff=cutoff)
    cfg_j, cfg_t = jax_override(JaxMDConfig(), **kw), override(MDConfig(), **kw)
    box = cfg_t.box_size
    pos = np.mod(lattice_positions(cfg_t.n, box, jitter=0.05, seed=11), box).astype(np.float32)
    vel = velocities(cfg_t.n, seed=12)
    s0_j = JaxParticleState.create(jnp.asarray(pos), jnp.asarray(vel))
    eq_j, ovf_eq_j = jax_lj_fluid.equilibrate(cfg_j, s0_j)
    fin_j, (r_j, ke_j, pe_j), ovf_j = jax_lj_fluid.production(cfg_j, eq_j)

    counts = (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES)
    eq_t, ovf_eq_t = lj_fluid.equilibrate(cfg_t, particle_state_from_numpy(pos, vel, device="cpu"))
    fin_t, (r_t, ke_t, pe_t), ovf_t = lj_fluid.production(cfg_t, eq_t)
    assert (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES) == counts  # CPU: no launch
    assert bool(ovf_eq_t) == bool(ovf_eq_j) is False
    assert bool(ovf_t) == bool(ovf_j) is False
    assert tuple(r_t.shape) == tuple(r_j.shape) == (5, 256, 2)
    assert tuple(ke_t.shape) == tuple(pe_t.shape) == (5,)
    assert periodic_distance(eq_t.position.numpy(), np.asarray(eq_j.position), box).max() <= 1e-4 * box
    assert periodic_distance(r_t.numpy(), np.asarray(r_j), box).max() <= 1e-4 * box
    np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-4)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-4)
    np.testing.assert_allclose(fin_t.velocity.numpy(), np.asarray(fin_j.velocity), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(fin_t.time), float(fin_j.time), rtol=1e-6)


# (n, cutoff, dim, force_impl); None in the last column of an error row
RESOLVE = [
    (400, None, 2, "auto"), (1024, None, 2, "auto"), (16384, None, 2, "auto"), (5000, None, 3, "auto"),
    (400, 2.5, 2, "auto"), (5000, 2.5, 2, "auto"), (5000, 2.5, 3, "auto"), (100_000, 2.5, 3, "auto"),
    (5000, 20.0, 2, "auto"), (5000, 2.5, 2, "dense_pallas"), (400, None, 3, "dense_xla"),
    (400, 2.5, 2, "neighbor"), (400, 2.5, 2, "cell"), (400, 2.5, 2, "grid"),
    (400, None, 2, "neighbor"), (400, None, 2, "cell"), (400, None, 2, "grid"),
]
# where the port's rule on the card differs from the CPU's: auto takes B8
# (dense_pallas) for N >= 1024 without a usable cutoff, as the JAX package
# does on a TPU
ON_CARD = {(1024, None, 2): "dense_pallas", (16384, None, 2): "dense_pallas",
           (5000, None, 3): "dense_pallas"}


def test_resolve_impl_matches_jax():
    for n, cutoff, dim, impl in RESOLVE:
        kw = dict(n=n, cutoff=cutoff, dim=dim, force_impl=impl)
        cfg_t, cfg_j = override(MDConfig(), **kw), jax_override(JaxMDConfig(), **kw)
        try:
            want = jax_lj_fluid.resolve_impl(cfg_j)
        except ValueError:
            with pytest.raises(ValueError, match="requires a cutoff"):
                lj_fluid.resolve_impl(cfg_t, "cpu")
            with pytest.raises(ValueError, match="requires a cutoff"):
                lj_fluid.resolve_impl(cfg_t, "cuda")
            continue
        assert lj_fluid.resolve_impl(cfg_t, "cpu") == want, kw
        on_card = ON_CARD.get((n, cutoff, dim), want) if impl == "auto" else want
        assert lj_fluid.resolve_impl(cfg_t, "cuda") == on_card, kw
    assert lj_fluid.resolve_impl(MDConfig(), "cpu") == "dense_xla"
    with pytest.raises(ValueError, match="unknown force_impl"):
        lj_fluid.resolve_impl(override(MDConfig(), force_impl="bogus"), "cpu")


def test_transport_matches_jax_msd():
    """A random walk wrapped into the box: the unwrapped trajectory, the
    MSD over all lags (and its strided subset above 4096 particles), D and
    the fit residual, at rtol 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(21)
    box = 20.0
    for n, s in ((300, 12), (5000, 6)):
        steps = 0.3 * rng.standard_normal((s, n, 2))
        hist = np.mod(rng.uniform(0, box, (1, n, 2)) + np.cumsum(steps, axis=0), box).astype(np.float32)
        h_t, h_j = torch.from_numpy(hist), jnp.asarray(hist)
        np.testing.assert_allclose(msd.unwrap_trajectory(h_t, box).numpy(),
                                   np.asarray(jax_msd.unwrap_trajectory(h_j, box)), rtol=1e-5, atol=1e-4)
        curve_t = msd.mean_squared_displacement(h_t, box)
        curve_j = jax_msd.mean_squared_displacement(h_j, box)
        assert curve_t.shape == (s,) and float(curve_t[0]) == 0.0
        np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=1e-5, atol=1e-6)
        d_t, r_t = msd.diffusion_coefficient(curve_t, 0.1, 2)
        d_j, r_j = jax_msd.diffusion_coefficient(curve_j, 0.1, 2)
        np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-4)
        np.testing.assert_allclose(float(r_t), float(r_j), rtol=1e-3, atol=1e-6)
        res = lj_fluid.MDResult(
            state=None, r_history=h_t, ke_history=torch.zeros(s), pe_history=torch.zeros(s),
            rdf_r=None, rdf_g=None, time_eq_s=0.0, time_prod_s=0.0, time_rdf_s=0.0,
            box=box, dt_sample=0.1,
        )
        curve, d_coef, resid = res.transport()
        assert torch.equal(curve, curve_t) and d_coef == float(d_t) and resid == float(r_t)
    short = lj_fluid.MDResult(state=None, r_history=h_t[:3], ke_history=None, pe_history=None,
                              rdf_r=None, rdf_g=None, time_eq_s=0.0, time_prod_s=0.0,
                              time_rdf_s=0.0, box=box, dt_sample=0.1)
    assert short.transport()[0] is None and math.isnan(short.transport()[1])


def test_runner_samples_like_jax():
    """Samples after each block, the remainder unsampled, stacked; an
    empty stack keeps the sample's shape; the initial sample prepended."""
    final, (a, b) = runner.run_trajectory(lambda x: x + 1, torch.zeros(3), 23, 5,
                                          observe_fn=lambda x: (x, x.sum()))
    assert float(final[0]) == 23 and tuple(a.shape) == (4, 3) and b.tolist() == [15, 30, 45, 60]
    _, empty = runner.run_trajectory(lambda x: x + 1, torch.zeros(3), 3, 5)
    assert tuple(empty.shape) == (0, 3)
    final, hist = runner.run_trajectory_with_initial(lambda x: x + 1, torch.zeros(2), 3)
    assert hist[:, 0].tolist() == [0, 1, 2, 3] and float(final[0]) == 3


def test_run_off_the_grid_engine():
    """``run`` on the list and dense paths: no pressure (NaN, as in the JAX
    package), transport from the samples, no overflow; a thermostat off the
    grid engine is a ValueError, as in the JAX package."""
    cfg = override(MDConfig(), **dict(PATHS, force_impl="neighbor", cutoff=2.5, prod_steps=120))
    res = lj_fluid.run(cfg, device="cpu")
    assert math.isnan(res.pressure) and not res.overflow and res.cadence is None
    assert tuple(res.r_history.shape) == (6, 256, 2) and res.energy_drift < 1e-3
    _, d_coef, _ = res.transport()
    assert math.isfinite(d_coef) and d_coef > 0
    with pytest.raises(ValueError, match="grid engine only"):
        lj_fluid.run(override(cfg, force_impl="dense_xla", thermostat="langevin"), device="cpu")


def test_cli_md_defaults_cpu(capsys):
    """``md`` at the CLI's defaults (N=400, uniform start, no cutoff:
    dense_xla on the CPU) with short step counts exits 0; overlaps in the
    uniform start make the drift n/a, as in the JAX package."""
    assert cli.main(["md", "--device", "cpu", "--eq_steps", "40", "--prod_steps", "40",
                     "--sample_every", "20"]) == 0
    out = capsys.readouterr().out
    assert "N=400" in out and "force: dense_xla" in out and "cutoff=None" in out
    assert "kernels: none" in out and "grid:" not in out and "energy drift:" in out
    rc = cli.main(["md", "--device", "cpu", "--N", "256", "--rho", "0.6", "--init", "lattice",
                   "--force-impl", "dense_pallas", "--eq_steps", "20", "--prod_steps", "80",
                   "--sample_every", "20"])
    out = capsys.readouterr().out
    assert rc == 0 and "force: dense_pallas" in out and "kernels: B8" in out
    assert "D* = " in out and "P* =" not in out and "OVERFLOW" not in out
