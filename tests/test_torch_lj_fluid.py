"""The slice as a whole: the PyTorch port's ``lj_fluid`` against the JAX
package's, plus the port's ``run``, g(r), observables and ``md`` CLI on the
CPU (where every kernel wrapper takes its plain version)."""

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
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables.rdf import (
    radial_distribution as jax_radial_distribution,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables.thermo import (
    kinetic_energy as jax_kinetic_energy,
    temperature as jax_temperature,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import particle_state_from_numpy
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.rdf import radial_distribution
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import (
    kinetic_energy,
    temperature,
)
from tests.torch_parity import exact_pallas_reciprocal, lattice_positions, periodic_distance, velocities

# n=1024: cps 12, which 8 does not divide, so the JAX side stays off the
# sharded engine on the 8-device test mesh; both packages pack R=6 (B3)
SLICE = dict(
    n=1024, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice",
    eq_steps=40, prod_steps=100, sample_every=20, dt=1e-3,
)


def test_config_fields_match_jax():
    assert [f for f in MDConfig.__dataclass_fields__] == [f for f in JaxMDConfig.__dataclass_fields__]
    assert MDConfig().__dict__ == JaxMDConfig().__dict__
    cfg = override(MDConfig(), n=100_000)
    assert cfg.box_size == jax_override(JaxMDConfig(), n=100_000).box_size
    with pytest.raises(TypeError):
        override(MDConfig(), bogus=1)


def test_lattice_init_matches_jax():
    cfg = override(MDConfig(), **SLICE)
    pos_t = lj_fluid.init_state(cfg, "cpu").position.numpy()
    pos_j = np.asarray(jax_lj_fluid.init_state(jax_override(JaxMDConfig(), **SLICE)).position)
    np.testing.assert_allclose(pos_t, pos_j, rtol=1e-6)
    v = lj_fluid.init_state(override(cfg, n=20_000), "cpu").velocity
    assert abs(float(v.var()) - cfg.kt) < 0.05  # drawn from a torch.Generator, not jax.random


def test_equilibrate_production_match_jax():
    """``equilibrate`` + ``production`` over 140 steps from one numpy state.
    Both packages run the lane-packed layout here (cps 12 packs R=6), the
    JAX package's B3 against the port's; histories at rtol 1e-4 and
    positions at 1e-4 * box: the same physics summed in another order."""
    cfg_j = jax_override(JaxMDConfig(), **SLICE)
    cfg_t = override(MDConfig(), **SLICE)
    s0 = jax_lj_fluid.init_state(cfg_j)
    with exact_pallas_reciprocal():
        eq_j, ovf_eq_j = jax_lj_fluid.equilibrate(cfg_j, s0)
        fin_j, (r_j, ke_j, pe_j), ovf_j = jax_lj_fluid.production(cfg_j, eq_j)
    st = particle_state_from_numpy(np.asarray(s0.position), np.asarray(s0.velocity), device="cpu")
    eq_t, ovf_eq_t = lj_fluid.equilibrate(cfg_t, st)
    fin_t, (r_t, ke_t, pe_t), ovf_t = lj_fluid.production(cfg_t, eq_t)
    assert bool(ovf_eq_t) == bool(ovf_eq_j) is False
    assert bool(ovf_t) == bool(ovf_j) is False
    box = cfg_t.box_size
    assert periodic_distance(eq_t.position.numpy(), np.asarray(eq_j.position), box).max() <= 1e-4 * box
    assert r_t.shape == (5, 1024, 2) and tuple(r_j.shape) == (5, 1024, 2)
    assert periodic_distance(r_t.numpy(), np.asarray(r_j), box).max() <= 1e-4 * box
    np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-4)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-4)
    np.testing.assert_allclose(float(fin_t.time), float(fin_j.time), rtol=1e-6)


def test_rdf_matches_jax():
    """No subset below 4096 particles: the histograms agree up to the
    float32 rounding of the bin edges (a pair on an edge may change bin)."""
    n, box = 300, float(np.sqrt(300 / 0.8))
    hist = np.stack([np.mod(lattice_positions(n, box, jitter=0.2, seed=s), box) for s in range(3)])
    nbins, r_max = int((box / 2) / 0.05), box / 2
    r_t, g_t = radial_distribution(torch.from_numpy(hist), box, nbins, r_max)
    r_j, g_j = jax_radial_distribution(jnp.asarray(hist), box, nbins, r_max)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5, atol=1e-6)
    diff = np.abs(g_t.numpy() - np.asarray(g_j))
    assert (diff > 1e-4).sum() <= 2, diff.max()
    # the subset path: 4096 of 5000 particles, finite and near 1 far out
    big = torch.from_numpy(np.mod(lattice_positions(5000, 80.0, jitter=0.5, seed=1), 80.0))[None]
    _, g_big = radial_distribution(big, 80.0, 40, 40.0)
    assert bool(torch.isfinite(g_big).all()) and abs(float(g_big[-10:].mean()) - 1.0) < 0.1


def test_thermo_matches_jax():
    pos, vel = lattice_positions(64, 9.0), velocities(64, kt=1.5)
    st = particle_state_from_numpy(pos, vel, device="cpu")
    sj = JaxParticleState.create(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_allclose(float(kinetic_energy(st)), float(jax_kinetic_energy(sj)), rtol=1e-6)
    np.testing.assert_allclose(float(temperature(st)), float(jax_temperature(sj)), rtol=1e-6)


def test_run_end_to_end_cpu():
    cfg = override(MDConfig(), n=400, rho=0.5, cutoff=2.5, force_impl="grid", init="lattice",
                   eq_steps=100, prod_steps=200, sample_every=20)
    res = lj_fluid.run(cfg, device="cpu")
    assert tuple(res.r_history.shape) == (10, 400, 2)
    assert bool(torch.isfinite(res.r_history).all())
    assert res.energy_drift < 0.05 and not res.overflow
    assert np.isfinite(res.pressure) and res.kt_eq > 0
    assert res.rdf_r.shape == res.rdf_g.shape == (int((cfg.box_size / 2) / cfg.rdf_dr),)
    assert res.particle_steps_per_sec > 0 and res.rdf_subset == 0


def test_unported_paths_raise():
    """Every force path resolves now (tests/test_torch_lj_fluid_paths.py
    runs them), and so does the Langevin thermostat on the grid engine
    (tests/test_torch_langevin.py); an unknown thermostat raises."""
    base = override(MDConfig(), n=5000, cutoff=2.5)
    assert lj_fluid.resolve_impl(base) == "grid"
    assert lj_fluid.resolve_impl(override(base, force_impl="dense_xla")) == "dense_xla"
    assert lj_fluid.resolve_impl(override(base, n=400), "cpu") == "dense_xla"
    with pytest.raises(ValueError, match="requires a cutoff"):
        lj_fluid.resolve_impl(override(base, cutoff=None, force_impl="grid"))
    with pytest.raises(ValueError, match="unknown thermostat"):
        lj_fluid.equilibrate(override(base, thermostat="berendsen"), lj_fluid.init_state(base, "cpu"))
    assert lj_fluid._grid_seed(override(base, thermostat="langevin")) == base.seed + 0x5EED
    assert lj_fluid._grid_seed(base) is None
    with pytest.raises(ValueError, match="sample_every"):
        lj_fluid.production(override(base, prod_steps=50), lj_fluid.init_state(base, "cpu"))


def test_cli_md_cpu(capsys):
    rc = cli.main(["md", "--N", "400", "--rho", "0.5", "--cutoff", "2.5", "--force-impl", "grid",
                   "--init", "lattice", "--eq_steps", "40", "--prod_steps", "40",
                   "--sample_every", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "throughput:" in out and "energy drift:" in out and "P* =" in out
    assert "OVERFLOW" not in out
    assert cli.main(["md", "--N", "400", "--force-impl", "neighbor", "--device", "cpu"]) == 2  # no cutoff
    assert cli.main(["md", "--N", "5000", "--cutoff", "2.5", "--force-impl", "neighbor",
                     "--thermostat", "langevin", "--device", "cpu"]) == 2  # grid engine only
