"""The 3D slice as a whole: the PyTorch port's ``lj_fluid`` with ``dim=3``
against the JAX package's (geometry and skin policy at the users' sizes,
equilibration + fixed-cadence production from one state), the cadence
rule of ``run`` and its kT guard, and the ``md`` CLI on the CPU (where every
kernel wrapper takes its plain version).

On the JAX side the engine rebuilds with the JAX package's own
``_rebuild_migrate_rows`` (the same allocation and permutation in plain
jnp), as in ``test_torch_grid_md3``: B6's interpret-mode compile would
take most of a minute per program here."""

import math

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
    MDConfig as JaxMDConfig,
    override as jax_override,
)
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid as jax_lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import particle_state_from_numpy
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature
from tests.torch_parity import exact_pallas_reciprocal, periodic_distance

# n=216 at rho 0.125: box 12, the 3D skin policy gives cps 4 (skin 0.5),
# cap 16, B5 bound 8; 4 does not divide by the 8 test devices, so the JAX
# side stays on the single-device engine
SLICE3 = dict(
    n=216, rho=0.125, dim=3, cutoff=2.5, force_impl="grid", init="lattice",
    eq_steps=20, prod_steps=40, sample_every=20, dt=1e-3,
)
USERS = dict(rho=0.8, dim=3, cutoff=2.5, init="lattice", eq_steps=2000, prod_steps=2000, sample_every=100)


@pytest.mark.parametrize("n", [8192, 100_000])
def test_geometry_matches_jax(n):
    """At the users' sizes: the same skin, grid, B5 bound, equilibration
    window and production cadence as the JAX package on one device."""
    cfg_t = override(MDConfig(), n=n, **USERS)
    cfg_j = jax_override(JaxMDConfig(), n=n, **USERS)
    assert lj_fluid.resolve_impl(cfg_t) == "grid"
    skin = lj_fluid.resolve_skin(cfg_t)
    assert skin == jax_lj_fluid.resolve_skin(cfg_j, "grid", n_devices=1)
    assert skin == jax_lj_fluid.resolve_skin(jax_override(cfg_j, force_impl="grid"), n_devices=1)
    md_t = lj_fluid._make_grid_md(cfg_t, "cpu")
    md_j = JaxGridMD3(md_t.grid_fn, static_cov="auto", migrate_k_mov=8)
    assert (md_t.cps, md_t.cap, md_t.static_cov) == (md_j.cps, md_j.cap, md_j.static_cov)
    assert lj_fluid._grid_inner_steps(cfg_t, md_t) == jax_lj_fluid._grid_inner_steps(cfg_j, md_j)
    for kt in (0.5, 1.0):
        assert md_t.auto_cadence(kt, cfg_t.prod_steps) == md_j.auto_cadence(kt, cfg_j.prod_steps)
    if n == 100_000:
        # the README's headline 3D deployment
        assert cfg_t.box_size == pytest.approx(50.0)
        assert round(skin, 4) == 0.1316
        assert (md_t.cps, md_t.cap, md_t.static_cov, md_t.grid_shape) == (19, 32, 24, (19, 32, 361))
        assert lj_fluid._grid_inner_steps(cfg_t, md_t) == (1, 0.4)
        assert md_t.auto_cadence(1.0, 2000) == 9 and md_t.migrate_k_mov == 16
    assert lj_fluid.resolve_skin(override(cfg_t, dim=2)) == lj_fluid.SKIN_DEFAULT


def test_equilibrate_production_match_jax(monkeypatch):
    """``equilibrate`` (gated driver) + ``production`` (fixed cadence from
    the measured kT) over 60 steps from one numpy state. Both run B5 with
    the same bound: histories at rtol 1e-5, positions at 1e-5 * box."""
    monkeypatch.setattr(JaxGridMD3, "_rebuild_migrate", JaxGridMD3._rebuild_migrate_rows)
    cfg_j = jax_override(JaxMDConfig(), **SLICE3)
    cfg_t = override(MDConfig(), **SLICE3)
    s0 = jax_lj_fluid.init_state(cfg_j)
    st = particle_state_from_numpy(np.asarray(s0.position), np.asarray(s0.velocity), device="cpu")
    eq_t, ovf_eq_t = lj_fluid.equilibrate(cfg_t, st)
    cadence = lj_fluid.production_cadence(cfg_t, float(temperature(eq_t)))
    with exact_pallas_reciprocal():
        eq_j, ovf_eq_j = jax_lj_fluid.equilibrate(cfg_j, s0)
        # the JAX package's run computes the cadence from the same kT
        v = np.asarray(eq_j.velocity)
        md_j = jax_lj_fluid._make_grid_md(cfg_j)
        assert cadence == max(1, min(md_j.auto_cadence(float(np.mean(v * v)), cfg_j.prod_steps), cfg_j.sample_every))
        fin_j, (r_j, ke_j, pe_j), ovf_j = jax_lj_fluid.production(cfg_j, eq_j, cadence)
    fin_t, (r_t, ke_t, pe_t), ovf_t = lj_fluid.production(cfg_t, eq_t, cadence)
    assert bool(ovf_eq_t) == bool(ovf_eq_j) is False
    assert bool(ovf_t) == bool(ovf_j) is False
    box = cfg_t.box_size
    assert periodic_distance(eq_t.position.numpy(), np.asarray(eq_j.position), box).max() <= 1e-5 * box
    assert r_t.shape == (2, 216, 3) and tuple(r_j.shape) == (2, 216, 3)
    assert periodic_distance(r_t.numpy(), np.asarray(r_j), box).max() <= 1e-5 * box
    np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-5)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-5)
    np.testing.assert_allclose(float(fin_t.time), float(fin_j.time), rtol=1e-6)


def test_run_3d_cpu_and_cadence_rule():
    """``run`` with ``dim=3`` on the CPU: the production cadence is the
    rule's on the measured kT, the histories are finite, energy holds."""
    cfg = override(MDConfig(), **dict(SLICE3, eq_steps=60, prod_steps=100))
    res = lj_fluid.run(cfg, device="cpu")
    assert not res.overflow
    md = lj_fluid._make_grid_md(cfg, "cpu")
    assert res.cadence == max(1, min(md.auto_cadence(res.kt_eq, cfg.prod_steps), cfg.sample_every))
    assert res.cadence == lj_fluid.production_cadence(cfg, res.kt_eq) == 20
    assert tuple(res.r_history.shape) == (5, 216, 3)
    assert bool(torch.isfinite(res.r_history).all()) and bool(torch.isfinite(res.pe_history).all())
    assert res.energy_drift < 1e-3 and math.isfinite(res.pressure) and res.kt_eq > 0
    assert res.rdf_g.shape == (int((cfg.box_size / 2) / cfg.rdf_dr),)
    # the cadence rule and its guard
    assert lj_fluid.production_cadence(cfg, 1e-6) == cfg.sample_every
    assert lj_fluid.production_cadence(override(cfg, sample_every=1000, prod_steps=2000), 1e4) == 1
    for bad in (float("nan"), 0.0, -1.0):
        assert lj_fluid.production_cadence(cfg, bad) is None
    assert lj_fluid.production_cadence(override(cfg, dim=2), 1.0) is None


def test_run_with_failed_kt_guard_flags_and_completes(monkeypatch):
    """A NaN equilibrated kT (a diverged state) raises the overflow flag and
    falls back to the gated driver; ``run`` does not crash."""
    cfg = override(MDConfig(), **SLICE3)
    monkeypatch.setattr(lj_fluid, "temperature", lambda state: torch.tensor(float("nan")))
    with pytest.warns(UserWarning, match="overflow"):
        res = lj_fluid.run(cfg, device="cpu")
    assert res.overflow and res.cadence is None
    assert tuple(res.r_history.shape) == (2, 216, 3)


def test_cli_md_3d_cpu(capsys):
    rc = cli.main(["md", "--N", "216", "--rho", "0.125", "--dim", "3", "--cutoff", "2.5",
                   "--force-impl", "grid", "--init", "lattice", "--eq_steps", "40",
                   "--prod_steps", "40", "--sample_every", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "dim=3" in out and "ensemble: NVE" in out and "fixed rebuild cadence 20" in out
    assert "B5 (cov 8) / B4 fallback, B6" in out and "4 cells per side, capacity 16" in out
    assert "throughput:" in out and "energy drift:" in out and "P* =" in out
    assert "OVERFLOW" not in out
    assert cli.main(["md", "--N", "5000", "--dim", "3", "--cutoff", "2.5", "--force-impl", "cell",
                     "--thermostat", "langevin", "--device", "cpu"]) == 2  # grid engine only
