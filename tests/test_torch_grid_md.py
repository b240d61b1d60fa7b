"""The grid-resident MD engine of the PyTorch port against the JAX
package's ``GridMD`` (unpacked layout, kernels B1/B2 in interpret mode):
the same initial slots, the same trajectory over windows and rebuilds, and
the port's forces against its dense oracle."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import (
    exact_pallas_reciprocal,
    lattice_positions,
    periodic_distance,
    velocities,
)

N, RHO, DT = 512, 0.8, 2e-3  # cps 8, cap 24
STEPS, K, GATE = 100, 10, 0.25


def _engines(compensated=True):
    box = float(np.sqrt(N / RHO))
    md_j = JaxGridMD(jax_make_cell_grid_fn(box, 2.5, N, dim=2), dt=DT,
                     compensated=compensated, rows_per_block=1)
    md_t = GridMD(make_cell_grid_fn(box, 2.5, N, dim=2), dt=DT, compensated=compensated, rows_per_block=1,
                  device="cpu")
    pos = np.mod(lattice_positions(N, box, seed=8), box)
    return md_j, md_t, pos, velocities(N, kt=1.0, seed=9)


@pytest.fixture(scope="module")
def runs():
    """Both engines from one numpy state: the initial grids, and the state
    after ``STEPS`` steps of the gated production driver. The port counts
    its rebuilds."""
    md_j, md_t, pos, vel = _engines()
    with exact_pallas_reciprocal():
        init_j = md_j.init(jnp.asarray(pos), jnp.asarray(vel))
        run_j = jax.jit(md_j.make_production_run(STEPS, K, gate_frac=GATE))(init_j)
        pe_j = float(md_j.potential_energy(run_j))
    init_t = md_t.init(torch.from_numpy(pos), torch.from_numpy(vel))
    rebuilds = []
    rebuild = md_t._rebuild_migrate
    md_t._rebuild_migrate = lambda s: rebuilds.append(1) or rebuild(s)
    run_t = md_t.make_production_run(STEPS, K, gate_frac=GATE)(init_t)
    return md_j, md_t, init_j, init_t, run_j, run_t, pe_j, len(rebuilds)


def test_init_slots_match_jax(runs):
    md_j, md_t, init_j, init_t, *_ = runs
    cps = md_t.cps
    for name in ("pid", "occ", "xg", "yg", "vxg", "vyg"):
        np.testing.assert_array_equal(
            getattr(init_t, name).numpy(), np.asarray(getattr(init_j, name))[:, :, :cps], err_msg=name
        )
    for name in ("fxg", "fyg"):  # see test_torch_cell_force for the tolerance
        np.testing.assert_allclose(
            getattr(init_t, name).numpy(), np.asarray(getattr(init_j, name))[:, :, :cps],
            rtol=1e-4, atol=1e-4,
        )
    assert bool(init_t.overflow) == bool(init_j.overflow) is False


def test_production_run_matches_jax(runs):
    """Positions at 1e-5 * box (periodic distance), velocities at rtol 1e-5
    with atol 1e-5 (components cross zero), KE and PE at rtol 1e-5, the
    same overflow flag, the same elapsed time."""
    md_j, md_t, _, _, run_j, run_t, pe_j, n_rebuilds = runs
    assert n_rebuilds >= 2  # at least one inside the run, plus the trailing one
    assert bool(run_t.overflow) == bool(run_j.overflow) is False
    d = periodic_distance(md_t.positions(run_t).numpy(), np.asarray(md_j.positions(run_j)), md_t.box)
    assert d.max() <= 1e-5 * md_t.box, d.max()
    np.testing.assert_allclose(
        md_t.velocities(run_t).numpy(), np.asarray(md_j.velocities(run_j)), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(float(md_t.kinetic_energy(run_t)), float(md_j.kinetic_energy(run_j)), rtol=1e-5)
    np.testing.assert_allclose(float(md_t.potential_energy(run_t)), pe_j, rtol=1e-5)
    np.testing.assert_allclose(float(run_t.time), float(run_j.time), rtol=1e-6)


def test_grid_forces_match_dense_oracle(runs):
    """The carried grid forces of the advanced state against the dense
    float32 oracle at atol 1e-4, on particles at least cutoff + skin from
    the seams (there both subtract the same float32 coordinates; the seam
    case is checked in float64 in test_torch_cell_force)."""
    md_t, run_t = runs[1], runs[5]
    pos = md_t.positions(run_t)
    f_grid = md_t.particle_order(run_t, run_t.fxg, run_t.fyg)
    margin = md_t.grid_fn.cutoff + md_t.skin
    rows = torch.nonzero(((pos >= margin) & (pos < md_t.box - margin)).all(dim=1)).squeeze(1)
    assert rows.numel() > N // 3
    f_dense = LennardJones(box=md_t.box, cutoff=md_t.grid_fn.cutoff).force(pos, rows)
    np.testing.assert_allclose(f_grid[rows].numpy(), f_dense.numpy(), atol=1e-4)


def test_chunk_driver_matches_production_driver(runs):
    """``make_chunk_step`` (gate checked before every window) follows the
    same trajectory as ``make_production_run``, per particle."""
    _, md_t, _, init_t, _, run_t, _, _ = runs
    chunk = md_t.make_chunk_step(K, gate_frac=GATE)
    s = init_t
    for _ in range(STEPS // K):
        s = chunk(s)
    d = periodic_distance(md_t.positions(s).numpy(), md_t.positions(run_t).numpy(), md_t.box)
    assert d.max() <= 1e-5
    np.testing.assert_allclose(md_t.velocities(s).numpy(), md_t.velocities(run_t).numpy(), atol=1e-6)


def test_violation_flag_on_oversized_window():
    """A window far longer than the skin allows raises the overflow flag."""
    box = float(np.sqrt(400 / 0.5))
    md = GridMD(make_cell_grid_fn(box, 2.5, 400, dim=2), dt=5e-3, device="cpu")
    pos = np.mod(lattice_positions(400, box, seed=10), box)
    gs = md.init(torch.from_numpy(pos), torch.from_numpy(velocities(400, kt=2.0, seed=11)))
    assert not bool(gs.overflow)
    assert bool(md.make_chunk_step(300)(gs).overflow)


def test_auto_params_match_jax():
    for n in (4000, 16384, 100_000):
        box = float(np.sqrt(n / 0.8))
        for dt in (1e-4, 1e-3, 5e-3, 2e-2):
            md_j = JaxGridMD(jax_make_cell_grid_fn(box, 2.5, n, dim=2), dt=dt, rows_per_block=1)
            md_t = GridMD(make_cell_grid_fn(box, 2.5, n, dim=2), dt=dt, rows_per_block=1)
            for kt in (0.25, 1.0, 2.0):
                assert md_t.auto_chunk_params(kt) == md_j.auto_chunk_params(kt), (n, dt, kt)
                assert md_t.auto_inner_steps(kt) == md_j.auto_inner_steps(kt), (n, dt, kt)
    assert md_t.auto_chunk_params(1.0) == (1, 0.25)
    gf = make_cell_grid_fn(float(np.sqrt(100_000 / 0.8)), 2.5, 100_000, dim=2)
    assert (gf.cells_per_side, gf.capacity) == (121, 16)
    assert GridMD(gf).auto_chunk_params(1.0) == (4, 0.4)


def test_unported_layouts_raise():
    """R = 4 builds the packed (cps/4, cap, 4*cps) grid, a non-divisor R
    raises; so do a 3D geometry and a window that does not divide the run."""
    gf = make_cell_grid_fn(float(np.sqrt(1200 / 0.5)), 2.5, 1200, dim=2)
    md = GridMD(gf, rows_per_block=4)
    assert (gf.cells_per_side, gf.capacity) == (16, 16)
    assert md.grid_shape == (4, 16, 64) and md.size == 16 * 16 * 16
    with pytest.raises(ValueError, match="must divide"):
        GridMD(gf, rows_per_block=3)
    with pytest.raises(ValueError):
        GridMD(make_cell_grid_fn(20.0, 2.5, 1000, dim=3))
    with pytest.raises(ValueError, match="n_inner"):
        GridMD(gf).make_production_run(25, 10)
