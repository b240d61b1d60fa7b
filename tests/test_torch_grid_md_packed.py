"""The 2D grid engine of the PyTorch port on the lane-packed layout (R = 4
cell rows a block, G = 4 blocks) against the JAX package's ``GridMD`` with
``rows_per_block=4`` (kernels B3 and B2 in interpret mode): the initial
slots, the allocation and the rebuild, the fixed-cadence driver, and a
packed JAX state carried over. The chunked trajectory and single steps are
in ``test_torch_grid_md_packed_drivers.py`` (each JAX program takes seconds
to compile in interpret mode)."""

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
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import (
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    periodic_distance,
    velocities,
)

N, RHO, DT, R = 1200, 0.5, 2e-3, 4  # cps 16, cap 16: grid (4, 16, 64)
GRID_FIELDS = ("xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "pid", "crx", "cry", "cvx", "cvy")


def engines():
    box = float(np.sqrt(N / RHO))
    md_j = JaxGridMD(jax_make_cell_grid_fn(box, 2.5, N, dim=2), dt=DT, compensated=True, rows_per_block=R)
    md_t = GridMD(make_cell_grid_fn(box, 2.5, N, dim=2), dt=DT, compensated=True, rows_per_block=R,
                  device="cpu")
    pos = np.mod(lattice_positions(N, box, seed=12), box)
    return md_j, md_t, pos, velocities(N, kt=1.0, seed=13)


@pytest.fixture(scope="module")
def states():
    """Both engines' initial states from one numpy state, and a Kahan state
    advanced window -> rebuild -> window in JAX with its allocation and
    rebuild, carried into the port."""
    md_j, md_t, pos, vel = engines()
    with exact_pallas_reciprocal():
        init_j = md_j.init(jnp.asarray(pos), jnp.asarray(vel))
        window = jax.jit(md_j._make_window(md_j.force_kernel, 20))
        rebuild = jax.jit(md_j._rebuild_migrate)
        gs_j = window(rebuild(window(init_j)))
        rb_j = rebuild(gs_j)
    dest_j = jax.jit(md_j._migration_dest)(gs_j)
    init_t = md_t.init(torch.from_numpy(pos), torch.from_numpy(vel))
    return md_j, md_t, init_j, init_t, gs_j, grid_state_from_jax(jax_grid_arrays(gs_j), md_t), dest_j, rb_j


def _lanes(a, md):
    return np.asarray(a)[:, :, : md.lanes]


def test_init_slots_match_jax(states):
    md_j, md_t, init_j, init_t, *_ = states
    assert md_t.grid_shape == (4, 16, 64) and md_j.grid_shape == (4, 16, 128)
    for name in ("pid", "occ", "xg", "yg", "vxg", "vyg"):
        np.testing.assert_array_equal(getattr(init_t, name).numpy(), _lanes(getattr(init_j, name), md_t),
                                      err_msg=name)
    for name in ("fxg", "fyg"):  # see test_torch_cell_force_packed for the tolerance
        want = _lanes(getattr(init_j, name), md_t)
        np.testing.assert_allclose(getattr(init_t, name).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert bool(init_t.overflow) == bool(init_j.overflow) is False


def test_migration_dest_matches_jax(states):
    """The codes and the new occupancy, integer-exact on the packed layout."""
    md_t, gs_t, dest_j = states[1], states[5], states[6]
    xw_j, yw_j, scode_j, occ_j, _, ovf_j = dest_j
    xw_t, yw_t, scode_t, occ_t, ovf_t, _ = md_t._migration_dest(gs_t)
    scode_j = _lanes(scode_j, md_t)
    np.testing.assert_array_equal(scode_t.numpy(), scode_j)
    np.testing.assert_array_equal(occ_t.numpy(), _lanes(occ_j, md_t))
    np.testing.assert_array_equal(xw_t.numpy(), _lanes(xw_j, md_t))
    assert bool(ovf_t) == bool(ovf_j) is False
    dcode = scode_j[scode_j >= 0] // md_t.cap
    assert (dcode != 4).sum() > 0  # some particles change cell
    # movers that cross a block boundary (sub-row 0 down, or R-1 up)
    sub = (np.arange(md_t.lanes) // md_t.cps)[None, None, :].repeat(16, 1).repeat(4, 0)
    dx = np.where(scode_j >= 0, scode_j // md_t.cap // 3 - 1, 0)
    assert ((dx == -1) & (sub == 0)).sum() > 0 and ((dx == 1) & (sub == R - 1)).sum() > 0
    assert int(occ_t.sum()) == N


def test_rebuild_matches_jax_and_sort_oracle(states):
    md_t, gs_t, rb_j = states[1], states[5], states[7]
    rb_t = md_t._rebuild_migrate(gs_t)
    for name in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(rb_t, name).numpy(), _lanes(getattr(rb_j, name), md_t),
                                      err_msg=name)
    assert bool(rb_t.overflow) == bool(rb_j.overflow) is False
    # the sort-based oracle puts every particle at the same position and
    # velocity (its slots within a cell follow another order)
    srt = md_t._rebuild(gs_t)
    assert not bool(srt.overflow) and int(srt.occ.sum()) == N
    np.testing.assert_array_equal(md_t.positions(srt).numpy(), md_t.positions(rb_t).numpy())
    np.testing.assert_array_equal(md_t.velocities(srt).numpy(), md_t.velocities(rb_t).numpy())
    np.testing.assert_array_equal(torch.sort(srt.occ.sum(1).flatten()).values.numpy(),
                                  torch.sort(rb_t.occ.sum(1).flatten()).values.numpy())


def close_to_jax(md_t, s_t, md_j, s_j, tol):
    """Positions (periodic distance) and velocities per particle at ``tol``,
    the same overflow flag, the same elapsed time."""
    d = periodic_distance(md_t.positions(s_t).numpy(), np.asarray(md_j.positions(s_j)), md_t.box)
    assert d.max() <= tol, d.max()
    np.testing.assert_allclose(md_t.velocities(s_t).numpy(), np.asarray(md_j.velocities(s_j)), rtol=tol, atol=tol)
    assert bool(s_t.overflow) == bool(s_j.overflow)
    np.testing.assert_allclose(float(s_t.time), float(s_j.time), rtol=1e-6)


def test_fixed_cadence_driver_and_auto_cadence_match_jax(states):
    md_j, md_t, init_j, init_t = states[:4]
    for kt in (0.5, 1.0, 2.0):
        for steps in (100, 2000, 10**6):
            assert md_t.auto_cadence(kt, steps) == md_j.auto_cadence(kt, steps)
    with exact_pallas_reciprocal():
        run_j = jax.jit(md_j.make_production_run_fixed(60, 7))(init_j)  # 8 blocks + a remainder of 4
    run_t = md_t.make_production_run_fixed(60, 7)(init_t)
    close_to_jax(md_t, run_t, md_j, run_j, 2e-4)
    assert not bool(run_t.overflow)
    with pytest.raises(ValueError, match="NVE"):
        md_t.make_production_run_fixed(60, 7, thermostat=(1.0, 1.0))


def test_carried_packed_state_gives_jax_forces(states):
    """A packed JAX state carried over (padding lanes dropped): the port's
    forces on it match the JAX state's own within 1e-5 of the largest."""
    md_t, gs_j, gs_t = states[1], states[4], states[5]
    assert tuple(gs_t.xg.shape) == md_t.grid_shape and gs_t.rng_seed is None
    fx, fy = md_t.force_kernel(gs_t.xg, gs_t.yg, gs_t.counts)
    for got, name in ((fx, "fxg"), (fy, "fyg")):
        want = _lanes(getattr(gs_j, name), md_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
