"""The 3D grid-resident MD engine of the PyTorch port against the JAX
package's ``GridMD3`` (hybrid static/dynamic forces, kernels B4/B5 in
interpret mode): the same initial slots, one window, the gated and the
fixed-cadence drivers over windows and rebuilds, compared per particle;
plus the flags that must stay loud and the carried JAX state. The checks
of the core both engines share are in ``test_torch_grid_engine.py``.

On the JAX side the drivers rebuild with the JAX package's own
``_rebuild_migrate_rows`` (the same allocation and permutation in plain
jnp): its migrate kernel B6 takes ~25 s to compile per program in
interpret mode, and is held against the port bit for bit in
``test_torch_migrate3``."""

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
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid3_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import (
    GRID3_STATE_FIELDS,
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    periodic_distance,
    velocities,
)

N, BOX, DT = 216, 12.0, 2e-3  # rho 0.125: cps 4, cap 16, static_cov 8
STEPS, K, GATE, CADENCE = 60, 5, 0.25, 7  # 60 = 8 * 7 + 4: a remainder block


def _count_calls(obj, *names) -> dict:
    """Wraps the named callables of ``obj`` to count their calls."""
    counts = dict.fromkeys(names, 0)

    def counted(name, fn):
        def call(*args):
            counts[name] += 1
            return fn(*args)

        return call

    for name in names:
        setattr(obj, name, counted(name, getattr(obj, name)))
    return counts


def _engines():
    kw = dict(dt=DT, compensated=True, static_cov="auto", migrate_k_mov=8)
    md_j = JaxGridMD3(jax_make_cell_grid_fn(BOX, 2.5, N, dim=3), **kw)
    md_j._rebuild_migrate = md_j._rebuild_migrate_rows
    md_t = GridMD3(make_cell_grid_fn(BOX, 2.5, N, dim=3), device="cpu", **kw)
    pos = np.mod(lattice_positions(N, BOX, jitter=0.1, seed=8, dim=3), BOX)
    return md_j, md_t, pos, velocities(N, kt=1.0, seed=9, dim=3)


@pytest.fixture(scope="module")
def runs():
    """Both engines from one numpy state: the initial grids, one window,
    and the state after ``STEPS`` steps of the gated and of the fixed
    driver. The port counts its rebuilds and its B4 and B5 force calls."""
    md_j, md_t, pos, vel = _engines()
    with exact_pallas_reciprocal():
        init_j = md_j.init(jnp.asarray(pos), jnp.asarray(vel))
        win_j = jax.jit(md_j._make_window(md_j.force_kernel_static, K))(init_j)
        gated_j = jax.jit(md_j.make_production_run(STEPS, K, gate_frac=GATE))(init_j)
        fixed_j = jax.jit(md_j.make_production_run_fixed(STEPS, CADENCE))(init_j)
    init_t = md_t.init(torch.from_numpy(pos), torch.from_numpy(vel))
    counts = _count_calls(md_t, "_rebuild_migrate", "force_kernel", "force_kernel_static")
    win_t = md_t._window_for(init_t, K)(init_t)
    gated_t = md_t.make_production_run(STEPS, K, gate_frac=GATE)(init_t)
    fixed_t = md_t.make_production_run_fixed(STEPS, CADENCE)(init_t)
    return dict(md_j=md_j, md_t=md_t, pos=pos, vel=vel, counts=counts,
                init=(init_j, init_t), window=(win_j, win_t), gated=(gated_j, gated_t),
                fixed=(fixed_j, fixed_t))


def test_init_matches_jax(runs):
    """``init``: the same slots bit for bit, forces at 1e-4 (see
    test_torch_cell_force3), and the round trip back to particle order."""
    md_j, md_t = runs["md_j"], runs["md_t"]
    init_j, init_t = runs["init"]
    live = md_t.plane
    for name in ("pid", "occ", "xg", "yg", "zg", "vxg", "vyg", "vzg"):
        np.testing.assert_array_equal(
            getattr(init_t, name).numpy(), np.asarray(getattr(init_j, name))[:, :, :live], err_msg=name
        )
    for name in ("fxg", "fyg", "fzg"):
        np.testing.assert_allclose(
            getattr(init_t, name).numpy(), np.asarray(getattr(init_j, name))[:, :, :live], rtol=1e-4, atol=1e-4
        )
    assert int(init_t.max_occ) == int(init_j.max_occ)
    assert bool(init_t.overflow) == bool(init_j.overflow) is False
    np.testing.assert_array_equal(md_t.positions(init_t).numpy(), runs["pos"])
    np.testing.assert_array_equal(md_t.velocities(init_t).numpy(), runs["vel"])
    np.testing.assert_array_equal(md_t.forces(init_t).numpy()[:, 2], md_t.particle_order(init_t, init_t.fzg)[:, 0])


@pytest.mark.parametrize("which", ["window", "gated", "fixed"])
def test_trajectory_matches_jax(runs, which):
    """One window and both drivers: positions at 1e-5 * box (periodic
    distance), velocities at rtol 1e-5 with atol 1e-5 (components cross
    zero), KE at rtol 1e-5, the same flags, max occupancy and elapsed
    time."""
    md_j, md_t = runs["md_j"], runs["md_t"]
    s_j, s_t = runs[which]
    assert bool(s_t.overflow) == bool(s_j.overflow) is False
    d = periodic_distance(md_t.positions(s_t).numpy(), np.asarray(md_j.positions(s_j)), md_t.box)
    assert d.max() <= 1e-5 * md_t.box, d.max()
    np.testing.assert_allclose(md_t.velocities(s_t).numpy(), np.asarray(md_j.velocities(s_j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(md_t.kinetic_energy(s_t)), float(md_j.kinetic_energy(s_j)), rtol=1e-5)
    assert int(s_t.max_occ) == int(s_j.max_occ)
    np.testing.assert_allclose(float(s_t.time), float(s_j.time), rtol=1e-6)


def test_drivers_rebuild(runs):
    """The runs above went through rebuilds (the fixed driver rebuilds
    before each of its 9 blocks) and ran their windows on B5, whose bound
    covers every cell here; B4 ran only in ``init``."""
    counts = runs["counts"]
    assert counts["_rebuild_migrate"] >= 9 + 2
    assert counts["force_kernel_static"] == K + 2 * STEPS
    assert counts["force_kernel"] == 0


def test_hybrid_falls_back_to_dynamic_kernel():
    """Where the max occupancy exceeds B5's bound, the hybrid engine runs
    its window on B4, raises no flag, and follows the dynamic engine's
    trajectory exactly (the same kernel and summation order)."""
    n = 1000  # rho 0.58: cps 4, cap 32, B5 bound 24
    gf = make_cell_grid_fn(BOX, 2.5, n, dim=3)
    # the lattice squeezed to 0.9 of the box: 27 particles in the fullest cells
    pos = torch.from_numpy(lattice_positions(n, BOX, seed=12, dim=3) * np.float32(0.9))
    vel = torch.from_numpy(velocities(n, kt=1.0, seed=13, dim=3))
    md_h = GridMD3(gf, dt=DT, static_cov="auto", device="cpu")
    md_d = GridMD3(gf, dt=DT, device="cpu")
    gs_h, gs_d = md_h.init(pos, vel), md_d.init(pos, vel)
    assert int(gs_h.max_occ) > md_h.static_cov == 24
    counts = _count_calls(md_h, "force_kernel", "force_kernel_static")
    out_h = md_h.make_chunk_step(5)(gs_h)
    out_d = md_d.make_chunk_step(5)(gs_d)
    assert not bool(out_h.overflow)
    assert counts == {"force_kernel": 5, "force_kernel_static": 0}
    assert torch.equal(md_h.positions(out_h), md_d.positions(out_d))


def test_grid3_state_from_jax(runs):
    """A JAX state carried into the port drops the padding lanes and keeps
    every particle's values, ``pid`` as int32 and ``max_occ`` as a 0-d
    int32; the port's observables on it are the JAX package's."""
    md_j, md_t = runs["md_j"], runs["md_t"]
    s_j = runs["gated"][0]
    assert np.asarray(s_j.xg).shape == (4, 16, 128)
    s_t = grid3_state_from_jax(jax_grid_arrays(s_j, GRID3_STATE_FIELDS), md_t)
    assert tuple(s_t.xg.shape) == (4, 16, 16) and s_t.xg.is_contiguous()
    assert s_t.pid.dtype == torch.int32 and s_t.max_occ.dtype == torch.int32 and s_t.max_occ.dim() == 0
    assert s_t.crz is not None and s_t.overflow.dtype == torch.bool
    np.testing.assert_array_equal(md_t.positions(s_t).numpy(), np.asarray(md_j.positions(s_j)))
    np.testing.assert_array_equal(md_t.velocities(s_t).numpy(), np.asarray(md_j.velocities(s_j)))
    assert float(s_t.time) == float(s_j.time) and float(s_t.dmax2) == float(s_j.dmax2)


def test_nan_state_trips_overflow(runs):
    """Diverged physics (NaN velocities) trips the violation flag instead
    of sailing past the NaN-poisoned displacement monitor."""
    md_t = runs["md_t"]
    _, init_t = runs["init"]
    s = init_t.replace(vxg=init_t.vxg * float("nan"))
    assert bool(md_t.make_chunk_step(5)(s).overflow)
    assert bool(md_t.make_production_run_fixed(10, 5)(s).overflow)


def test_oversized_cadence_trips_flag():
    """A fixed cadence far past the skin/2 drift horizon raises the
    violation flag: the fixed driver's only safety net is loud."""
    md = GridMD3(make_cell_grid_fn(BOX, 2.5, N, dim=3), dt=5e-3, static_cov="auto", device="cpu")
    pos = np.mod(lattice_positions(N, BOX, seed=10, dim=3), BOX)
    gs = md.init(torch.from_numpy(pos), torch.from_numpy(velocities(N, kt=2.0, seed=11, dim=3)))
    assert md.auto_cadence(2.0, 120) < 60
    assert not bool(md.make_production_run_fixed(120, md.auto_cadence(2.0, 120))(gs).overflow)
    assert bool(md.make_production_run_fixed(120, 60)(gs).overflow)


def test_unported_and_invalid_raise():
    gf = make_cell_grid_fn(BOX, 2.5, N, dim=3)
    md = GridMD3(gf)
    # a Langevin window on a state without a noise stream
    md_c = GridMD3(gf, device="cpu")
    pos = np.mod(lattice_positions(N, BOX, seed=1, dim=3), BOX)
    gs = md_c.init(torch.from_numpy(pos), torch.from_numpy(velocities(N, dim=3)))
    with pytest.raises(ValueError, match="PRNG"):
        md_c.make_chunk_step(5, thermostat=(1.0, 1.0))(gs)
    with pytest.raises(ValueError, match="PRNG"):
        md_c.make_production_run(20, 5, thermostat=(1.0, 1.0))(gs)
    with pytest.raises(ValueError, match="NVE"):
        md.make_production_run_fixed(20, 5, thermostat=(1.0, 1.0))
    with pytest.raises(ValueError, match="n_inner"):
        md.make_production_run(25, 10)
    with pytest.raises(ValueError, match="cadence"):
        md.make_production_run_fixed(25, 0)
    with pytest.raises(ValueError, match="static_cov"):
        GridMD3(gf, static_cov=gf.capacity + 8)
    with pytest.raises(ValueError):
        GridMD3(make_cell_grid_fn(20.0, 2.5, 400, dim=2))
    with pytest.raises(ValueError):
        GridMD(gf)
    assert md.device == torch.device("cuda")  # the card unless the caller asks for the CPU
