"""The port's row-sharded 2D engine (``parallel/grid_md_sharded.py``)
against its unsharded engine and against the JAX package's
``ShardedGridMD``.

The sharded engine runs at P = 1 in this process (no process group: the
exchange is a local swap) and at P = 2 and 4 on gloo ranks on the CPU
(``parallel.spawn.run_ranks``, one spawn per rank count). The rank-side
checks are ``tests/torch_sharded.py``'s, on the JAX package's sharded
test setup (N = 1600, 16 cells per side).

Tolerances: the halo kernels' plain versions over P row blocks are
bit-equal to the full ones, the rebuild moves values only, and the
reductions the drivers read (``dmax2``, the flags) are maxima, so forces,
positions and velocities must equal the unsharded engine's exactly;
energy, virial, pressure and kinetic energy are sums over ranks in another
order (rtol 1e-5). Against JAX, whose B1 halves by Newton's law and so
sums in another order, positions after the chunked run at
``scaling._check_parity``'s rtol = atol = 2e-4 (periodic distance)."""

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
from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md_sharded import ShardedGridMD as JaxShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.scaling import PARITY_TOL
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
from tests import torch_sharded as ts
from tests.torch_parity import exact_pallas_reciprocal, periodic_distance

DIM = 2
RANKS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs():
    """The unsharded engine's scenario ("plain") and the sharded engine's at
    each P (rank 0's; P = 2 adds the Langevin run)."""
    return {
        "plain": ts.scenario(DIM, sharded=False),
        1: ts.scenario(DIM, sharded=True),
        2: run_ranks(ts.scenario_with_langevin, 2, DIM)[0],
        4: run_ranks(ts.scenario, 4, DIM, True)[0],
    }


@pytest.mark.parametrize("p", RANKS)
def test_forces_and_energies_match_unsharded(runs, p):
    plain, out = runs["plain"], runs[p]
    assert out["rows"] == 16 // p
    assert out["shard_state_equal"]
    np.testing.assert_array_equal(out["forces"], plain["forces"])
    for name in ("pe", "virial", "pressure", "ke"):
        np.testing.assert_allclose(out[name], plain[name], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("p", RANKS)
def test_chunked_run_matches_unsharded(runs, p):
    """50 steps in 10-step chunks with at least one rebuild: the same
    rebuilds and bit-equal positions and velocities."""
    plain, out = runs["plain"], runs[p]
    assert out["rebuilds"] == plain["rebuilds"] >= 1
    np.testing.assert_array_equal(out["positions"], plain["positions"])
    np.testing.assert_array_equal(out["velocities"], plain["velocities"])
    assert out["overflow"] is plain["overflow"] is False


@pytest.mark.parametrize("p", RANKS)
def test_flags_raised_where_unsharded_raises(runs, p):
    plain, out = runs["plain"], runs[p]
    for flag, expected in (("far_mover_overflow", True), ("skin_overflow", True), ("clean_rebuild_overflow", False)):
        assert out[flag] is plain[flag] is expected, flag


@pytest.mark.parametrize("p", (2, 4))
def test_chunked_run_matches_jax_sharded(runs, p):
    """JAX's ShardedGridMD on P virtual devices, the same chunks from the
    same numpy start, against the port's on P gloo ranks."""
    gf, pos, vel = ts.setup(DIM)
    jgf = jax_make_cell_grid_fn(gf.box, ts.CUTOFF, gf.n, dim=DIM, skin=ts.SKIN, rho=gf.n / gf.box**DIM)
    local = JaxGridMD(jgf, dt=ts.DT, rows_per_block=1)
    sharded = JaxShardedGridMD(jgf, jax_make_mesh(p, axis_name="x"), dt=ts.DT)
    chunk = sharded.make_chunk_step(ts.K, gate_frac=ts.GATE)
    with exact_pallas_reciprocal():
        gs = sharded.shard_state(local.init(jnp.asarray(pos), jnp.asarray(vel)))
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, ts.STEPS // ts.K, lambda i, t: chunk(t), s))(gs)
    assert not bool(gs.overflow)
    p_j = np.asarray(local.positions(gs))
    p_t = runs[p]["positions"]
    d = periodic_distance(p_t, p_j, gf.box)
    assert np.all(d <= PARITY_TOL + PARITY_TOL * np.abs(p_j)), float(d.max())


def test_mesh_must_divide_cells():
    gf, _, _ = ts.setup(DIM)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedGridMD(gf, RowMesh(rank=0, size=3, device=torch.device("cpu")))


def test_langevin_kt_at_two_ranks(runs):
    """BAOAB windows at bath kT 1 on 2 ranks, each with its own noise
    stream: the mean kinetic temperature of 20 samples within 5%."""
    assert runs[2]["langevin_kt"] == pytest.approx(1.0, rel=0.05)


def test_lj_fluid_run_on_a_given_sharded_engine():
    """``lj_fluid.run(..., md=...)`` drives the engine it is given (here
    the sharded one on one rank, as ``chip_smoke.py`` drives it on the
    card) through the same phases as its own engine, with the same result."""
    cfg = override(MDConfig(), n=1600, rho=0.7, cutoff=2.5, force_impl="grid", init="lattice",
                   eq_steps=40, prod_steps=40, sample_every=20)
    plain = lj_fluid._make_grid_md(cfg, "cpu")
    sharded = ShardedGridMD(plain.grid_fn, make_mesh(device="cpu"), dt=cfg.dt, compensated=cfg.compensated)
    got = lj_fluid.run(cfg, device="cpu", md=sharded)
    want = lj_fluid.run(cfg, device="cpu")
    np.testing.assert_array_equal(got.state.position.numpy(), want.state.position.numpy())
    np.testing.assert_allclose(got.pe_history.numpy(), want.pe_history.numpy(), rtol=1e-5)
    assert got.overflow is want.overflow is False and got.pressure == pytest.approx(want.pressure, rel=1e-5)
