"""The port's row-sharded 3D engine (``parallel/grid_md3_sharded.py``,
hybrid B5/B4 halo windows, B6 halo rebuilds with k_mov 8) against its
unsharded engine and against the JAX package's ``ShardedGridMD3``.

The sharded engine runs at P = 1 in this process (no process group: the
exchange is a local swap) and at P = 2 and 4 on gloo ranks on the CPU
(``parallel.spawn.run_ranks``, one spawn per rank count). The rank-side
checks are ``tests/torch_sharded.py``'s, on the JAX package's sharded
test setup (N = 2000, 8 cells per side).

Tolerances: the halo kernels' plain versions over P row blocks are
bit-equal to the full ones, the rebuild moves values only, and the
reductions the drivers read (``dmax2``, the flags) are maxima, so forces,
positions and velocities must equal the unsharded engine's exactly;
energy, virial, pressure and kinetic energy are sums over ranks in another
order (rtol 1e-5). B6's mover flag must rise at the same k_mov as the
unsharded engine's. Against JAX, whose B4 halves by Newton's law and so
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
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md3_sharded import ShardedGridMD3 as JaxShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.scaling import PARITY_TOL
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
from tests import torch_sharded as ts
from tests.torch_parity import exact_pallas_reciprocal, periodic_distance

DIM = 3
RANKS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs():
    """The unsharded engine's scenario ("plain") and the sharded engine's at
    each P (rank 0's)."""
    return {
        "plain": ts.scenario(DIM, sharded=False),
        1: ts.scenario(DIM, sharded=True),
        2: run_ranks(ts.scenario, 2, DIM, True)[0],
        4: run_ranks(ts.scenario, 4, DIM, True)[0],
    }


@pytest.mark.parametrize("p", RANKS)
def test_forces_and_energies_match_unsharded(runs, p):
    plain, out = runs["plain"], runs[p]
    assert out["rows"] == 8 // p
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
    # k_mov 1, 2, 4, 8, cap: raised at the small bounds, never at cap
    assert out["mov_of"] == plain["mov_of"]
    assert plain["mov_of"][0] and not plain["mov_of"][-1]


def test_chunked_run_matches_jax_sharded(runs):
    """JAX's ShardedGridMD3 (k_mov 8) on 2 virtual devices, the same chunks
    from the same numpy start, against the port's at P = 2."""
    gf, pos, vel = ts.setup(DIM)
    jgf = jax_make_cell_grid_fn(gf.box, ts.CUTOFF, gf.n, dim=DIM, skin=ts.SKIN, rho=gf.n / gf.box**DIM)
    local = JaxGridMD3(jgf, dt=ts.DT)
    sharded = JaxShardedGridMD3(jgf, jax_make_mesh(2, axis_name="x"), dt=ts.DT, migrate_k_mov=8)
    chunk = sharded.make_chunk_step(ts.K, gate_frac=ts.GATE)
    with exact_pallas_reciprocal():
        gs = sharded.shard_state(local.init(jnp.asarray(pos), jnp.asarray(vel)))
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, ts.STEPS // ts.K, lambda i, t: chunk(t), s))(gs)
    assert not bool(gs.overflow)
    p_j = np.asarray(local.positions(gs))
    p_t = runs[2]["positions"]
    d = periodic_distance(p_t, p_j, gf.box)
    assert np.all(d <= PARITY_TOL + PARITY_TOL * np.abs(p_j)), float(d.max())


def test_mesh_must_divide_cells():
    gf, _, _ = ts.setup(DIM)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedGridMD3(gf, RowMesh(rank=0, size=3, device=torch.device("cpu")))
