"""The 2D halo kernels of the PyTorch port, B1 halo
(``cell_cuda.grid_force_halo``) and B2 halo (``migrate_cuda.migrate_halo``):
their plain versions over P row blocks against the port's whole-grid plain
versions, and against the JAX package's ``ShardedGridMD`` (its ``.raw``
halo kernels in interpret mode) on the conftest's virtual 8-device mesh.

Setup: the JAX package's sharded test configuration (``tests/
torch_sharded.setup``): N = 1600, 16 cells per side. The port's inputs are
JAX's initial grid state, carried over by ``interop.grid_state_from_jax``,
so both packages start from the same float32 values.

Tolerances: over P blocks the halo versions are bit-equal to the whole-grid
ones (the caller's fl(x + box) is the kernel's). Against JAX's sharded
force the rtol and atol are 1e-4, as for B1 against JAX's B1
(``test_torch_cell_force``): JAX halves each pair by Newton's law and adds
the reaction rows from the neighbouring device, so it sums in another
order. The rebuild only moves values: exact, compared in particle order."""

import pytest

pytest.importorskip("jax")

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
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid_state_from_jax, sharded_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda, migrate_cuda
from tests import torch_sharded as ts
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks
from tests.torch_halo import by_pid
from tests.torch_parity import exact_pallas_reciprocal, jax_grid_arrays

FILLS_NAMES = ("xw", "yw", "vxg", "vyg", "fxg", "fyg", "pid")


@pytest.fixture(scope="module")
def state():
    """JAX's local engine and initial state, the port's engine and the same
    state carried over, and both states with every particle moved by
    (+0.3, -0.2) cells, so that a rebuild has movers across every row
    boundary."""
    gf, pos, vel = ts.setup(2)
    jgf = jax_make_cell_grid_fn(gf.box, ts.CUTOFF, gf.n, dim=2, skin=ts.SKIN, rho=gf.n / gf.box**2)
    local = JaxGridMD(jgf, dt=ts.DT, rows_per_block=1)
    with exact_pallas_reciprocal():
        gs = local.init(jnp.asarray(pos), jnp.asarray(vel))
    md = ts.engine(2, sharded=False)
    s = grid_state_from_jax(jax_grid_arrays(gs), md)
    cell = gf.box / gf.cells_per_side
    gs_moved = gs.replace(xg=gs.xg + 0.3 * cell, yg=gs.yg - 0.2 * cell)
    s_moved = s.replace(xg=s.xg + 0.3 * cell, yg=s.yg - 0.2 * cell)
    return jgf, local, gs, md, s, gs_moved, s_moved


def _port_migration(md, s):
    """The port's allocation on the whole grid: the code grid and the
    stacked fields of a rebuild, their fills and the allocation's
    occupancy."""
    xw, yw, scode, occ, _, _ = md._migration_dest(s)
    fields = torch.stack([xw, yw, s.vxg, s.vyg, s.fxg, s.fyg, s.pid.to(torch.float32)])
    return scode, fields, [md.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0], occ


@pytest.mark.parametrize("p", [1, 2, 4])
def test_b1_halo_over_blocks_equals_b1(state, p):
    _, _, _, md, s, _, _ = state
    params = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    for with_energy in (False, True):
        full = cell_cuda.grid_force_reference(s.xg, s.yg, params, with_energy)
        parts = [
            cell_cuda.grid_force_halo(xh, yh, params, with_energy)
            for xh, yh in zip(halo_blocks(s.xg, p, md.box), halo_blocks(s.yg, p))
        ]
        for k, f in enumerate(full):
            np.testing.assert_array_equal(torch.cat([q[k] for q in parts]).numpy(), f.numpy())


@pytest.mark.parametrize("p", [1, 2, 4])
def test_b2_halo_over_blocks_equals_b2(state, p):
    *_, md, _, _, s_moved = state
    scode, fields, fills, occ = _port_migration(md, s_moved)
    full = migrate_cuda.migrate_reference(scode, fields, fills)
    parts = [
        migrate_cuda.migrate_halo(c, f, fills, occ=o)
        for c, f, o in zip(halo_blocks(scode, p), halo_blocks(fields, p, dim=1), occ.chunk(p))
    ]
    out = torch.cat(parts, dim=1)
    assert out.shape == full.shape
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    assert int((out[6] >= 0).sum()) == md.n  # no particle lost or doubled


@pytest.mark.parametrize("p", [2, 4])
def test_b1_halo_matches_jax_sharded_force(state, p):
    jgf, local, gs, md, s, _, _ = state
    sharded = JaxShardedGridMD(jgf, jax_make_mesh(p, axis_name="x"), dt=ts.DT)
    with exact_pallas_reciprocal():
        f_j = [np.asarray(f)[:, :, : md.cps] for f in sharded.force_once(sharded.shard_state(gs))]
    params = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    parts = [cell_cuda.grid_force_halo(xh, yh, params)
             for xh, yh in zip(halo_blocks(s.xg, p, md.box), halo_blocks(s.yg, p))]
    occ = s.occ.numpy() > 0.5
    for k in range(2):
        f_t = torch.cat([q[k] for q in parts]).numpy()
        np.testing.assert_allclose(f_t[occ], f_j[k][occ], rtol=1e-4, atol=1e-4)


def test_b2_halo_matches_jax_sharded_rebuild(state):
    """JAX's sharded rebuild (B2's ``.raw`` on 2 virtual devices) against
    the port's allocation and B2 halo over 2 blocks, field by field in
    particle order."""
    jgf, local, _, md, _, gs_moved, s_moved = state
    sharded = JaxShardedGridMD(jgf, jax_make_mesh(2, axis_name="x"), dt=ts.DT)
    out_j = sharded._rebuild_migrate(sharded.shard_state(gs_moved))
    assert not bool(out_j.overflow)
    scode, fields, fills, occ = _port_migration(md, s_moved)
    out_t = torch.cat([migrate_cuda.migrate_halo(c, f, fills, occ=o)
                       for c, f, o in zip(halo_blocks(scode, 2), halo_blocks(fields, 2, dim=1), occ.chunk(2))],
                      dim=1).numpy()
    cps = md.cps
    grids_j = [np.asarray(getattr(out_j, k))[:, :, :cps] for k in ("xg", "yg", "vxg", "vyg", "fxg", "fyg")]
    np.testing.assert_array_equal(
        by_pid(out_t[6].astype(np.int32), md.n, *out_t[:6]),
        by_pid(np.asarray(out_j.pid)[:, :, :cps], md.n, *grids_j),
    )
    np.testing.assert_array_equal((out_t[6] >= 0), np.asarray(out_j.occ)[:, :, :cps] > 0.5)


@pytest.mark.parametrize("rank", [0, 3])
def test_sharded_state_from_jax_takes_the_rank_rows(state, rank):
    """``interop.sharded_state_from_jax``: rank ``rank`` of 4 gets rows
    4 rank .. 4 rank + 3 of JAX's whole-grid state, scalars unchanged."""
    _, _, gs, md, s, _, _ = state
    sharded = ShardedGridMD(md.grid_fn, RowMesh(rank=rank, size=4, device=torch.device("cpu")), dt=ts.DT)
    local = sharded_state_from_jax(jax_grid_arrays(gs), sharded)
    rows = slice(4 * rank, 4 * rank + 4)
    for name in ("xg", "yg", "vxg", "fxg", "occ", "pid", "dispx"):
        assert torch.equal(getattr(local, name), getattr(s, name)[rows]), name
    assert float(local.time) == float(s.time) and bool(local.overflow) is bool(s.overflow)
