"""The 3D rebuild halo kernel of the PyTorch port, B6 halo
(``migrate_cuda3.migrate3_halo``): its plain version over P x-row blocks
against the port's whole-grid B6, mover flag included, and against the
JAX package's sharded rebuild (``ShardedGridMD3._rebuild_migrate``: B6's
``.raw`` on compact mover planes, in interpret mode) on 2 devices of the
conftest's virtual mesh, at k_mov 8 as ``lj_fluid`` builds it.

Setup: the JAX package's 3D sharded test configuration (``tests/
torch_sharded.setup``), every particle moved by (+0.3, -0.2, +0.1) cells so
that a rebuild has movers across every row boundary. The port's inputs are
JAX's state (``interop``). The rebuild only moves values: exact, compared
in particle order. JAX's compiled B6 halo takes ~40 s of this file."""

import pytest

pytest.importorskip("jax")

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
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid3_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3
from tests import torch_sharded as ts
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks
from tests.torch_halo import by_pid
from tests.torch_parity import GRID3_STATE_FIELDS, exact_pallas_reciprocal, jax_grid_arrays

K_MOV = 8
MOVED = ("xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg")


@pytest.fixture(scope="module")
def state():
    gf, pos, vel = ts.setup(3)
    jgf = jax_make_cell_grid_fn(gf.box, ts.CUTOFF, gf.n, dim=3, skin=ts.SKIN, rho=gf.n / gf.box**3)
    with exact_pallas_reciprocal():
        gs = JaxGridMD3(jgf, dt=ts.DT).init(jnp.asarray(pos), jnp.asarray(vel))
    cell = gf.box / gf.cells_per_side
    gs = gs.replace(xg=gs.xg + 0.3 * cell, yg=gs.yg - 0.2 * cell, zg=gs.zg + 0.1 * cell)
    md = ts.engine(3, sharded=False)
    s = grid3_state_from_jax(jax_grid_arrays(gs, GRID3_STATE_FIELDS), md)
    xw, yw, zw, scode, occ, overflow, _ = md._migration_dest(s)
    assert not bool(overflow)
    fields = torch.stack([xw, yw, zw, s.vxg, s.vyg, s.vzg, s.fxg, s.fyg, s.fzg, s.pid.to(torch.float32)])
    fills = [md.sentinel] + [0.0] * 8 + [-1.0]
    return jgf, gs, md, scode, occ, fields, fills


def _halo_migrate(scode, occ, fields, fills, p, k_mov=K_MOV):
    parts = [migrate_cuda3.migrate3_halo(c, f, fills, k_mov=k_mov, occ=o)
             for c, f, o in zip(halo_blocks(scode, p), halo_blocks(fields, p, dim=1), occ.chunk(p))]
    return torch.cat([q[0] for q in parts], dim=1), [bool(q[1]) for q in parts]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_b6_halo_over_blocks_equals_b6(state, p):
    """The same permutation, and the mover flag raised over the blocks
    exactly where the whole-grid flag is, at each k_mov."""
    *_, md, scode, occ, fields, fills = state
    full, _ = migrate_cuda3.migrate3(scode, fields, fills, k_mov=K_MOV, occ=occ)
    out, _ = _halo_migrate(scode, occ, fields, fills, p)
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    assert int((out[9] >= 0).sum()) == md.n
    flags = []
    for k_mov in (1, 2, 4, 8, md.cap):
        flags.append(bool(migrate_cuda3.migrate3(scode, fields, fills, k_mov=k_mov, occ=occ)[1]))
        assert any(_halo_migrate(scode, occ, fields, fills, p, k_mov)[1]) is flags[-1], k_mov
    assert flags[0] and not flags[-1]


def test_b6_halo_matches_jax_sharded_rebuild(state):
    jgf, gs, md, scode, occ, fields, fills = state
    sharded = JaxShardedGridMD3(jgf, jax_make_mesh(2, axis_name="x"), dt=ts.DT, migrate_k_mov=K_MOV)
    out_j = sharded._rebuild_migrate(sharded.shard_state(gs))
    assert not bool(out_j.overflow)
    out_t, flags = _halo_migrate(scode, occ, fields, fills, 2)
    assert not any(flags)
    out_t = out_t.numpy()
    live = md.plane
    grids_j = [np.asarray(getattr(out_j, k))[:, :, :live] for k in MOVED]
    np.testing.assert_array_equal(
        by_pid(out_t[9].astype(np.int32), md.n, *out_t[:9]),
        by_pid(np.asarray(out_j.pid)[:, :, :live], md.n, *grids_j),
    )
