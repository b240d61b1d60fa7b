"""The 3D force halo kernels of the PyTorch port, B4 halo and B5 halo
(``cell_cuda3.grid_force3_halo``): their plain versions over P x-row
blocks against the port's whole-grid plain versions, and B4 halo against
the JAX package's ``ShardedGridMD3.force_once`` (its ``.raw`` halo kernel
in interpret mode) on the conftest's virtual 8-device mesh. The rebuild's
B6 halo is ``test_torch_halo_migrate3``'s.

Setup: the JAX package's 3D sharded test configuration (``tests/
torch_sharded.setup``): N = 2000, 8 cells per side, capacity 16. The
port's inputs are JAX's initial grid state (``interop``).

Tolerances: over P blocks bit-equal; against JAX rtol and atol 1e-4, as
for B4 against JAX's B4 (``test_torch_cell_force3``): JAX halves each pair
by Newton's law and adds the neighbour device's reaction rows."""

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
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3
from tests import torch_sharded as ts
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks
from tests.torch_parity import GRID3_STATE_FIELDS, exact_pallas_reciprocal, jax_grid_arrays


@pytest.fixture(scope="module")
def state():
    gf, pos, vel = ts.setup(3)
    jgf = jax_make_cell_grid_fn(gf.box, ts.CUTOFF, gf.n, dim=3, skin=ts.SKIN, rho=gf.n / gf.box**3)
    with exact_pallas_reciprocal():
        gs = JaxGridMD3(jgf, dt=ts.DT).init(jnp.asarray(pos), jnp.asarray(vel))
    md = ts.engine(3, sharded=False)
    return jgf, gs, md, grid3_state_from_jax(jax_grid_arrays(gs, GRID3_STATE_FIELDS), md)


def _halo_forces(s, md, p, **kw):
    params = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    blocks = zip(halo_blocks(s.xg, p, md.box), halo_blocks(s.yg, p), halo_blocks(s.zg, p))
    parts = [cell_cuda3.grid_force3_halo(xh, yh, zh, params, **kw) for xh, yh, zh in blocks]
    return [torch.cat([q[k] for q in parts]) for k in range(len(parts[0]))]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_b4_b5_halo_over_blocks_equal_full(state, p):
    """B4 (bound ``max_occ``) with and without energy, and B5 at cov 8."""
    _, _, md, s = state
    params = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    assert 0 < int(s.max_occ) <= md.cap
    for kw in (dict(max_occ=s.max_occ), dict(max_occ=s.max_occ, with_energy=True), dict(static_cov=8)):
        full = cell_cuda3.grid_force3(s.xg, s.yg, s.zg, params, **kw)
        for a, b in zip(_halo_forces(s, md, p, **kw), full):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_b4_halo_matches_jax_sharded_force(state, p):
    jgf, gs, md, s = state
    sharded = JaxShardedGridMD3(jgf, jax_make_mesh(p, axis_name="x"), dt=ts.DT)
    with exact_pallas_reciprocal():
        f_j = [np.asarray(f)[:, :, : md.plane] for f in sharded.force_once(sharded.shard_state(gs))]
    occ = s.occ.numpy() > 0.5
    for a, b in zip(_halo_forces(s, md, p, max_occ=s.max_occ), f_j):
        np.testing.assert_allclose(a.numpy()[occ], b[occ], rtol=1e-4, atol=1e-4)
