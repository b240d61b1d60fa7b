"""Kernel B3 (2D cell-grid LJ forces on the lane-packed layout) in the
PyTorch port against the JAX package: the plain version against
``cell_pallas_packed.make_grid_force_kernel_packed`` in interpret mode for
every block count, the packing rule, and the wrapper's dispatch rules."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_pallas_packed import (
    choose_rows_per_block as jax_choose_rows_per_block,
    make_grid_force_kernel_packed as jax_make_grid_force_kernel_packed,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda, cell_cuda_packed
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import (
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    velocities,
)

N, RHO = 1200, 0.5  # box 48.99: cps 16, cap 16


def _geometry():
    box = float(np.sqrt(N / RHO))
    pos = np.mod(lattice_positions(N, box, seed=2), box)
    return box, pos, velocities(N, seed=3)


@pytest.mark.parametrize("rows_per_block", [2, 4, 8, 16])  # G = 8, 4, 2, 1
def test_plain_matches_jax_kernel(rows_per_block):
    """Forces, e and w of every particle (through the pid grid) within
    1e-5 of the largest value of each. That is float32 roundoff: against
    the plain version in float64, the port's float32 forces lie up to
    1.4e-5 off (max |f| 2.5), the JAX kernel's, with its Newton halving,
    up to 1.6e-5; w up to 1.7e-5 and 2.9e-5 (max 12.8)."""
    box, pos, vel = _geometry()
    gf_j = jax_make_cell_grid_fn(box, 2.5, N, dim=2)
    gf_t = make_cell_grid_fn(box, 2.5, N, dim=2)
    assert (gf_t.cells_per_side, gf_t.capacity) == (16, 16)
    md_t = GridMD(gf_t, rows_per_block=rows_per_block, device="cpu")
    assert md_t.grid_shape == (16 // rows_per_block, 16, 16 * rows_per_block)
    with exact_pallas_reciprocal():
        gs_j = JaxGridMD(gf_j, rows_per_block=rows_per_block).init(jnp.asarray(pos), jnp.asarray(vel))
        kernel = jax_make_grid_force_kernel_packed(gf_j, rows_per_block, interpret=True, with_energy=True)
        out_j = kernel(gs_j.xg, gs_j.yg)
    gs_t = grid_state_from_jax(jax_grid_arrays(gs_j), md_t)
    p = cell_cuda.CellForceParams.from_grid(gf_t)
    out_t = cell_cuda_packed.grid_force_packed_reference(gs_t.xg, gs_t.yg, p, rows_per_block, with_energy=True)
    lanes = md_t.lanes
    out_j = [torch.from_numpy(np.ascontiguousarray(np.asarray(o)[:, :, :lanes])) for o in out_j]
    for k in (0, 2):
        got = md_t.particle_order(gs_t, out_t[k], out_t[k + 1]).numpy()
        want = md_t.particle_order(gs_t, out_j[k], out_j[k + 1]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=f"outputs {k}, {k + 1}")
    # the force-only variant (another arrangement of the same pair force)
    fx, fy = cell_cuda_packed.grid_force_packed_reference(gs_t.xg, gs_t.yg, p, rows_per_block)
    for a, b in ((fx, out_t[0]), (fy, out_t[1])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    empty = gs_t.occ < 0.5
    assert bool((out_t[0][empty] == 0).all()) and bool((out_t[2][empty] == 0).all())


def test_plain_matches_unpacked_kernel():
    """On the same particles, the packed plain version gives B1's forces
    bit for bit, slot by slot after unpacking."""
    box, pos, vel = _geometry()
    gf = make_cell_grid_fn(box, 2.5, N, dim=2)
    gs1 = GridMD(gf, rows_per_block=1, device="cpu").init(torch.from_numpy(pos), torch.from_numpy(vel))
    gs4 = GridMD(gf, rows_per_block=4, device="cpu").init(torch.from_numpy(pos), torch.from_numpy(vel))
    for name in ("xg", "yg", "pid", "fxg", "fyg"):
        assert torch.equal(cell_cuda_packed.unpack(getattr(gs4, name), 4), getattr(gs1, name)), name
        assert torch.equal(cell_cuda_packed.pack(getattr(gs1, name), 4), getattr(gs4, name)), name


@pytest.mark.parametrize("cps,want", [(16, None), (24, None), (49, 49), (121, 1), (128, 1), (385, 7)])
def test_choose_rows_per_block_matches_jax(cps, want):
    r = cell_cuda_packed.choose_rows_per_block(cps)
    assert r == jax_choose_rows_per_block(cps)
    assert cps % r == 0
    if want is not None:
        assert r == want


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    box, pos, vel = _geometry()
    gf = make_cell_grid_fn(box, 2.5, N, dim=2)
    gs = GridMD(gf, rows_per_block=4, device="cpu").init(torch.from_numpy(pos), torch.from_numpy(vel))
    p = cell_cuda.CellForceParams.from_grid(gf)
    before = (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, 4, with_energy=with_energy)
        want = cell_cuda_packed.grid_force_packed_reference(gs.xg, gs.yg, p, 4, with_energy=with_energy)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES) == before
    with pytest.raises(ValueError, match="must divide"):
        cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, 3)
    with pytest.raises(ValueError, match="shape"):
        cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, 8)
    with pytest.raises(TypeError):
        cell_cuda_packed.grid_force_packed(gs.xg.double(), gs.yg.double(), gs.counts, p, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cell_cuda_packed.grid_force_packed(gs.xg.transpose(0, 1).contiguous().transpose(0, 1), gs.yg, gs.counts, p, 4)
    with pytest.raises(ValueError):
        cell_cuda_packed.grid_force_packed(gs.xg.to("meta"), gs.yg.to("meta"), gs.counts.to("meta"), p, 4)
