"""Kernel B1 (2D cell-grid LJ forces) in the PyTorch port against the JAX
package: the plain version against ``cell_pallas.make_grid_force_kernel``
in interpret mode, the wrapper's dispatch rules, and the dense oracle."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.lennard_jones import (
    LennardJones as JaxLennardJones,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_pallas import (
    make_grid_force_kernel as jax_make_grid_force_kernel,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import (
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    velocities,
)

N, RHO = 512, 0.8  # cps 8, cap 24


@pytest.fixture(scope="module")
def grids():
    """One grid state in both packages. The lattice is translated by about
    half a spacing, so with the jitter some coordinates lie just outside
    [0, box), as unwrapped coordinates do between rebuilds, and the seam
    pairs are exercised."""
    box = float(np.sqrt(N / RHO))
    pos, vel = lattice_positions(N, box, seed=3), velocities(N, seed=4)
    pos = pos + np.float32([0.55, -0.55])
    assert (pos[:, 0] >= box).any() and (pos[:, 1] < 0).any()
    gf_j = jax_make_cell_grid_fn(box, 2.5, N, dim=2)
    gf_t = make_cell_grid_fn(box, 2.5, N, dim=2)
    md_t = GridMD(gf_t, rows_per_block=1, device="cpu")
    with exact_pallas_reciprocal():
        gs_j = JaxGridMD(gf_j, rows_per_block=1).init(jnp.asarray(pos), jnp.asarray(vel))
    gs_t = grid_state_from_jax(jax_grid_arrays(gs_j), md_t)
    return gf_j, gf_t, md_t, gs_j, gs_t, pos


def test_geometry_matches_jax(grids):
    gf_j, gf_t, *_ = grids
    assert (gf_t.cells_per_side, gf_t.capacity) == (8, 24)
    for name in ("box", "cutoff", "skin", "n", "dim", "cells_per_side", "capacity"):
        assert getattr(gf_t, name) == getattr(gf_j, name), name


@pytest.mark.parametrize("with_energy", [False, True])
def test_plain_matches_jax_kernel(grids, with_energy):
    """Forces on every slot at atol 1e-4 plus rtol 1e-4 (empty slots are
    exactly 0 on both sides); energy and virial sums at rtol 1e-5.

    The rtol is float32 roundoff, not a difference of method: pair terms
    reach ~100 and the seam offsets +-box are rounded, and at the largest
    force here (|f| = 12.8) both packages lie 4.3e-4 from the float64
    value of the same sum."""
    gf_j, gf_t, md_t, gs_j, gs_t, _ = grids
    cps = gf_t.cells_per_side
    with exact_pallas_reciprocal():
        kernel = jax_make_grid_force_kernel(gf_j, interpret=True, with_energy=with_energy)
        out_j = kernel(gs_j.xg, gs_j.yg)
    p = cell_cuda.CellForceParams.from_grid(gf_t)
    out_t = cell_cuda.grid_force_reference(gs_t.xg, gs_t.yg, p, with_energy=with_energy)
    assert len(out_t) == len(out_j) == (4 if with_energy else 2)
    for k in range(2):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k])[:, :, :cps], rtol=1e-4, atol=1e-4)
    empty = gs_t.occ.numpy() < 0.5
    assert np.all(out_t[0].numpy()[empty] == 0.0)
    if with_energy:
        for k in (2, 3):
            np.testing.assert_allclose(
                float(out_t[k].double().sum()), float(np.asarray(out_j[k], np.float64).sum()), rtol=1e-5
            )
        np.testing.assert_allclose(
            float(md_t.potential_energy(gs_t)),
            0.5 * float(np.asarray(out_j[2], np.float64).sum()),
            rtol=1e-5,
        )


def test_plain_matches_dense_oracle_float64(grids):
    """The plain version in float64 against the dense float64 oracle on
    every particle, seams included (float64 takes the rounding of the
    +-box seam offsets out of the comparison)."""
    _, gf_t, md_t, _, gs_t, _ = grids
    p = cell_cuda.CellForceParams.from_grid(gf_t)
    fx, fy = cell_cuda.grid_force_reference(gs_t.xg.double(), gs_t.yg.double(), p)
    f_grid = md_t.particle_order(gs_t, fx, fy)
    pos = md_t.particle_order(gs_t, gs_t.xg.double(), gs_t.yg.double())
    f_dense = LennardJones(box=gf_t.box, cutoff=gf_t.cutoff).force(pos)
    np.testing.assert_allclose(f_grid.numpy(), f_dense.numpy(), atol=1e-4)


def test_dense_oracle_matches_jax():
    n = 256
    box = float(np.sqrt(n / 0.8))
    pos = np.mod(lattice_positions(n, box, seed=5), box)
    for cutoff in (None, 2.5):
        lj_t = LennardJones(box=box, cutoff=cutoff)
        lj_j = JaxLennardJones(box=box, cutoff=cutoff)
        np.testing.assert_allclose(
            lj_t.force(torch.from_numpy(pos)).numpy(), np.asarray(lj_j.force(jnp.asarray(pos))), atol=1e-4
        )
        np.testing.assert_allclose(
            float(lj_t.energy(torch.from_numpy(pos))), float(lj_j.energy(jnp.asarray(pos))), rtol=1e-5
        )
        rows = torch.tensor([0, 17, 255])
        np.testing.assert_allclose(
            lj_t.force(torch.from_numpy(pos), rows).numpy(),
            lj_t.force(torch.from_numpy(pos)).numpy()[rows.numpy()],
            atol=1e-6,
        )


def test_wrapper_takes_plain_version_on_cpu(grids):
    _, gf_t, _, _, gs_t, _ = grids
    p = cell_cuda.CellForceParams.from_grid(gf_t)
    before = (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = cell_cuda.grid_force(gs_t.xg, gs_t.yg, p, with_energy=with_energy)
        want = cell_cuda.grid_force_reference(gs_t.xg, gs_t.yg, p, with_energy=with_energy)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES) == before


def test_wrapper_rejects_bad_inputs(grids):
    _, gf_t, _, _, gs_t, _ = grids
    p = cell_cuda.CellForceParams.from_grid(gf_t)
    x, y = gs_t.xg, gs_t.yg
    with pytest.raises(TypeError):
        cell_cuda.grid_force(x.double(), y.double(), p)
    with pytest.raises(ValueError, match="shape"):
        cell_cuda.grid_force(x[:, :-1], y[:, :-1], p)
    with pytest.raises(ValueError, match="contiguous"):
        cell_cuda.grid_force(x.transpose(0, 2), y.transpose(0, 2), p)
    with pytest.raises(ValueError):
        cell_cuda.grid_force(x.to("meta"), y.to("meta"), p)
