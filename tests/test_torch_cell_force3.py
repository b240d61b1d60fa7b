"""Kernels B4/B5 (3D cell-grid LJ forces) in the PyTorch port against the
JAX package: the plain version against ``cell_pallas3.make_grid_force_kernel3``
in interpret mode (dynamic bound, energy variant, static bound), the static
bound against the dynamic one, the loud pure-static underflow, the dense
oracle in float64 at the seams, and the wrapper's dispatch rules."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_pallas3 import (
    make_grid_force_kernel3 as jax_make_grid_force_kernel3,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid3_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import (
    GRID3_STATE_FIELDS,
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    velocities,
)

N, BOX = 216, 12.0  # rho 0.125: cps 4, cap 16, static_cov "auto" 8


@pytest.fixture(scope="module")
def grids():
    """One grid state in both packages (the JAX side's B4 forces come from
    its ``init``). The lattice is translated by about half a spacing, so
    with the jitter some coordinates lie just outside [0, box) on every
    axis, as unwrapped coordinates do between rebuilds, and the seam pairs
    (edges and corners included) are exercised."""
    pos = lattice_positions(N, BOX, jitter=0.1, seed=3, dim=3) + np.float32([0.95, -0.95, 0.95])
    assert (pos[:, 0] >= BOX).any() and (pos[:, 1] < 0).any() and (pos[:, 2] >= BOX).any()
    gf_j = jax_make_cell_grid_fn(BOX, 2.5, N, dim=3)
    gf_t = make_cell_grid_fn(BOX, 2.5, N, dim=3)
    md_t = GridMD3(gf_t, static_cov="auto", device="cpu")
    with exact_pallas_reciprocal():
        gs_j = JaxGridMD3(gf_j).init(jnp.asarray(pos), jnp.asarray(velocities(N, seed=4, dim=3)))
    gs_t = grid3_state_from_jax(jax_grid_arrays(gs_j, GRID3_STATE_FIELDS), md_t)
    return gf_j, gf_t, md_t, gs_j, gs_t


def test_geometry_matches_jax(grids):
    gf_j, gf_t, md_t, gs_j, gs_t = grids
    assert (gf_t.cells_per_side, gf_t.capacity) == (4, 16)
    for name in ("box", "cutoff", "skin", "n", "dim", "cells_per_side", "capacity"):
        assert getattr(gf_t, name) == getattr(gf_j, name), name
    assert md_t.static_cov == JaxGridMD3(gf_j, static_cov="auto").static_cov == 8
    assert int(gs_t.max_occ) == int(gs_j.max_occ) == int(md_t._counts(gs_t.occ).max())


@pytest.mark.parametrize("with_energy", [False, True])
def test_plain_matches_jax_kernel(grids, with_energy):
    """B4's plain version against JAX's B4: forces on every slot at atol
    1e-4 plus rtol 1e-4 (float32 roundoff of pair terms up to ~10 and of
    the +-box seam offsets; empty slots are exactly 0 on both sides),
    energy and virial sums at rtol 1e-5."""
    gf_j, gf_t, md_t, gs_j, gs_t = grids
    live = gf_t.cells_per_side**2
    p = cell_cuda3.CellForce3Params.from_grid(gf_t)
    out_t = cell_cuda3.grid_force3_reference(gs_t.xg, gs_t.yg, gs_t.zg, p, int(gs_t.max_occ), with_energy)
    if with_energy:
        with exact_pallas_reciprocal():
            kernel = jax_make_grid_force_kernel3(gf_j, interpret=True, with_energy=True)
            out_j = kernel(gs_j.xg, gs_j.yg, gs_j.zg, gs_j.max_occ)
    else:
        out_j = (gs_j.fxg, gs_j.fyg, gs_j.fzg)
    assert len(out_t) == len(out_j) == (5 if with_energy else 3)
    for k in range(3):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k])[:, :, :live], rtol=1e-4, atol=1e-4)
    assert float(torch.stack(out_t[:3]).abs().max()) > 0.1
    empty = gs_t.occ.numpy() < 0.5
    assert np.all(out_t[0].numpy()[empty] == 0.0)
    if with_energy:
        for k in (3, 4):
            np.testing.assert_allclose(
                float(out_t[k].double().sum()), float(np.asarray(out_j[k], np.float64).sum()), rtol=1e-5
            )
        np.testing.assert_allclose(
            float(md_t.potential_energy(gs_t)), 0.5 * float(np.asarray(out_j[3], np.float64).sum()), rtol=1e-5
        )


def test_static_bound_matches_jax_and_dynamic(grids):
    """B5 (bound 8, at least the max occupancy here) against JAX's B5, and
    against B4 at its run-time bound: the same pairs summed over partner
    blocks of another length, so equal to float32 roundoff (atol and rtol
    1e-5)."""
    gf_j, gf_t, md_t, gs_j, gs_t = grids
    cov = md_t.static_cov
    assert int(gs_t.max_occ) <= cov < gf_t.capacity
    live = gf_t.cells_per_side**2
    p = cell_cuda3.CellForce3Params.from_grid(gf_t)
    static = cell_cuda3.grid_force3(gs_t.xg, gs_t.yg, gs_t.zg, p, static_cov=cov)
    dynamic = cell_cuda3.grid_force3(gs_t.xg, gs_t.yg, gs_t.zg, p, max_occ=gs_t.max_occ)
    full = cell_cuda3.grid_force3(gs_t.xg, gs_t.yg, gs_t.zg, p)
    with exact_pallas_reciprocal():
        out_j = jax_make_grid_force_kernel3(gf_j, interpret=True, static_cov=cov)(gs_j.xg, gs_j.yg, gs_j.zg)
    for k in range(3):
        np.testing.assert_allclose(static[k].numpy(), dynamic[k].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(full[k].numpy(), dynamic[k].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(static[k].numpy(), np.asarray(out_j[k])[:, :, :live], rtol=1e-4, atol=1e-4)
    # slots at or past the static bound get zero, as on the TPU
    assert float(torch.stack(static).abs()[:, :, cov:].max()) == 0.0


def test_pure_static_underflow_is_loud():
    """A pure static bound below the max occupancy raises the overflow flag
    at init and at a rebuild (B5 would miss the slots past it); the hybrid
    mode, whose bound (24) the lattice's fullest cells also exceed, runs B4
    instead and flags nothing."""
    n = 1000  # rho 0.58: cps 4, cap 32
    box = 12.0
    gf = make_cell_grid_fn(box, 2.5, n, dim=3)
    # the lattice squeezed to 0.9 of the box: 27 particles in the fullest cells
    pos = torch.from_numpy(lattice_positions(n, box, seed=5, dim=3) * np.float32(0.9))
    vel = torch.from_numpy(velocities(n, seed=6, dim=3))
    md_s = GridMD3(gf, static_cov=8, device="cpu")
    gs = md_s.init(pos, vel)
    assert int(gs.max_occ) > 8
    assert bool(gs.overflow)
    assert bool(md_s._rebuild_migrate(gs.replace(overflow=torch.zeros((), dtype=torch.bool))).overflow)
    md_h = GridMD3(gf, static_cov="auto", device="cpu")
    gs_h = md_h.init(pos, vel)
    assert int(gs_h.max_occ) > md_h.static_cov == 24
    assert not bool(gs_h.overflow)
    assert not bool(md_h._rebuild_migrate(gs_h).overflow)
    # the hybrid's window takes B4 here, and its forces are the dynamic ones
    md_d = GridMD3(gf, device="cpu")
    np.testing.assert_array_equal(gs_h.fxg.numpy(), md_d.init(pos, vel).fxg.numpy())


def test_plain_matches_dense_oracle_float64(grids):
    """The plain version in float64 against the dense float64 oracle on
    every particle, seams, edges and corners included (float64 takes the
    rounding of the +-box seam offsets out of the comparison)."""
    _, gf_t, md_t, _, gs_t = grids
    p = cell_cuda3.CellForce3Params.from_grid(gf_t)
    g64 = [g.double() for g in (gs_t.xg, gs_t.yg, gs_t.zg)]
    f = cell_cuda3.grid_force3_reference(*g64, p)
    f_grid = md_t.particle_order(gs_t, *f)
    pos = md_t.particle_order(gs_t, *g64)
    outside = ((pos < 0) | (pos >= gf_t.box)).sum(1)
    assert int((outside >= 2).sum()) > 0  # particles beyond an edge
    f_dense = LennardJones(box=gf_t.box, cutoff=gf_t.cutoff).force(pos)
    np.testing.assert_allclose(f_grid.numpy(), f_dense.numpy(), atol=1e-9)
    _, _, _, e, _ = cell_cuda3.grid_force3_reference(*g64, p, with_energy=True)
    np.testing.assert_allclose(
        0.5 * float(e.sum()), float(LennardJones(box=gf_t.box, cutoff=gf_t.cutoff).energy(pos)), rtol=1e-12
    )


def test_wrapper_takes_plain_version_on_cpu(grids):
    _, gf_t, _, _, gs_t = grids
    p = cell_cuda3.CellForce3Params.from_grid(gf_t)
    before = (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.STATIC_LAUNCHES)
    args = (gs_t.xg, gs_t.yg, gs_t.zg, p)
    for with_energy in (False, True):
        got = cell_cuda3.grid_force3(*args, max_occ=gs_t.max_occ, with_energy=with_energy)
        want = cell_cuda3.grid_force3_reference(*args, int(gs_t.max_occ), with_energy)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for a, b in zip(cell_cuda3.grid_force3(*args, static_cov=8), cell_cuda3.grid_force3_reference(*args, 8)):
        assert torch.equal(a, b)
    assert (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.STATIC_LAUNCHES) == before


def test_wrapper_rejects_bad_inputs(grids):
    _, gf_t, _, _, gs_t = grids
    p = cell_cuda3.CellForce3Params.from_grid(gf_t)
    x, y, z = gs_t.xg, gs_t.yg, gs_t.zg
    with pytest.raises(TypeError):
        cell_cuda3.grid_force3(x.double(), y.double(), z.double(), p)
    with pytest.raises(ValueError, match="shape"):
        cell_cuda3.grid_force3(x[:, :-1], y[:, :-1], z[:, :-1], p)
    with pytest.raises(ValueError, match="contiguous"):
        cell_cuda3.grid_force3(x.transpose(1, 2), y.transpose(1, 2), z.transpose(1, 2), p)  # cap == plane == 16
    with pytest.raises(ValueError):
        cell_cuda3.grid_force3(x.to("meta"), y.to("meta"), z.to("meta"), p)
    with pytest.raises(TypeError, match="max_occ"):
        cell_cuda3.grid_force3(x, y, z, p, max_occ=gs_t.max_occ.long())
    with pytest.raises(ValueError, match="static_cov"):
        cell_cuda3.grid_force3(x, y, z, p, static_cov=p.cap + 8)
