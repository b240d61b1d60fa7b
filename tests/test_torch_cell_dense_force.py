"""The port's cell-dense force path (``ops/kernels/cell_dense.py``:
``CellGridFn.build`` / ``needs_rebuild`` / ``maybe_rebuild`` and
``make_lj_force_cell_dense``) against the JAX package's, in 2D and 3D:
``slot`` and ``occupancy`` bit for bit (stable sorts), the overflow flag,
the rebuild rule, and forces and energy on one shared assignment at rtol
1e-5 (the same float32 pair terms, summed in another order)."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
    make_lj_force_cell_dense as jax_make_lj_force_cell_dense,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import cell_assignment_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import (
    make_cell_grid_fn,
    make_lj_force_cell_dense,
)
from tests.torch_parity import lattice_positions

# (n, dim, rho): 2D with 7 cells per side, 3D with 3
CASES = [(256, 2, 0.6), (729, 3, 0.8)]


def _setup(n, dim, rho, seed=0, jitter=0.1, **kw):
    box = float((n / rho) ** (1.0 / dim))
    pos = np.mod(lattice_positions(n, box, jitter=jitter, seed=seed, dim=dim), box)
    return box, pos, make_cell_grid_fn(box, 2.5, n, dim=dim, **kw), jax_make_cell_grid_fn(box, 2.5, n, dim=dim, **kw)


def _jax_arrays(a) -> dict:
    return {name: np.asarray(getattr(a, name)) for name in ("slot", "occupancy", "ref_position", "overflow")}


@pytest.mark.parametrize("n,dim,rho", CASES)
def test_build_matches_jax_bit_for_bit(n, dim, rho):
    _, pos, gf, gf_j = _setup(n, dim, rho, seed=n)
    assert (gf.cells_per_side, gf.capacity) == (gf_j.cells_per_side, gf_j.capacity)
    a = gf.build(torch.from_numpy(pos))
    a_j = gf_j.build(jnp.asarray(pos))
    assert not bool(a.overflow) and not bool(a_j.overflow)
    np.testing.assert_array_equal(a.slot.numpy(), np.asarray(a_j.slot))
    np.testing.assert_array_equal(a.occupancy.numpy(), np.asarray(a_j.occupancy))
    assert tuple(a.occupancy.shape) == (gf.cells_per_side,) * dim + (gf.capacity,)


@pytest.mark.parametrize("n,dim,rho", CASES)
def test_overflow_and_rebuild_rule_match_jax(n, dim, rho):
    box, pos, gf, gf_j = _setup(n, dim, rho, seed=1, capacity=1)
    assert bool(gf.build(torch.from_numpy(pos)).overflow) and bool(gf_j.build(jnp.asarray(pos)).overflow)
    box, pos, gf, gf_j = _setup(n, dim, rho, seed=2)
    a = gf.build(torch.from_numpy(pos))
    a_j = gf_j.build(jnp.asarray(pos))
    shift = np.zeros_like(pos)
    for step in (0.1, 0.25):  # below and above skin/2 = 0.2 for one particle
        shift[3, -1] = step
        moved = np.mod(pos + shift, box).astype(np.float32)
        got = bool(gf.needs_rebuild(torch.from_numpy(moved), a))
        assert got == bool(gf_j.needs_rebuild(jnp.asarray(moved), a_j)) == (step > 0.2)
        after = gf.maybe_rebuild(torch.from_numpy(moved), a)
        if got:
            after_j = gf_j.maybe_rebuild(jnp.asarray(moved), a_j)
            np.testing.assert_array_equal(after.slot.numpy(), np.asarray(after_j.slot))
            assert torch.equal(after.ref_position, torch.from_numpy(moved))
        else:
            assert after is a


@pytest.mark.parametrize("n,dim,rho", CASES)
def test_forces_and_energy_on_a_shared_assignment(n, dim, rho):
    box, pos, gf, gf_j = _setup(n, dim, rho, seed=3)
    a_j = gf_j.build(jnp.asarray(pos))
    a = cell_assignment_from_jax(_jax_arrays(a_j), device="cpu")
    force_j = jax_make_lj_force_cell_dense(gf_j)
    force_t = make_lj_force_cell_dense(gf)
    x = torch.from_numpy(pos)
    f_t = force_t(x, a)
    f_j = np.asarray(force_j(jnp.asarray(pos), a_j))
    assert np.abs(f_j).max() > 10.0
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-5, atol=1e-4)
    e_t = float(force_t.energy(x, a))
    np.testing.assert_allclose(e_t, float(force_j.energy(jnp.asarray(pos), a_j)), rtol=1e-5)
    lj = LennardJones(box=box, cutoff=2.5)
    np.testing.assert_allclose(f_t.numpy(), lj.force(x).numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(e_t, float(lj.energy(x)), rtol=1e-5)
