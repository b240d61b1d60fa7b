"""The port's Verlet neighbor list (``ops/kernels/neighbor_list.py``)
against the JAX package's: ``build`` bit for bit (every sort is stable),
the small-box wrap, the overflow flags, the rebuild rule, and forces and
energy on one shared list at rtol 1e-5 (the same float32 pair terms, summed
over K in another order)."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.neighbor_list import (
    make_lj_force_neighbor as jax_make_lj_force_neighbor,
    make_neighbor_fn as jax_make_neighbor_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import neighbor_list_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.neighbor_list import (
    make_lj_force_neighbor,
    make_neighbor_fn,
)
from tests.torch_parity import lattice_positions


def _setup(n, dim, rho=0.8, seed=0, jitter=0.05, **kw):
    box = float((n / rho) ** (1.0 / dim))
    pos = np.mod(lattice_positions(n, box, jitter=jitter, seed=seed, dim=dim), box)
    return box, pos, make_neighbor_fn(box, 2.5, n, dim=dim, **kw), jax_make_neighbor_fn(box, 2.5, n, dim=dim, **kw)


def _jax_arrays(nb) -> dict:
    return {"idx": np.asarray(nb.idx), "ref_position": np.asarray(nb.ref_position),
            "overflow": np.asarray(nb.overflow)}


# (n, dim): a 2D grid of 7 cells per side, 3D with 3, and 2D small boxes
# of 2 and 1 cells per side, where the 3^d offsets repeat modulo the grid
CASES = [(400, 2), (1000, 3), (40, 2), (20, 2)]


@pytest.mark.parametrize("n,dim", CASES)
def test_build_matches_jax_bit_for_bit(n, dim):
    _, pos, nf, nf_j = _setup(n, dim, seed=n)
    assert (nf.cells_per_side, nf.cell_capacity, nf.k_max) == (
        nf_j.cells_per_side, nf_j.cell_capacity, nf_j.k_max)
    nb = nf.build(torch.from_numpy(pos))
    nb_j = nf_j.build(jnp.asarray(pos))
    assert not bool(nb_j.overflow) and not bool(nb.overflow)
    np.testing.assert_array_equal(nb.idx.numpy(), np.asarray(nb_j.idx))
    assert nb.capacity == nb_j.capacity


@pytest.mark.parametrize("n", [40, 20])
def test_small_box_holds_each_pair_once(n):
    """2 or 1 cells per side: each neighbour appears once in a row, and the
    rows are the brute-force sets within cutoff + skin."""
    box, pos, nf, _ = _setup(n, 2, seed=1)
    assert nf.cells_per_side <= 2
    idx = nf.build(torch.from_numpy(pos)).idx.numpy()
    dr = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    dr -= box * np.round(dr / box)
    r2 = (dr**2).sum(-1)
    for i in range(n):
        row = idx[i][idx[i] < n]
        assert len(row) == len(set(row.tolist()))
        want = {j for j in range(n) if j != i and r2[i, j] < (2.5 + 0.4) ** 2}
        assert set(row.tolist()) == want


def test_overflow_is_flagged_as_in_jax():
    for kw in (dict(cell_capacity=2), dict(k_max=8)):
        _, pos, nf, nf_j = _setup(400, 2, seed=2, **kw)
        assert bool(nf.build(torch.from_numpy(pos)).overflow)
        assert bool(nf_j.build(jnp.asarray(pos)).overflow)


def test_rebuild_rule_matches_jax():
    box, pos, nf, nf_j = _setup(400, 2, seed=4)
    x = torch.from_numpy(pos)
    nb = nf.build(x)
    nb_j = nf_j.build(jnp.asarray(pos))
    shift = np.zeros_like(pos)
    for step in (0.1, 0.25):  # below and above skin/2 = 0.2 for one particle
        shift[7, 0] = step
        moved = np.mod(pos + shift, box).astype(np.float32)
        got = bool(nf.needs_rebuild(torch.from_numpy(moved), nb))
        assert got == bool(nf_j.needs_rebuild(jnp.asarray(moved), nb_j)) == (step > 0.2)
        after = nf.maybe_rebuild(torch.from_numpy(moved), nb)
        if got:
            assert after is not nb and torch.equal(after.ref_position, torch.from_numpy(moved))
            after_j = nf_j.maybe_rebuild(jnp.asarray(moved), nb_j)
            np.testing.assert_array_equal(after.idx.numpy(), np.asarray(after_j.idx))
        else:
            assert after is nb
    # an earlier overflow stays raised through a rebuild
    flagged = type(nb)(idx=nb.idx, ref_position=nb.ref_position, overflow=torch.tensor(True))
    assert bool(nf.maybe_rebuild(torch.from_numpy(moved), flagged).overflow)


@pytest.mark.parametrize("n,dim", [(400, 2), (1000, 3)])
def test_forces_and_energy_on_a_shared_list(n, dim):
    box, pos, nf, nf_j = _setup(n, dim, seed=6, jitter=0.1)
    nb_j = nf_j.build(jnp.asarray(pos))
    nb = neighbor_list_from_jax(_jax_arrays(nb_j), device="cpu")
    assert nb.idx.dtype == torch.int64 and not bool(nb.overflow)
    force_j = jax_make_lj_force_neighbor(nf_j)
    force_t = make_lj_force_neighbor(nf)
    x = torch.from_numpy(pos)
    f_t = force_t(x, nb)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(force_j(jnp.asarray(pos), nb_j)), rtol=1e-5, atol=1e-4)
    e_t = float(force_t.energy(x, nb))
    np.testing.assert_allclose(e_t, float(force_j.energy(jnp.asarray(pos), nb_j)), rtol=1e-5)
    # the same physics as the dense oracle with the cutoff
    lj = LennardJones(box=box, cutoff=2.5)
    np.testing.assert_allclose(f_t.numpy(), lj.force(x).numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(e_t, float(lj.energy(x)), rtol=1e-5)
