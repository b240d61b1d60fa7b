"""Kernel B8's plain PyTorch version (``pairwise_cuda``) against the JAX
package's ``make_lj_force_pallas`` / ``make_lj_energy_pallas``, which run
their Pallas kernel in interpret mode here (their default off a TPU). The
JAX kernel uses plain division, so no reciprocal lowering is patched.

Tolerance: rtol 1e-5, atol 1e-4 at forces up to ~100: the same float32
pair terms, summed in another order."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.pairwise_pallas import (
    make_lj_energy_pallas,
    make_lj_force_pallas,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.pairwise_cuda import (
    PairwiseParams,
    lj_force_pairwise,
    lj_force_pairwise_reference,
    make_lj_energy_pairwise,
    make_lj_force_pairwise,
)
from tests.torch_parity import lattice_positions

RTOL, ATOL = 1e-5, 1e-4


def _positions(n: int, dim: int, rho: float = 0.8, jitter: float = 0.08, seed: int = 0):
    box = float((n / rho) ** (1.0 / dim))
    return np.mod(lattice_positions(n, box, jitter=jitter, seed=seed, dim=dim), box), box


# (n, dim, periodic, cutoff): 2D PBC with a ragged last tile (100 and 300
# are not multiples of the 256-particle tile), 3D without a box, a cutoff
CASES = [(100, 2, True, None), (300, 2, True, None), (216, 3, False, None), (300, 2, True, 2.5)]


@pytest.mark.parametrize("n,dim,periodic,cutoff", CASES)
def test_forces_and_energy_match_jax(n, dim, periodic, cutoff):
    pos, box = _positions(n, dim)
    box_arg = box if periodic else None
    fe_j = make_lj_force_pallas(n, box=box_arg, cutoff=cutoff, with_energy=True)
    f_j, e_j = (np.asarray(a) for a in fe_j(jnp.asarray(pos)))
    f_only_j = np.asarray(make_lj_force_pallas(n, box=box_arg, cutoff=cutoff)(jnp.asarray(pos)))

    x = torch.from_numpy(pos)
    f_t = make_lj_force_pairwise(n, box=box_arg, cutoff=cutoff)(x)
    f2_t, e_t = make_lj_force_pairwise(n, box=box_arg, cutoff=cutoff, with_energy=True)(x)
    assert f_t.shape == (n, dim) and f_t.dtype == torch.float32
    assert np.abs(f_j).max() > 10.0  # the forces are not trivially small
    np.testing.assert_allclose(f_t.numpy(), f_only_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f2_t.numpy(), f_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)


def test_energy_gradient_is_minus_force_and_matches_jax_grad():
    n, dim = 300, 2
    pos, box = _positions(n, dim, seed=3)
    energy_t = make_lj_energy_pairwise(n, box=box)
    x = torch.from_numpy(pos).requires_grad_(True)
    e = energy_t(x)
    (g_t,) = torch.autograd.grad(e, x)
    f_t = make_lj_force_pairwise(n, box=box)(x.detach())
    assert torch.equal(g_t, -f_t)  # the backward returns -grad * force exactly (grad = 1)
    e_j, g_j = jax.value_and_grad(make_lj_energy_pallas(n, box=box))(jnp.asarray(pos))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(e.detach()), float(e_j), rtol=RTOL)
    # a scaled upstream gradient scales the force
    (g2,) = torch.autograd.grad(3.0 * energy_t(x), x)
    np.testing.assert_allclose(g2.numpy(), 3.0 * g_t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dim,periodic,cutoff", [(2, True, None), (3, True, 2.5), (3, False, None)])
def test_reference_float64_matches_lennard_jones(dim, periodic, cutoff):
    """In float64 the plain version and the dense oracle agree to 1e-9: the
    minimum image forms (dx * (1/box) against dr / box) differ only at
    roundoff."""
    n = 150
    pos, box = _positions(n, dim, seed=5)
    x = torch.from_numpy(pos).double()
    box_arg = box if periodic else None
    f, e = lj_force_pairwise_reference(x, PairwiseParams(box=box_arg, cutoff=cutoff), with_energy=True)
    lj = LennardJones(box=box_arg, cutoff=cutoff)
    f_ref, e_ref = lj.force_and_energy(x)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(e.numpy(), lj.energy_per_particle(x).numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(0.5 * float(e.sum()), float(e_ref), rtol=1e-9)
    np.testing.assert_allclose(f_ref.numpy(), lj.force(x).numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(e_ref), float(lj.energy(x)), rtol=1e-12)


def test_reference_chunks_rows(monkeypatch):
    """The plain version's row chunks (at most 2^27 pairs each) change no
    number: with a chunk of 64 rows the result is bit-equal."""
    pos, box = _positions(300, 2, seed=7)
    x = torch.from_numpy(pos)
    p = PairwiseParams(box=box, cutoff=2.5)
    whole = lj_force_pairwise_reference(x, p, with_energy=True)
    monkeypatch.setattr(pairwise_cuda, "_REFERENCE_PAIRS", 64 * 300)
    chunked = lj_force_pairwise_reference(x, p, with_energy=True)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_slices_cover_every_tile():
    for n in (1, 100, 256, 257, 2048, 4096, 5000, 16384, 100_000):
        s, length = pairwise_cuda._slices(n)
        assert length % pairwise_cuda.THREADS == 0 and 1 <= s <= pairwise_cuda.MAX_SLICES
        assert (s - 1) * length < n <= s * length  # no empty slice, all of j covered
    assert pairwise_cuda._slices(16384) == (16, 1024)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096, 16384])
def test_lj_geometry_covers_every_i_once_and_every_tile_once(n):
    """B8's launch: the row blocks' threads (four i-particles each, a
    thread's rows LJ_THREADS apart) hold every i below N exactly once, and
    the slices (none empty, at most LJ_MAX_SLICES) hold every j tile of
    LJ_TILE exactly once, in order: each (i, j) pair is one block's."""
    rows, slices, length = pairwise_cuda._lj_geometry(n)
    threads, per_block, tile = pairwise_cuda.LJ_THREADS, pairwise_cuda.LJ_ROWS, pairwise_cuda.LJ_TILE
    assert per_block == 4 * threads
    i = (np.arange(rows)[:, None, None] * per_block + np.arange(4)[None, :, None] * threads
         + np.arange(threads)[None, None, :]).ravel()
    i = i[i < n]
    assert i.size == n and np.array_equal(np.sort(i), np.arange(n))
    assert length % tile == 0 and 1 <= slices <= pairwise_cuda.LJ_MAX_SLICES
    assert all(s * length < n for s in range(slices))  # no empty slice
    tiles = [j0 for s in range(slices) for j0 in range(s * length, min((s + 1) * length, n), tile)]
    assert tiles == list(range(0, n, tile))
    if n == 16384:
        assert (rows, slices, length) == (32, 32, 512)  # 1024 blocks of 128 threads


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    x = torch.zeros((10, 2))
    p = PairwiseParams()
    before = (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES)
    with pytest.raises(TypeError):
        lj_force_pairwise(x.double(), p)
    with pytest.raises(ValueError, match="shape"):
        lj_force_pairwise(torch.zeros((10, 4)), p)
    with pytest.raises(ValueError, match="contiguous"):
        lj_force_pairwise(torch.zeros((2, 10)).t(), p)
    with pytest.raises(ValueError, match="N=10"):
        make_lj_force_pairwise(10)(torch.zeros((11, 2)))
    lj_force_pairwise(torch.rand((10, 2)) * 5, p, with_energy=True)
    assert (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES) == before
