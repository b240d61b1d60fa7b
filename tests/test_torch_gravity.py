"""The port's ``Gravity`` and kernel B9's plain version (``pairwise_cuda``)
against the JAX package: ``ops/forces/gravity.py`` in all three modes, and
``make_gravity_accel_pallas``, whose Pallas kernel runs in interpret mode
here (its default off a TPU), as ``tests/test_pallas_kernels.py`` runs it.

Tolerances: the same float32 formulas, op for op, summed in another order
(and ``rsqrt`` / ``pow(r2, -1.5)`` evaluated by two libraries): rtol 1e-5
with an atol of 1e-6 x max |a|. In float64 the plain version and the dense
formula differ only at roundoff (1e-12)."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.gravity import Gravity as JaxGravity
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.pairwise_pallas import make_gravity_accel_pallas
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.gravity import Gravity
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.pairwise_cuda import (
    gravity_accel_pairwise,
    gravity_accel_pairwise_reference,
    make_gravity_accel_pairwise,
)

RTOL = 1e-5


def _bodies(n: int, dim: int, seed: int, scale: float = 10.0, duplicate: bool = False):
    """``(positions, masses)`` as float32 numpy: normal * scale, 0.5 + U(0,1);
    with ``duplicate`` body 1 sits on body 0 (r = 0 off the diagonal)."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    if duplicate:
        pos[1] = pos[0]
    return pos, (0.5 + rng.random(n)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["min_distance", "r2_floor", "plummer"])
def test_gravity_matches_jax(mode, dim):
    """acceleration, force and energy in every mode, with two coincident
    bodies (each mode's regularization of r = 0)."""
    pos, m = _bodies(40, dim, seed=dim, duplicate=True)
    kw = dict(g=1.5, mode=mode, softening=0.1)
    gj, gt = JaxGravity(**kw), Gravity(**kw)
    pj, mj = jnp.asarray(pos), jnp.asarray(m)
    pt, mt = torch.from_numpy(pos), torch.from_numpy(m)
    a = gt.acceleration(pt, mt)
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    _close(a.numpy(), gj.acceleration(pj, mj))
    _close(gt.force(pt, mt).numpy(), gj.force(pj, mj))
    np.testing.assert_allclose(float(gt.energy(pt, mt)), float(gj.energy(pj, mj)), rtol=RTOL)


def test_gravity_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown gravity mode"):
        Gravity(mode="spline").acceleration(torch.zeros((3, 2)), torch.ones(3))


# (n, dim, block, softening, with_potential): the JAX tests' two cases
# (n=96 block 64 in 2D; n=64 with the potential in 3D) and an n that is not
# a multiple of the block
PALLAS_CASES = [(96, 2, 64, 0.1, False), (64, 3, 64, 0.2, True), (100, 2, 64, 0.1, True)]


@pytest.mark.parametrize("n,dim,block,softening,with_potential", PALLAS_CASES)
def test_plain_version_matches_jax_pallas(n, dim, block, softening, with_potential):
    pos, m = _bodies(n, dim, seed=n)
    fn_j = make_gravity_accel_pallas(n, softening=softening, block_size=block,
                                     with_potential=with_potential)
    out_j = fn_j(jnp.asarray(pos), jnp.asarray(m))
    out_t = make_gravity_accel_pairwise(n, softening=softening, with_potential=with_potential)(
        torch.from_numpy(pos), torch.from_numpy(m))
    if with_potential:
        _close(out_t[0].numpy(), out_j[0])
        _close(out_t[1].numpy(), out_j[1])
        assert out_t[1].shape == (n,)
    else:
        assert out_t.shape == (n, dim) and out_t.dtype == torch.float32
        _close(out_t.numpy(), out_j)


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_version_matches_plummer_gravity_across_chunks(monkeypatch, dim):
    """Against ``Gravity(mode="plummer")`` in float64 (1e-12), in row chunks
    of 64: the chunked result is bit-equal to the one-chunk result; and
    0.5 * sum(m * phi) is ``Gravity.energy``."""
    n, soft, g = 300, 0.1, 2.0
    pos, m = _bodies(n, dim, seed=10 + dim)
    x, mass = torch.from_numpy(pos).double(), torch.from_numpy(m).double()
    whole = gravity_accel_pairwise_reference(x, mass, g, soft, with_potential=True)
    monkeypatch.setattr(pairwise_cuda, "_REFERENCE_PAIRS", 64 * n)
    chunked = gravity_accel_pairwise_reference(x, mass, g, soft, with_potential=True)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    grav = Gravity(g=g, mode="plummer", softening=soft)
    np.testing.assert_allclose(chunked[0].numpy(), grav.acceleration(x, mass).numpy(), rtol=1e-12, atol=1e-14)
    e_phi = 0.5 * float(torch.sum(mass * chunked[1]))
    np.testing.assert_allclose(e_phi, float(grav.energy(x, mass)), rtol=1e-12)
    # float32, through the wrapper: the energy at float32 roundoff
    a32, phi32 = gravity_accel_pairwise(x.float(), mass.float(), g, soft, with_potential=True)
    np.testing.assert_allclose(0.5 * float(torch.sum(mass.float() * phi32)), float(grav.energy(x, mass)),
                               rtol=RTOL)
    _close(a32.numpy(), grav.acceleration(x, mass).numpy())


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    x, m = torch.zeros((10, 2)), torch.ones(10)
    before = (pairwise_cuda.GRAVITY_LAUNCHES, pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES)
    with pytest.raises(TypeError):
        gravity_accel_pairwise(x.double(), m)
    with pytest.raises(TypeError):
        gravity_accel_pairwise(x, m.double())
    with pytest.raises(ValueError, match="shape"):
        gravity_accel_pairwise(torch.zeros((10, 4)), m)
    with pytest.raises(ValueError, match="masses: expected shape"):
        gravity_accel_pairwise(x, torch.ones(9))
    with pytest.raises(ValueError, match="contiguous"):
        gravity_accel_pairwise(torch.zeros((2, 10)).t(), m)
    with pytest.raises(ValueError, match="N=10"):
        make_gravity_accel_pairwise(10)(torch.zeros((11, 2)), torch.ones(11))
    a, phi = make_gravity_accel_pairwise(10, softening=0.1, with_potential=True)(torch.rand((10, 2)), m)
    assert a.shape == (10, 2) and phi.shape == (10,)
    assert (pairwise_cuda.GRAVITY_LAUNCHES, pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES) == before
