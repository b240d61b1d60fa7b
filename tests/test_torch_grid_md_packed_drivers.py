"""The drivers of the PyTorch port's 2D grid engine on the lane-packed
layout (R = 4) against the JAX package's: a 300-step chunked trajectory
with rebuilds, and ``step`` / ``step_nocheck`` (see
``test_torch_grid_md_packed.py`` for the engines)."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from tests.test_torch_grid_md_packed import close_to_jax, engines
from tests.torch_parity import exact_pallas_reciprocal


@pytest.fixture(scope="module")
def start():
    md_j, md_t, pos, vel = engines()
    with exact_pallas_reciprocal():
        init_j = md_j.init(jnp.asarray(pos), jnp.asarray(vel))
    return md_j, md_t, init_j, md_t.init(torch.from_numpy(pos), torch.from_numpy(vel))


def test_chunked_trajectory_matches_jax(start):
    """300 steps in 30 chunks of 10 (rebuilds firing), per particle at 2e-4,
    as the JAX package holds its packed engine to its base one."""
    md_j, md_t, init_j, init_t = start
    with exact_pallas_reciprocal():
        chunk_j = md_j.make_chunk_step(10)
        run_j = jax.jit(lambda s: jax.lax.fori_loop(0, 30, lambda i, t: chunk_j(t), s))(init_j)
        pe_j = float(md_j.potential_energy(run_j))
    chunk = md_t.make_chunk_step(10)
    s = init_t
    for _ in range(30):
        s = chunk(s)
    close_to_jax(md_t, s, md_j, run_j, 2e-4)
    assert not bool(s.overflow)
    np.testing.assert_allclose(float(md_t.potential_energy(s)), pe_j, rtol=1e-4)



def test_step_and_step_nocheck_match_jax(start):
    """``step`` (a rebuild before a step once the displacement passes
    skin/2, so the skin/2 flag is up by then in both packages) over 40
    steps, and one ``step_nocheck``, against the JAX package's."""
    md_j, md_t, init_j, init_t = start
    with exact_pallas_reciprocal():
        one_j = jax.jit(md_j.step_nocheck)(init_j)
        run_j = jax.jit(lambda s: jax.lax.fori_loop(0, 40, lambda i, t: md_j.step(t), s))(init_j)
    close_to_jax(md_t, md_t.step_nocheck(init_t), md_j, one_j, 1e-5)
    s = init_t
    for _ in range(40):
        s = md_t.step(s)
    close_to_jax(md_t, s, md_j, run_j, 2e-4)
