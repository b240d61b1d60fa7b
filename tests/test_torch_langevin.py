"""The BAOAB Langevin windows (NVT) of the PyTorch port's grid engines,
2D and 3D: against the JAX package's windows where the noise vanishes
(target kT = 0, so c2 = 0), the port's own noise stream (seeded, its global
step carried in the state, reproducible), and the ``md`` CLI with
``--thermostat langevin``. The port's noise is keyed by particle and step
(``noise_cuda``), the JAX package's comes from ``jax.random``: with kT > 0
the two agree only in distribution, which ``test_torch_langevin_physics.py``
checks (``test_torch_langevin_cell.py`` holds the keyed stream itself)."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import exact_pallas_reciprocal, lattice_positions, periodic_distance, velocities


def md2(n, rho, dt=2e-3, compensated=True):
    """A 2D engine on the CPU, and lattice positions and velocities."""
    box = float(np.sqrt(n / rho))
    md = GridMD(make_cell_grid_fn(box, 2.5, n, dim=2), dt=dt, compensated=compensated, device="cpu")
    pos = np.mod(lattice_positions(n, box, seed=n), box)
    return md, pos, velocities(n, kt=1.0, seed=n + 1)


def _close(md_t, s_t, md_j, s_j):
    """Per particle: positions at 1e-5 * box (periodic distance),
    velocities at rtol 1e-5 (atol 1e-5: components cross zero)."""
    d = periodic_distance(md_t.positions(s_t).numpy(), np.asarray(md_j.positions(s_j)), md_t.box)
    assert d.max() <= 1e-5 * md_t.box, d.max()
    np.testing.assert_allclose(md_t.velocities(s_t).numpy(), np.asarray(md_j.velocities(s_j)),
                               rtol=1e-5, atol=1e-5)
    assert bool(s_t.overflow) == bool(s_j.overflow) is False


def test_zero_kt_window_matches_jax_2d():
    """kT = 0 leaves the friction c1 = exp(-gamma dt) and no noise: a
    20-step BAOAB window on the packed layout (n=512: cps 8, R=8) matches
    the JAX package's, Kahan positions included."""
    md_t, pos, vel = md2(512, 0.8)
    assert md_t.rows_per_block == 8
    md_j = JaxGridMD(jax_make_cell_grid_fn(md_t.box, 2.5, 512, dim=2), dt=2e-3, compensated=True)
    thermo = (1.5, 0.0)
    with exact_pallas_reciprocal():
        s_j = jax.jit(md_j._make_window(md_j.force_kernel, 20, thermostat=thermo))(
            md_j.init(jnp.asarray(pos), jnp.asarray(vel), seed=5))
    s_t = md_t._make_window(md_t.force_kernel, 20, thermo)(
        md_t.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=5))
    _close(md_t, s_t, md_j, s_j)
    assert s_t.rng_counter == 20
    # the friction took out kinetic energy that the NVE window keeps
    nve = md_t._make_window(md_t.force_kernel, 20)(md_t.init(torch.from_numpy(pos), torch.from_numpy(vel)))
    assert float(md_t.kinetic_energy(s_t)) < 0.95 * float(md_t.kinetic_energy(nve))


def test_zero_kt_window_matches_jax_3d():
    n, box = 216, 12.0  # cps 4, cap 16
    gf_t = make_cell_grid_fn(box, 2.5, n, dim=3)
    md_t = GridMD3(gf_t, dt=2e-3, compensated=True, device="cpu")
    md_j = JaxGridMD3(jax_make_cell_grid_fn(box, 2.5, n, dim=3), dt=2e-3, compensated=True)
    pos = np.mod(lattice_positions(n, box, seed=4, dim=3), box)
    vel = velocities(n, kt=1.0, seed=5, dim=3)
    thermo = (1.5, 0.0)
    with exact_pallas_reciprocal():
        s_j = jax.jit(md_j._make_window(md_j.force_kernel, 10, thermostat=thermo))(
            md_j.init(jnp.asarray(pos), jnp.asarray(vel), seed=5))
    s_t = md_t._make_window(md_t.force_kernel, 10, thermo)(
        md_t.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=5))
    _close(md_t, s_t, md_j, s_j)


def test_noise_stream_is_reproducible():
    """The same seed gives bit-equal trajectories, re-running a window from
    one state gives the same state, another seed another trajectory; the
    counter (the global step that keys the noise) advances by the window
    length and survives rebuilds, and another starting step gives another
    trajectory."""
    md, pos, vel = md2(400, 0.8)
    thermo = (1.0, 1.0)
    chunk = md.make_chunk_step(4, 0.3, thermostat=thermo)

    def run(seed, n_chunks=30, step=0):
        s = md.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=seed, step=step)
        for _ in range(n_chunks):
            s = chunk(s)
        return s

    a, b, c = run(3), run(3), run(4)
    for name in ("xg", "yg", "vxg", "vyg", "pid", "occ"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.vxg, c.vxg)
    assert a.rng_counter == 120 and a.rng_seed == 3
    window = md._make_window(md.force_kernel, 4, thermo)
    w1, w2 = window(a), window(a)
    assert torch.equal(w1.vxg, w2.vxg) and torch.equal(w1.xg, w2.xg)
    assert a.rng_counter == 120 and w1.rng_counter == 124
    assert md._rebuild_migrate(w1).rng_counter == 124
    later = run(3, n_chunks=1, step=120)  # the same seed, 120 steps on: other noise
    assert later.rng_counter == 124 and not torch.equal(later.vxg, run(3, n_chunks=1).vxg)


def test_missing_seed_raises():
    md, pos, vel = md2(256, 0.8)
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel))
    with pytest.raises(ValueError, match="PRNG"):
        md.make_chunk_step(4, thermostat=(1.0, 1.0))(s)
    with pytest.raises(ValueError, match="PRNG"):
        md._make_window(md.force_kernel, 2, (1.0, 1.0))(s)


def test_3d_step_is_a_gated_single_step_window():
    """``step`` / ``step_nocheck`` of the 3D engine: the 1-step window, with
    a rebuild before it once the displacement passes skin/2."""
    md = GridMD3(make_cell_grid_fn(12.0, 2.5, 216, dim=3), dt=2e-3, device="cpu")
    pos = np.mod(lattice_positions(216, 12.0, seed=8, dim=3), 12.0)
    s0 = md.init(torch.from_numpy(pos), torch.from_numpy(velocities(216, kt=1.0, seed=9, dim=3)))
    assert torch.equal(md.step_nocheck(s0).xg, md._make_window(md.force_kernel, 1)(s0).xg)
    a, b = s0, s0
    chunk = md.make_chunk_step(1, gate_frac=0.5)
    for _ in range(30):
        a, b = md.step(a), chunk(b)
    assert torch.equal(a.xg, b.xg) and torch.equal(a.vzg, b.vzg) and float(a.time) == float(b.time)


def test_cli_md_langevin_cpu(capsys):
    rc = cli.main(["md", "--N", "400", "--rho", "0.5", "--cutoff", "2.5", "--force-impl", "grid",
                   "--init", "lattice", "--eq_steps", "40", "--prod_steps", "40", "--sample_every", "20",
                   "--thermostat", "langevin", "--gamma", "2.0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ensemble: NVT (langevin, gamma=2.0)" in out
    assert "energy drift: n/a (NVT" in out and "OVERFLOW" not in out
    assert "kernels B3 (packed, R=9, grid (1, 16, 81)), B2 packed" in out
