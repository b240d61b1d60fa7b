"""The core the port's 2D and 3D grid engines share (``grid_engine.py``),
held in every engine: the gated drivers against each other, the auto
sizing against the JAX package's, and the sort-based rebuild oracle
against the sort-free rebuild in the unpacked and packed 2D layouts and
in 3D."""

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import lattice_positions, periodic_distance, velocities


def _state(md, jitter=0.05, seed=8):
    d = len(md.AXES)
    pos = np.mod(lattice_positions(md.n, md.box, jitter=jitter, seed=seed, dim=d), md.box)
    return md.init(torch.from_numpy(pos), torch.from_numpy(velocities(md.n, kt=1.0, seed=seed + 1, dim=d)))


def _driver_case(engine: str):
    """``(md, state, steps, window, gate)``: the engine and run of
    test_torch_grid_md.py (2D) or test_torch_grid_md3.py (3D)."""
    if engine == "2d":
        md = GridMD(make_cell_grid_fn(float(np.sqrt(512 / 0.8)), 2.5, 512, dim=2), dt=2e-3, compensated=True,
                    rows_per_block=1, device="cpu")
        return md, _state(md), 100, 10, 0.25
    md = GridMD3(make_cell_grid_fn(12.0, 2.5, 216, dim=3), dt=2e-3, compensated=True, static_cov="auto",
                 migrate_k_mov=8, device="cpu")
    return md, _state(md, jitter=0.1), 60, 5, 0.25


@pytest.mark.parametrize("engine", ["2d", "3d"])
def test_chunk_driver_matches_production_driver(engine):
    """``make_chunk_step`` (gate checked before every window) follows the
    same trajectory as ``make_production_run``, per particle."""
    md, init, steps, k, gate = _driver_case(engine)
    gated = md.make_production_run(steps, k, gate_frac=gate)(init)
    chunk = md.make_chunk_step(k, gate_frac=gate)
    s = init
    for _ in range(steps // k):
        s = chunk(s)
    d = periodic_distance(md.positions(s).numpy(), md.positions(gated).numpy(), md.box)
    assert d.max() <= 1e-5
    np.testing.assert_allclose(md.velocities(s).numpy(), md.velocities(gated).numpy(), atol=1e-6)


# per dimension: N, skins (None: the grid's default), dts, kTs and the fixed
# driver's run lengths (none in 2D) at which the sizing rules are compared
AUTO_CASES = {
    2: ((4000, 16384, 100_000), (None,), (1e-4, 1e-3, 5e-3, 2e-2), (0.25, 1.0, 2.0), ()),
    3: ((8192, 100_000), (0.1316, 0.2, 0.4), (1e-4, 1e-3, 5e-3), (0.5, 1.0, 2.0), (100, 2000, 10**6)),
}


def _auto_pair(dim, n, skin, dt):
    """The JAX and the port's engine of one geometry: 2D unpacked, 3D
    hybrid."""
    box = (n / 0.8) ** (1.0 / dim)
    kw = {} if skin is None else dict(skin=skin)
    if dim == 2:
        return (JaxGridMD(jax_make_cell_grid_fn(box, 2.5, n, dim=2, **kw), dt=dt, rows_per_block=1),
                GridMD(make_cell_grid_fn(box, 2.5, n, dim=2, **kw), dt=dt, rows_per_block=1))
    return (JaxGridMD3(jax_make_cell_grid_fn(box, 2.5, n, dim=3, **kw), dt=dt, static_cov="auto"),
            GridMD3(make_cell_grid_fn(box, 2.5, n, dim=3, **kw), dt=dt, static_cov="auto"))


@pytest.mark.parametrize("dim", sorted(AUTO_CASES))
def test_auto_params_match_jax(dim):
    ns, skins, dts, kts, run_steps = AUTO_CASES[dim]
    for n in ns:
        for skin in skins:
            for dt in dts:
                md_j, md_t = _auto_pair(dim, n, skin, dt)
                if dim == 3:
                    assert md_t.static_cov == md_j.static_cov, (n, skin)
                for kt in kts:
                    assert md_t.auto_chunk_params(kt) == md_j.auto_chunk_params(kt), (n, skin, dt, kt)
                    assert md_t.auto_inner_steps(kt) == md_j.auto_inner_steps(kt), (n, skin, dt, kt)
                    for steps in run_steps:
                        assert md_t.auto_cadence(kt, steps) == md_j.auto_cadence(kt, steps)
    if dim == 2:
        assert md_t.auto_chunk_params(1.0) == (1, 0.25)
        gf = make_cell_grid_fn(float(np.sqrt(100_000 / 0.8)), 2.5, 100_000, dim=2)
        assert (gf.cells_per_side, gf.capacity) == (121, 16)
        assert GridMD(gf).auto_chunk_params(1.0) == (4, 0.4)


def _oracle_case(layout: str):
    """``(md, steps)``: the engine and a window short enough to stay within
    skin/2 before the rebuilds."""
    if layout == "3d":
        return GridMD3(make_cell_grid_fn(12.0, 2.5, 216, dim=3), dt=2e-3, compensated=True, device="cpu"), 25
    r = 4 if layout == "2d-packed" else 1
    return GridMD(make_cell_grid_fn(float(np.sqrt(1200 / 0.5)), 2.5, 1200, dim=2), dt=2e-3, compensated=True,
                  rows_per_block=r, device="cpu"), 20


@pytest.mark.parametrize("layout", ["2d-packed", "2d-unpacked", "3d"])
def test_sort_rebuild_oracle_matches_migrate_rebuild(layout):
    """The sort-based ``_rebuild`` oracle puts every particle at the
    position and velocity the sort-free rebuild gives it, with the same
    count grid and, in 3D, the same occupancy bound (its slots within a
    cell follow another order)."""
    md, steps = _oracle_case(layout)
    s = _state(md, seed=3)
    s = md._make_window(md.force_kernel, steps)(s)
    srt, mig = md._rebuild(s), md._rebuild_migrate(s)
    assert not bool(srt.overflow) and not bool(mig.overflow)
    assert int(srt.occ.sum()) == md.n and torch.equal(md._counts(srt.occ), md._counts(mig.occ))
    assert torch.equal(md._counts(s.occ).sum(), md._counts(mig.occ).sum())
    if len(md.AXES) == 3:
        assert int(srt.max_occ) == int(mig.max_occ)
    else:
        assert torch.equal(srt.counts, mig.counts) and torch.equal(mig.counts, md._counts(mig.occ))
        assert not torch.equal(md._counts(s.occ), mig.counts)  # particles changed cells
    np.testing.assert_array_equal(md.positions(srt).numpy(), md.positions(mig).numpy())
    np.testing.assert_array_equal(md.velocities(srt).numpy(), md.velocities(mig).numpy())
    assert float(srt.dmax2) == 0.0 and bool((srt.xg[srt.occ < 0.5] == md.sentinel).all())
