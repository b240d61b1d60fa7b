"""The physics of the PyTorch port's BAOAB Langevin windows (NVT), which
its own noise stream decides (see ``test_torch_langevin.py``): the kinetic
temperature converges to the bath's, empty slots stay at rest and no
particle is lost through rebuilds, and ``lj_fluid.run`` with
``thermostat="langevin"`` in 2D and 3D."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import lattice_positions, velocities


def md2(n, rho, dt=2e-3, compensated=True):
    """A 2D engine on the CPU, and lattice positions and velocities."""
    box = float(np.sqrt(n / rho))
    md = GridMD(make_cell_grid_fn(box, 2.5, n, dim=2), dt=dt, compensated=compensated, device="cpu")
    pos = np.mod(lattice_positions(n, box, seed=n), box)
    return md, pos, velocities(n, kt=1.0, seed=n + 1)


def test_converges_to_target_kt():
    """A hot start (kT 1) relaxes to the bath's kT 0.5 (2D, n=1024, the
    JAX package's test, at 600 + 10 x 30 steps where it takes 2000 + 10 x
    100): KE/N over 10 samples within 6%."""
    md, pos, vel = md2(1024, 0.8)
    kt_target = 0.5
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=7)
    s = md.make_production_run(600, 5, gate_frac=0.35, thermostat=(2.0, kt_target))(s)
    block = md.make_production_run(30, 5, gate_frac=0.35, thermostat=(2.0, kt_target))
    kts = []
    for _ in range(10):
        s = block(s)
        kts.append(float(md.kinetic_energy(s)) / md.n)  # 2D: KE/N = kT
    assert not bool(s.overflow)
    assert np.mean(kts) == pytest.approx(kt_target, rel=0.06)


@pytest.mark.parametrize("dim", [2, 3])
def test_empty_slots_stay_at_rest(dim):
    """Occupancy-masked noise: empty slots keep velocity 0 and the x
    sentinel exactly, through rebuilds; no particle is lost."""
    if dim == 2:
        md, pos, vel = md2(400, 0.8, compensated=False)
    else:
        md = GridMD3(make_cell_grid_fn(12.0, 2.5, 216, dim=3), dt=2e-3, device="cpu")
        pos = np.mod(lattice_positions(216, 12.0, seed=6, dim=3), 12.0)
        vel = velocities(216, kt=0.8, seed=7, dim=3)
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=3)
    chunk = md.make_chunk_step(4, 0.3, thermostat=(1.0, 0.8))
    rebuilds = 0
    for _ in range(60):
        rebuilds += bool(md._needs_rebuild(s, frac=0.3))
        s = chunk(s)
    assert rebuilds >= 2 and not bool(s.overflow)
    empty = s.occ < 0.5
    for a in md.AXES:
        assert float(getattr(s, f"v{a}g")[empty].abs().max()) == 0.0
    assert bool((s.xg[empty] == md.sentinel).all())
    assert int(s.occ.sum()) == md.n
    assert sorted(s.pid[~empty].tolist()) == list(range(md.n))


@pytest.mark.parametrize("dim", [2, 3])
def test_run_with_thermostat_cpu(dim):
    """``lj_fluid.run`` with the Langevin thermostat: the gated drivers (no
    fixed cadence), no overflow, finite samples, the kinetic temperature
    near the target; off the grid engine a ValueError."""
    common = dict(rho=0.5 if dim == 2 else 0.125, cutoff=2.5, force_impl="grid", init="lattice",
                  eq_steps=200, prod_steps=200, sample_every=20, thermostat="langevin", gamma=5.0)
    cfg = override(MDConfig(), n=400 if dim == 2 else 216, dim=dim, **common)
    res = lj_fluid.run(cfg, device="cpu")
    assert not res.overflow and res.cadence is None
    assert bool(torch.isfinite(res.r_history).all()) and bool(torch.isfinite(res.pe_history).all())
    kt = 2.0 * res.ke_history.double() / (cfg.n * dim)
    assert abs(float(kt.mean()) - cfg.kt) < 0.15
    with pytest.raises(ValueError, match="grid engine only"):
        lj_fluid.run(override(cfg, force_impl="cell"), device="cpu")
