"""The 3D engine's rebuild flags, single and row-sharded (one rank, in this
process): B6's mover flag -- some cell with more than ``migrate_k_mov``
movers, where the JAX package's compacted kernel drops particles -- loses
nothing in the port, so it adds one to the state's ``mover_flags`` and
leaves ``overflow`` down, with grids equal to B7's (no flag); a cell past
its capacity, a far mover, a skin violation and, in pure static mode, a
``max_occ`` above ``static_cov`` still raise ``overflow``. ``lj_fluid.run``
reports the count. Imports no jax.

The states are ``test_torch_migrate3_fused.py``'s, built in the port: a
lattice at N=1000 in a box of 12 (4 cells per side, capacity 32), every
particle moved up to 0.35 (mild) or 1.2 (hot: more than k_mov = 8 movers in
some cell), and the mild state with 40 particles crowded into one cell."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_migrate3_fused import BOX, K_MOV, N, _crowded, _moved
from tests.torch_parity import lattice_positions, velocities

GRID3_FIELDS = ("xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "occ", "pid",
                "crx", "cry", "crz", "cvx", "cvy", "cvz", "max_occ", "dmax2", "dispx")
CASES = ("movers", "capacity", "far_mover", "skin", "static_bound")


def _engine(sharded: bool, **kw):
    kw = dict(dict(compensated=True, static_cov="auto", migrate_k_mov=K_MOV), **kw)
    gf = make_cell_grid_fn(BOX, 2.5, N, dim=3)
    if sharded:
        return ShardedGridMD3(gf, make_mesh(device="cpu"), **kw)
    return GridMD3(gf, device="cpu", **kw)


def _start(md):
    pos = np.mod(lattice_positions(N, BOX, seed=6, dim=3), BOX)
    vel = velocities(N, kt=1.0, seed=7, dim=3)
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel))
    return s.replace(overflow=torch.zeros((), dtype=torch.bool))


def _max_movers(md, s) -> int:
    scode = md._migration_dest(s)[3]
    return int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != migrate_cuda3.STAY)).sum(1).max())


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("case", CASES)
def test_only_lost_physics_raises_overflow(case, sharded):
    md = _engine(sharded, static_cov=8) if case == "static_bound" else _engine(sharded)
    s0 = _start(md)
    mild = _moved(md, s0, 0.35, seed=4)
    assert int(mild.mover_flags) == 0 and not bool(mild.overflow)
    if case == "movers":
        hot = _moved(md, s0, 1.2, seed=3)
        assert _max_movers(md, hot) > K_MOV
        rb = md._rebuild_migrate(hot)
        assert not bool(rb.overflow) and int(rb.mover_flags) == 1
        assert rb.mover_flags.dtype == torch.int32 and rb.mover_flags.dim() == 0
        # the count adds up over rebuilds
        assert int(md._rebuild_migrate(hot.replace(mover_flags=rb.mover_flags)).mover_flags) == 2
        flat = _engine(False, migrate_compact=False)._rebuild_migrate(hot)
        assert int(flat.mover_flags) == 0 and not bool(flat.overflow)
        for name in GRID3_FIELDS:
            assert torch.equal(getattr(rb, name), getattr(flat, name)), name
        return
    if case == "capacity":
        bad = md._rebuild_migrate(_crowded(md, mild))
    elif case == "far_mover":
        # particle 0 jumps 2.5 cells in x: kept in its cell, flagged
        cell = md.box / md.cps
        bad = md._rebuild_migrate(mild.replace(xg=mild.xg + (mild.pid == 0).to(mild.xg.dtype) * 2.5 * cell))
    elif case == "skin":
        jump = mild.replace(dispx=mild.dispx + (mild.pid == 0).to(mild.xg.dtype) * md.skin)
        bad = md._window_for(jump, 1)(jump)
    else:
        # pure static mode with cov 8 under a mean occupancy of ~15.6
        assert int(mild.max_occ) > md.static_cov
        bad = md._rebuild_migrate(mild)
    assert bool(bad.overflow) and int(bad.mover_flags) == 0
    if case in ("capacity", "far_mover"):
        # without the fault the same rebuild raises neither flag
        clean = md._rebuild_migrate(mild)
        assert not bool(clean.overflow) and int(clean.mover_flags) == 0


def test_run_reports_the_mover_count_apart_from_overflow():
    """``lj_fluid.run`` on an engine with k_mov 1, whose lattice start has
    cells with two movers or more at its rebuilds: the count rises,
    ``overflow`` stays down, and the positions equal B7's run."""
    cfg = override(MDConfig(), n=216, rho=0.125, dim=3, cutoff=2.5, force_impl="grid", init="lattice",
                   eq_steps=40, prod_steps=40, sample_every=20, dt=1e-3)
    runs = {}
    for compact in (True, False):
        md = lj_fluid._make_grid_md(cfg, "cpu")
        md.migrate_k_mov, md.migrate_compact = 1, compact
        runs[compact] = lj_fluid.run(cfg, device="cpu", md=md)
    assert runs[True].mover_flags > 0 and runs[False].mover_flags == 0
    assert not runs[True].overflow and not runs[False].overflow
    assert torch.equal(runs[True].r_history, runs[False].r_history)
