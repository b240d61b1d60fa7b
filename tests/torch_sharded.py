"""Rank-side checks of the port's row-sharded grid engines, shared by the
tests ``tests/test_torch_grid_md_sharded.py`` and
``tests/test_torch_grid_md3_sharded.py``.

Each function runs on every rank of a process group
(``parallel.spawn.run_ranks``, gloo on the CPU) or in one process, and
returns numpy results (rank 0's are the ones compared). This module imports
neither jax nor the JAX package, so a spawned rank does not load them.

The setups are the JAX package's sharded tests' (``tests/test_grid_md_
sharded.py:23``, ``tests/test_grid_md3_sharded.py:29``): a box of 16.05
(2D) or 8.05 (3D) cells of cutoff 2.5 + skin 0.4, so 16 or 8 cells per side
divide over 2, 4 and 8 ranks; N = 1600 (2D) or 2000 (3D), a jittered
lattice, velocities at kT 0.5, dt 1e-3.
"""

from __future__ import annotations

import numpy as np
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh
from tests.torch_parity import lattice_positions, velocities

CUTOFF, SKIN, DT, KT = 2.5, 0.4, 1e-3, 0.5
# the chunked run: 5 windows of 10 steps behind a rebuild gate at 0.1 of
# the skin, which trips within the run
STEPS, K, GATE = 50, 10, 0.1
# 3D engines as lj_fluid builds them: hybrid B5/B4 windows, k_mov 8
KW3 = dict(static_cov="auto", migrate_k_mov=8)


def setup(dim: int):
    """``(grid_fn, positions, velocities)`` of the JAX package's sharded
    tests' configuration, as numpy float32."""
    n, cells = (1600, 16.05) if dim == 2 else (2000, 8.05)
    box = cells * (CUTOFF + SKIN)
    gf = make_cell_grid_fn(box, CUTOFF, n, dim=dim, skin=SKIN, rho=n / box**dim)
    pos = np.mod(lattice_positions(n, box, seed=0, dim=dim), box).astype(np.float32)
    return gf, pos, velocities(n, kt=KT, seed=1, dim=dim)


def engine(dim: int, sharded: bool, **kw):
    """The engine under test on the CPU: row-sharded over the process group
    (one rank without one), or the plain one-device engine."""
    gf, _, _ = setup(dim)
    kw = dict(KW3, **kw) if dim == 3 else kw
    if sharded:
        cls = ShardedGridMD if dim == 2 else ShardedGridMD3
        return cls(gf, make_mesh(device="cpu"), dt=DT, **kw)
    if dim == 2:
        return GridMD(gf, dt=DT, rows_per_block=1, device="cpu", **kw)
    return GridMD3(gf, dt=DT, device="cpu", **kw)


def _forces(md, s):
    if isinstance(md, GridMD3):
        return md.force_kernel(s.xg, s.yg, s.zg, s.max_occ)
    return md.force_kernel(s.xg, s.yg)


def scenario(dim: int, sharded: bool) -> dict:
    """Forces, energies, a chunked run with its rebuilds, and the loud flags
    of one engine, from the shared start. Every rank returns the same
    (gathered or reduced) numbers."""
    md = engine(dim, sharded)
    _, pos, vel = setup(dim)
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel))
    out = {
        "rows": md.grid_shape[0],
        # a whole-grid state cut to this rank's rows is the rank's own start
        "shard_state_equal": not sharded or all(
            torch.equal(getattr(md.shard_state(engine(dim, sharded=False).init(
                torch.from_numpy(pos), torch.from_numpy(vel))), k), getattr(s, k))
            for k in ("xg", "yg", "vxg", "fxg", "occ", "pid")),
        "forces": md.particle_order(s, *_forces(md, s)[:dim]).numpy(),
        "pe": float(md.potential_energy(s)),
        "virial": float(md.virial(s)),
        "pressure": float(md.pressure(s)),
        "ke": float(md.kinetic_energy(s)),
    }
    rebuilds = [0]
    rebuild = md._rebuild_migrate

    def counted(st):
        rebuilds[0] += 1
        return rebuild(st)

    md._rebuild_migrate = counted
    chunk = md.make_chunk_step(K, gate_frac=GATE)
    run = s
    for _ in range(STEPS // K):
        run = chunk(run)
    md._rebuild_migrate = rebuild
    out.update(
        positions=md.positions(run).numpy(), velocities=md.velocities(run).numpy(),
        overflow=bool(run.overflow), rebuilds=rebuilds[0],
    )
    # particle 0 jumps 2.5 cells in x: the far-mover flag at the rebuild
    cell = md.box / md.cps
    far = run.replace(xg=run.xg + (run.pid == 0).to(run.xg.dtype) * 2.5 * cell)
    out["far_mover_overflow"] = bool(md._rebuild_migrate(far).overflow)
    # particle 0's displacement past skin/2: the window's violation flag
    jump = run.replace(dispx=run.dispx + (run.pid == 0).to(run.xg.dtype) * md.skin)
    out["skin_overflow"] = bool(md._window_for(jump, 1)(jump).overflow)
    out["clean_rebuild_overflow"] = bool(md._rebuild_migrate(run).overflow)
    if dim == 3:
        # every particle in the upper half of its cell's x range moves half a
        # cell up, into the next cell: B6's mover flag at each k_mov, as the
        # unsharded engine counts it, and the overflow it leaves down
        frac = torch.remainder(run.xg, cell) / cell
        moved = run.replace(xg=run.xg + (frac >= 0.5).to(run.xg.dtype) * run.occ * 0.5 * cell)
        flags, raised = [], []
        for k_mov in (1, 2, 4, 8, md.cap):
            md.migrate_k_mov = k_mov
            rebuilt = md._rebuild_migrate(moved)
            flags.append(int(rebuilt.mover_flags) - int(moved.mover_flags))
            raised.append(bool(rebuilt.overflow))
        out["mov_of"] = flags
        out["mov_overflow"] = raised
    return out


def langevin_kt(dim: int = 2, kt: float = 1.0, gamma: float = 5.0) -> float:
    """The mean kinetic temperature (KE / N per degree of freedom pair in
    2D) of 20 samples, 20 steps apart, after 300 steps of BAOAB windows at
    bath ``kt`` from a start at ``kt``."""
    md = engine(dim, sharded=True)
    _, pos, _ = setup(dim)
    vel = velocities(md.n, kt=kt, seed=5, dim=dim)
    s = md.init(torch.from_numpy(pos), torch.from_numpy(vel), seed=11)
    thermo = (gamma, kt)
    s = md.make_production_run(300, 5, gate_frac=0.25, thermostat=thermo)(s)
    block = md.make_production_run(20, 5, gate_frac=0.25, thermostat=thermo)
    kts = []
    for _ in range(20):
        s = block(s)
        kts.append(2.0 * float(md.kinetic_energy(s)) / (dim * md.n))
    if bool(s.overflow):
        raise AssertionError("Langevin run raised the overflow flag")
    return float(np.mean(kts))


def scenario_with_langevin(dim: int) -> dict:
    """:func:`scenario` of the row-sharded engine, plus :func:`langevin_kt`."""
    return dict(scenario(dim, sharded=True), langevin_kt=langevin_kt(dim))


def lj_fluid_run(cfg, undivided=None) -> dict:
    """``lj_fluid.run`` on the CPU in this process's process group: the
    engine class it picks and what it reports; with ``undivided`` (a
    config whose cells per side the group does not divide), the message of
    the ValueError its engine raises (None if it raises none)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    refused = None
    if undivided is not None:
        try:
            lj_fluid._make_grid_md(undivided, "cpu")
        except ValueError as e:
            refused = str(e)
    res = lj_fluid.run(cfg, device="cpu")
    return dict(
        engine=type(lj_fluid._make_grid_md(cfg, "cpu")).__name__,
        positions=res.state.position.numpy(), ke=res.ke_history.numpy(), pe=res.pe_history.numpy(),
        pressure=res.pressure, overflow=res.overflow, drift=res.energy_drift, refused=refused,
    )


def halo_allocation(cells: float = 12.05, n: int = 900) -> dict:
    """Rank side of the B2 halo allocation check: a box of ``cells`` cells
    of cutoff + skin (12 cells per side divide over 2 and 3 ranks), ``n``
    particles on a jittered lattice, every particle moved and one cell
    crowded past its capacity (``torch_migrate_designs.overflow_state``),
    then the sharded engine's ``_migration_dest`` on this rank's rows and
    the rebuild's exchange of the code and field edge rows. Returns whether
    the slots the local occupancy marks empty are exactly those no valid
    code of the extended rows names, how many valid codes land in the local
    rows against the named slots (equal when no slot is named twice),
    whether the plain emulation of one B2 halo launch writes every local
    element once and gives ``migrate_halo_reference``'s bits, the local
    overflow flag, and whether the gathered codes and occupancy are the
    unsharded engine's."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import migrate_halo_reference
    from tests.torch_migrate_designs import emulate, overflow_state, rebuild_inputs

    box = cells * (CUTOFF + SKIN)
    gf = make_cell_grid_fn(box, CUTOFF, n, dim=2, skin=SKIN, rho=n / box**2)
    pos = np.mod(lattice_positions(n, box, seed=0, dim=2), box).astype(np.float32)
    whole = GridMD(gf, dt=DT, rows_per_block=1, device="cpu")
    vel = torch.from_numpy(velocities(n, kt=KT, seed=1, dim=2))
    moved = overflow_state(whole, whole.init(torch.from_numpy(pos), vel))
    md = ShardedGridMD(gf, make_mesh(device="cpu"), dt=DT)
    scode, occ, planes, fills, overflow = rebuild_inputs(md, md.shard_state(moved))
    code, ext = md._halo_planes(scode, torch.stack(planes))
    named = migrate_halo_reference(code, torch.ones((1,) + tuple(code.shape)), [0.0])[0]
    rows, cap = occ.shape[0], occ.shape[1]
    tx = torch.arange(rows + 2).view(-1, 1, 1) + torch.div(code, 3 * cap, rounding_mode="floor") - 2
    landing = (code >= 0) & (code < 9 * cap) & (tx >= 0) & (tx < rows)
    got, writes = emulate(code, list(ext), occ, fills, halo=True)
    w_scode, w_occ = rebuild_inputs(whole, moved)[:2]
    return {
        "cps": md.cps,
        "named_is_occ": torch.equal(named, occ),
        "landing": int(landing.sum()),
        "named": int(named.sum()),
        "written_once": bool((writes == 1).all()),
        "emulation_is_plain": torch.equal(got, migrate_halo_reference(code, ext, fills)),
        "overflow": bool(overflow),
        "gathered_is_unsharded": torch.equal(md._gather_rows(scode), w_scode)
        and torch.equal(md._gather_rows(occ), w_occ),
    }
