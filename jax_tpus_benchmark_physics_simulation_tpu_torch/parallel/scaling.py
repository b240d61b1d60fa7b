"""Multi-device MD scaling sweep: strong and weak scaling of the row-sharded
grid engines, with a trajectory parity check against one device.

Port of the JAX package's ``parallel/scaling.py``. JAX runs every point of
the sweep in one process, on a mesh over the first d devices. Here one
process drives one device: the sweep runs on every rank of a process group
of D ranks (``mdscale --virtual D`` spawns D gloo processes on the CPU; on
cards, ``torchrun`` or one spawned NCCL process a card), and the point with
d devices runs on a subgroup of the first d ranks while the others wait. A
point with one device builds the plain engine, as JAX's does. Rank 0
returns the rows and logs; the other ranks return an empty list.

Strong scaling: fixed N, rows split over devices. Weak scaling: N grows
with the device count. Sizes are rounded (:func:`_round_to_divisible_n`)
so that every point's cell rows divide over its devices, and the N used is
reported.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import world_size

# _check_parity's tolerance on positions, the JAX package's
PARITY_TOL = 2e-4


def _build_engine(cfg: MDConfig, n_devices: int, device, group=None):
    """``(engine, grid_fn)``: the plain engine for one device, the
    row-sharded one over ``group`` (of ``n_devices`` ranks) otherwise, or
    ``(None, grid_fn)`` when the cell rows do not divide over the devices.
    3D takes the hybrid B5/B4 windows, as ``lj_fluid`` does."""
    skin = cfg.skin
    if skin is None:
        skin = lj_fluid.resolve_skin(cfg, "grid", n_devices=n_devices)
    gf = make_cell_grid_fn(cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=skin, rho=cfg.rho)
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated)
    if cfg.dim == 3:
        kw["static_cov"] = "auto"
    if n_devices == 1:
        engine = GridMD3 if cfg.dim == 3 else GridMD
        return engine(gf, device=device, **kw), gf
    if gf.cells_per_side % n_devices:
        return None, gf
    engine = ShardedGridMD3 if cfg.dim == 3 else ShardedGridMD
    return engine(gf, make_mesh(n_devices, group=group, device=device), **kw), gf


def _time_steps(md, gs, n_inner: int, n_chunks: int, repeats: int = 3, gate_frac: float = 0.25) -> float:
    """Best-of wall seconds for ``n_chunks * n_inner`` steps of the gated
    production driver, each run ended by a read of the rank-summed kinetic
    energy (a device sync, and on several ranks a barrier)."""
    run = md.make_production_run(n_chunks * n_inner, n_inner, gate_frac=gate_frac)
    gs = run(gs)
    float(md.kinetic_energy(gs))  # warm-up: kernel build, allocator
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        gs = run(gs)
        float(md.kinetic_energy(gs))
        best = min(best, time.perf_counter() - t0)
    if bool(gs.overflow):
        raise RuntimeError(
            "scaling sweep: capacity/skin overflow during timing (never silent: reduce dt or raise skin)"
        )
    return best


def _lcm(devices: List[int]) -> int:
    lcm = 1
    for d in devices:
        lcm = lcm * d // math.gcd(lcm, d)
    return lcm


def _round_to_divisible_n(n: int, cfg: MDConfig, devices: List[int]) -> int:
    """Largest n' <= n whose cell-row count divides every mesh size (keeps
    all strong-scaling points valid)."""
    lcm = _lcm(devices)
    skin = cfg.skin
    if skin is None:
        skin = lj_fluid.resolve_skin(override(cfg, n=n), "grid", n_devices=lcm)
    cell = cfg.cutoff + skin
    box = (n / cfg.rho) ** (1.0 / cfg.dim)
    cps = int(box / cell)
    cps -= cps % lcm
    if cps < max(3, lcm):
        raise ValueError(f"N={n} too small for a {lcm}-divisible cell grid (cps={cps})")
    # a 0.1-cell margin: a box exactly on the cps*cell boundary can truncate
    # to cps-1 in make_cell_grid_fn's int(box/cell); clamped to the
    # requested n, which the margin alone could exceed
    box = (cps + 0.1) * cell
    return min(n, int(cfg.rho * box**cfg.dim))


def default_devices(available: int) -> List[int]:
    """1, the powers of 2 up to ``available``, and ``available``."""
    return sorted({1} | {2**k for k in range(1, 10) if 2**k <= available} | {available})


def md_scaling_sweep(
    base: MDConfig,
    devices: Optional[List[int]] = None,
    mode: str = "strong",
    steps: int = 200,
    parity_steps: int = 50,
    log: Callable[[str], None] = print,
    device="cuda",
) -> List[dict]:
    """Run the sweep on every rank of the process group (one rank without
    one); rank 0 returns the rows
    ``{devices, n, ms_per_step, psps, efficiency_pct, parity_ok}``.

    Parity: every multi-device point re-runs ``parity_steps`` steps from the
    same initial state on one device and on the mesh and compares the
    positions at :data:`PARITY_TOL` (the halo machinery must reproduce the
    one-device trajectory, not just run)."""
    world = world_size()
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        devices = default_devices(world)
    if max(devices) > world:
        raise ValueError(f"devices {devices}: a point needs one rank a device, the group has {world}")
    if base.cutoff is None:
        raise ValueError("mdscale requires a cutoff (grid engine)")
    if base.skin is None:
        # the auto skin once for the whole sweep: every point (and the
        # one-device parity run) builds the same geometry
        base = override(base, skin=lj_fluid.resolve_skin(base, "grid", n_devices=_lcm(devices)))
    # every rank creates every subgroup, in the same order
    groups = {d: dist.new_group(list(range(d))) for d in devices if d > 1}
    log = log if rank == 0 else (lambda msg: None)
    rows: List[dict] = []
    t_ref = None
    for d in devices:
        if mode == "weak":
            cfg = override(base, n=_round_to_divisible_n(base.n * d, base, [d]))
        else:
            cfg = override(base, n=_round_to_divisible_n(base.n, base, devices))
        if rank >= d:
            continue
        md, gf = _build_engine(cfg, d, device, groups.get(d))
        if md is None:
            log(f"[mdscale] skip {d} devices: cps {gf.cells_per_side} not divisible")
            continue
        state = lj_fluid.init_state(cfg, device)
        gs = md.init(state.position, state.velocity)
        k, gate = lj_fluid._grid_inner_steps(cfg, md)
        n_chunks = max(1, steps // k)
        wall = _time_steps(md, gs, k, n_chunks, gate_frac=gate)
        n_steps = n_chunks * k
        ms = wall / n_steps * 1e3
        psps = cfg.n * n_steps / wall
        parity_ok = None
        if d > 1 and parity_steps:
            parity_ok = _check_parity(cfg, md, state, parity_steps, device)
        if t_ref is None:
            t_ref = ms
        # strong: d devices at 1/d of the time is 100%; weak: constant time
        eff = t_ref / (ms * d) * 100.0 if mode == "strong" else t_ref / ms * 100.0
        rows.append(
            {"devices": d, "n": cfg.n, "ms_per_step": ms, "psps": psps,
             "efficiency_pct": eff, "parity_ok": parity_ok}
        )
        log(
            f"[mdscale] {d} device(s): N={cfg.n:,} {ms:8.3f} ms/step "
            f"{psps / 1e6:9.2f}M psps  eff={eff:5.1f}%"
            + (f"  parity={'OK' if parity_ok else 'FAIL'}" if parity_ok is not None else "")
        )
    return rows if rank == 0 else []


def parity(cfg: MDConfig, md_multi, state, steps: int, device):
    """``(ok, max_abs_err)`` of the positions after ``steps`` chunked steps
    from one start on the row-sharded engine and on the plain one-device
    engine (``ok``: ``torch.allclose`` at :data:`PARITY_TOL`), on rank 0,
    which runs the one-device trajectory alone; every rank of the mesh runs
    the sharded one. None on the other ranks."""
    rank = md_multi.mesh.rank
    k_auto, gate = lj_fluid._grid_inner_steps(cfg, md_multi)
    k = min(steps, k_auto)

    def run(md):
        gs = md.init(state.position, state.velocity)
        chunk = md.make_chunk_step(k, gate_frac=gate)
        for _ in range(max(1, steps // k)):
            gs = chunk(gs)
        return md.positions(gs)

    p1 = run(_build_engine(cfg, 1, device)[0]) if rank == 0 else None
    pd = run(md_multi)
    if rank != 0:
        return None
    return bool(torch.allclose(p1, pd, rtol=PARITY_TOL, atol=PARITY_TOL)), float((p1 - pd).abs().max())


def _check_parity(cfg: MDConfig, md_multi, state, steps: int, device) -> Optional[bool]:
    """Sharded trajectory == one-device trajectory from the same start
    (rank 0's verdict; None on the other ranks)."""
    out = parity(cfg, md_multi, state, steps, device)
    return None if out is None else out[0]


def sweep_on_rank(cfg: MDConfig, devices, mode: str, steps: int, parity_steps: int, device_type: str) -> List[dict]:
    """:func:`md_scaling_sweep` as one rank of :func:`..spawn.run_ranks`:
    on the CPU (gloo) or on this rank's card (NCCL)."""
    device = "cpu" if device_type == "cpu" else f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    return md_scaling_sweep(
        cfg, devices=devices, mode=mode, steps=steps, parity_steps=parity_steps,
        log=lambda msg: print(msg, flush=True), device=device,
    )
