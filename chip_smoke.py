"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the repository root. It builds the CUDA kernels from
``jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc`` (one
``nvcc`` per source, all at once), then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the kernel build time;
2. 2D kernels at the N=100k shapes (121 x 16 x 121 grid) on a state whose
   positions are unwrapped near the seams, each against its plain PyTorch
   version: B1 forces (max abs diff <= 1e-4 over occupied slots), B1 energy
   variant (e and w sums at rtol 1e-5), B2 (bit-equal); timed with CUDA
   events;
3. B1 forces on 1024 particles against the dense O(N^2) oracle computed
   from all 100k particles (atol 1e-4);
4. a 2D run at N=4096 on the card against the same run on the CPU (the
   plain versions), energies at rtol 1e-4;
5. the 2D main path, ``lj_fluid.run`` at N=100k (rho 0.8, cutoff 2.5,
   dt 1e-3, lattice init, Kahan on, 2000 + 2000 steps), with every launch
   counter set to 0 just before: overflow False, finite energies, energy
   drift < 1e-4, and B1, B1-energy and B2 launched;
6. the 3D main path, ``lj_fluid.run`` with ``dim=3`` at N=100k (the same
   configuration; skin 0.1316, 19 cells per side, fixed production
   cadence from the measured kT), with every counter set to 0 just before:
   overflow False, finite histories, drift < 1e-4, finite P*, and B4,
   B4-energy, B5 and B6 launched;
7. 3D kernels at the N=100k shapes (19 x 32 x 361 grid) on a state 90
   steps from the main path's final one, some coordinates outside
   [0, box): B4 and B5 forces against their plain versions and B5 against
   B4 (<= 1e-4 over occupied slots), B4's energy variant (forces <= 1e-4,
   e and w sums at rtol 1e-5), B6 and B7 against the plain version and
   each other (bit-equal); timed with CUDA events;
8. B4 forces on 1024 interior particles against the dense oracle computed
   from all 100k particles (atol 1e-4);
9. a 3D run at N=8192 (100 + 100 steps) on the card against the same run
   on the CPU, energies at rtol 1e-4 and the same overflow flags;
10. about 200 steps at N=100k with ``migrate_compact=False`` (B7), with
    every counter set to 0 just before: B7 launched, and the final state
    bit-equal to the same run on B6;
11. B8 (the all-pairs kernel) at N=16,384 in 2D (PBC, no cutoff) on a
    state 100 steps into the melt from the lattice, against its plain
    version: forces within 1e-4 * max |f|, the energy variant's forces
    likewise and its energy sum at rtol 1e-5, two launches bit-equal; at
    N=4096 also the cutoff-2.5 variant in 2D and the 3D variant without a
    box; timed with CUDA events;
12. the dense main path, ``lj_fluid.run`` at N=16,384 with no cutoff
    (rho 0.8, dt 1e-3, lattice init, 2000 + 2000 steps, ``force_impl``
    auto, which resolves to ``dense_pallas``), with every counter set to 0
    just before: overflow False, finite histories and g(r), drift < 1e-4,
    pressure NaN (as in the JAX package), B8 and its energy variant
    launched; then the card's busy share over 200 traced production steps
    (``torch.profiler``, trace in ``chiprun_out/``);
13. a dense run at N=2048 with no cutoff (100 + 100 steps), auto on both
    sides (B8 on the card, ``dense_xla`` on the CPU): energies at rtol 1e-4;
14. the list paths, ``neighbor`` and ``cell`` at N=4096 with cutoff 2.5
    (100 + 100 steps), card against CPU: energies at rtol 1e-4, overflow
    False on both;
15. 2D kernels at the packed shapes, on states 20 steps after a rebuild
    (coordinates unwrapped near the seams, block-crossing rows included):
    B3 at N=16,384 (cutoff 2.5: 49 cells per side, R=49, grid 1 x 16 x
    2401) and at N=1M (385 cells per side, R=7, grid 55 x 16 x 2695)
    against its plain version (forces <= 1e-4 over occupied slots, the
    energy variant's e and w sums at rtol 1e-5, two launches bit-equal),
    and B2 on the packed N=1M grid bit-equal to its plain version; timed
    with CUDA events;
16. B3 forces on 1024 interior particles of the N=16,384 packed state
    against the dense oracle computed from all 16,384 (atol 1e-4);
17. the packed main paths, ``lj_fluid.run`` at N=16,384 and at N=1M with
    cutoff 2.5 (rho 0.8, dt 1e-3, lattice init, Kahan on, 2000 + 2000
    steps), every counter set to 0 just before each: overflow False,
    finite histories, drift < 1e-4, B3, B3-energy and packed B2 launched
    and B1 and unpacked B2 not; at N=1M also the card's busy share over 200
    traced production steps;
18. the grid engine at N=4096 (cutoff 2.5; phase 4 runs it at its default
    R=24) with ``rows_per_block`` 1 and 4 (G=6): 100 + 100 steps on the card
    against the same on the CPU, energies at rtol 1e-4;
19. ``lj_fluid.run`` with the Langevin thermostat (gamma 1.0) at N=100k in
    2D and 3D (2000 + 2000 steps): overflow False, the mean kinetic
    temperature of the production samples within 5% of kT, and after 100
    more Langevin steps every empty slot's velocity exactly 0;
20. B9 (all-pairs softened gravity) through ``make_gravity_accel_pairwise``
    at N=16,384 in 2D and N=65,536 in 3D (positions normal * 10, masses
    0.5 + U(0, 1) from a numpy seed, softening 0.1, g 1), with and without
    the potential, every counter set to 0 just before: acceleration and phi
    within 1e-5 * max |.| of the plain version, two launches bit-equal, and
    at N=16,384 0.5 * sum(m * phi) against ``Gravity(mode="plummer")
    .energy`` at rtol 1e-5; timed with CUDA events;
21. B10 (the bandwidth op's copy) through ``make_bandwidth_op(mode=
    "pallas_copy")`` at 64Mi float32 and 128Mi bfloat16 elements (256 MiB
    each): bit-equal to the source; kernel, plain (``clone``) and
    ``dst.copy_(src)`` times; then B10 under ``runners._timed_loop`` (chain
    ``direct``, 20 steps), with every counter set to 0 just before, and its
    GiB/s;
22. the op suite, ``run_sweep`` in this process at full widths (matrix
    4096, depth 6, conv 64x128x128x32 -> 64, bandwidth 256 MiB) at steps
    20, warmup 1, repeats 2, in float32 and bfloat16: six rows with no
    error, every TFLOPS and GiB/s finite and under the card's peak for the
    dtype; then ``run_sweep_isolated`` with ops 2D and Bandwidth at steps 5,
    whose rows come back through the worker subprocess;
23. the n-body main path, ``nbody_merger.run`` in the default configuration
    (3 bodies, 1000 RK4 steps, tangent Lyapunov): finite trajectory and
    h_+, a finite positive Lyapunov exponent, the first 300 steps against
    the same run on the CPU at rtol 1e-5 (the margin printed), ms per RK4
    step and launches per step (``torch.profiler``); a dopri5 run
    (``steps_exceeded`` False, attempts printed); the two-trajectory
    estimate (d0 = 1e-2) with the tangent one's sign; the full-length
    tangent estimate on the CPU, and on the card with ``y0[0]`` one float32
    ulp up and down (finite; printed beside the card's);
24. prints a JSON line with each kernel's launches on its main path,
    error, times, and bound (the larger of the operations over the card's
    float32 peak and the bytes over its memory rate, counted on this run's
    inputs), and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no last line.
Without a CUDA device it stops before doing anything.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, from
    CUDA events, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_diff(got, want, occ, name: str, tol: float) -> float:
    """Max abs difference of the first grids of ``got`` and ``want`` over the
    occupied slots; raises above ``tol``."""
    err = max(float((a - b)[occ].abs().max()) for a, b in zip(got, want))
    if not err <= tol:
        raise AssertionError(f"{name}: max abs diff {err:.3e} > {tol}")
    return err


def _sums_close(got, want, name: str, rtol: float) -> float:
    """Checks the sums of the grids (e, w) at ``rtol``; returns their max abs
    element difference."""
    err = 0.0
    for label, a, b in zip(("e", "w"), got, want):
        sa, sb = float(a.double().sum()), float(b.double().sum())
        if not abs(sa - sb) <= rtol * abs(sb):
            raise AssertionError(f"{name}: sum of {label} {sa} vs {sb}, beyond rtol {rtol}")
        err = max(err, float((a - b).abs().max()))
    return err


def _pair_work(grids, occ, cps: int, bound: int, box: float, cutoff2: float):
    """``(candidates, in_cutoff)`` that a cell-list force needs on these
    inputs: each occupied particle against the occupied slots of its 3^d
    neighbour cells, itself excluded, and the pairs among them inside the
    cutoff. ``grids`` are the d coordinate grids, viewed as
    ``(cps, cap, cps[, cps])``; slots ``>= bound`` must be empty."""
    import torch

    d = len(grids)
    shape = (cps, occ.shape[1]) + (cps,) * (d - 1)
    coords = [g.reshape(shape)[:, :bound] for g in grids]
    occ_v = occ.reshape(shape)[:, :bound] > 0.5
    n_cell = occ_v.sum(1)
    cell_axes = (0,) + tuple(range(2, d + 1))
    idx = torch.arange(cps, device=occ.device)
    candidates, in_cut = -int(occ_v.sum()), 0
    for offs in itertools.product((-1, 0, 1), repeat=d):
        shifts = [-o for o in offs]
        candidates += int((n_cell * torch.roll(n_cell, shifts, tuple(range(d)))).sum())
        r2 = 0.0
        for k, g in enumerate(coords):
            seam = ((idx + offs[k] >= cps).float() - (idx + offs[k] < 0).float()) * box
            view = [1] * g.dim()
            view[cell_axes[k]] = cps
            p = torch.roll(g, shifts, cell_axes) + seam.view(view)
            diff = g.unsqueeze(2) - p.unsqueeze(1)
            r2 = r2 + diff * diff
        partner = torch.roll(occ_v, shifts, cell_axes)
        valid = (r2 > 0) & (r2 < cutoff2) & occ_v.unsqueeze(2) & partner.unsqueeze(1)
        in_cut += int(valid.sum())
    return candidates, in_cut


def _bound(flops: float, nbytes: float):
    """``(bound_ms, bound_by)``: the larger of the operations over the
    float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _force_bounds(work, dim: int, n_slots: int):
    """Bounds of the force kernel and its energy variant: a distance test
    costs 3d - 1 operations, an in-cutoff pair 7 + 2d more (one divide,
    s^6, the force magnitude, d products and d sums), 14 + 2d with the
    energy and virial; d coordinate grids in, d (or d + 2) out."""
    candidates, in_cut = work
    tests = (3 * dim - 1) * candidates
    return (_bound(tests + (7 + 2 * dim) * in_cut, 4 * n_slots * 2 * dim),
            _bound(tests + (14 + 2 * dim) * in_cut, 4 * n_slots * (2 * dim + 2)))


def _pairwise_bounds(n: int, dim: int):
    """Bounds of B8 and its energy variant: N^2 (4d + 12) operations, the
    JAX package's own cost estimate for the all-pairs kernel
    (pairwise_pallas.py:139-143) with N for its padded n_pad, and 4 more a
    pair with the energy (s12 - s6, the 4 eps product, the shift, the sum);
    the positions in, the forces (and energies) out."""
    pairs = float(n) * n
    return (_bound(pairs * (4 * dim + 12), 4 * n * 2 * dim),
            _bound(pairs * (4 * dim + 16), 4 * n * (2 * dim + 1)))


def _gravity_bounds(n: int, dim: int):
    """Bounds of B9 and its potential variant: N^2 (5d + 4) operations (d
    differences, d squares and d sums with the softening, the rsqrt, two
    products for inv_r^3, g m_j times inv_r^3, d products and d sums; g m_j
    is formed once per j and the j == i selects are not operations), N^2
    (5d + 6) with the potential (its product and sum); positions and masses
    in, accelerations (and potentials) out."""
    pairs = float(n) * n
    return (_bound(pairs * (5 * dim + 4), 4 * n * (2 * dim + 1)),
            _bound(pairs * (5 * dim + 6), 4 * n * (2 * dim + 2)))


def _migrate_bound(n_fields: int, n_slots: int):
    """A permutation: the code grid and F fields read once, F written."""
    return _bound(0.0, 4 * n_slots * (2 * n_fields + 1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import (
        _build,
        cell_cuda,
        cell_cuda3,
        cell_cuda_packed,
        copy_cuda,
        migrate_cuda,
        migrate_cuda3,
        pairwise_cuda,
    )
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts():
        cell_cuda.LAUNCHES = cell_cuda.ENERGY_LAUNCHES = migrate_cuda.LAUNCHES = 0
        cell_cuda_packed.LAUNCHES = cell_cuda_packed.ENERGY_LAUNCHES = migrate_cuda.PACKED_LAUNCHES = 0
        cell_cuda3.LAUNCHES = cell_cuda3.ENERGY_LAUNCHES = cell_cuda3.STATIC_LAUNCHES = 0
        migrate_cuda3.LAUNCHES = migrate_cuda3.FLAT_LAUNCHES = 0
        pairwise_cuda.LAUNCHES = pairwise_cuda.ENERGY_LAUNCHES = 0
        pairwise_cuda.GRAVITY_LAUNCHES = pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES = 0
        copy_cuda.COPY_LAUNCHES = 0

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"torch {torch.__version__}; CUDA {torch.version.cuda}; kernel build {build_s:.2f} s",
          flush=True)

    times, errors, bounds, launches = {}, {}, {}, {}

    # -- 2. 2D kernels vs plain versions at the N=100k shapes -----------------
    cfg = override(
        MDConfig(), n=100_000, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, init="lattice",
        force_impl="grid", compensated=True, eq_steps=2000, prod_steps=2000, sample_every=100,
    )
    md = lj_fluid._make_grid_md(cfg, dev)
    k, gate = lj_fluid._grid_inner_steps(cfg, md)
    state = lj_fluid.init_state(cfg, dev)
    gs = md.init(state.position, state.velocity)
    gs = md.make_production_run(150 * k, k, gate_frac=gate)(gs)
    # 20 steps after the (trailing) rebuild, inside the skin margin: some
    # coordinates drift outside [0, box) and stay unwrapped
    gs = md._make_window(md.force_kernel, 20)(gs)
    occ = gs.occ > 0.5
    unwrapped = int((occ & ((gs.xg < 0) | (gs.xg >= md.box) | (gs.yg < 0) | (gs.yg >= md.box))).sum())
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    print(f"phase 2 grid {tuple(gs.xg.shape)}, n_inner {k}, gate {gate}, "
          f"{unwrapped} particles outside [0, box)", flush=True)

    fk = cell_cuda.grid_force(gs.xg, gs.yg, p)
    fr = cell_cuda.grid_force_reference(gs.xg, gs.yg, p)
    errors["cell_force"] = _max_diff(fk, fr, occ, "B1 forces", 1e-4)
    fmax = float(torch.hypot(fr[0], fr[1])[occ].max())
    ek = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=True)
    er = cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=True)
    err_ef = _max_diff(ek[:2], er[:2], occ, "B1 energy variant forces", 1e-4)
    err_e = _sums_close(ek[2:], er[2:], "B1 energy variant", 1e-5)
    errors["cell_force_energy"] = max(err_ef, err_e)

    _, _, scode, _, _ = md._migration_dest(gs)
    fields = torch.stack([torch.remainder(gs.xg, md.box), torch.remainder(gs.yg, md.box),
                          gs.vxg, gs.vyg, gs.fxg, gs.fyg, gs.pid.float(),
                          gs.crx, gs.cry, gs.cvx, gs.cvy])
    fills = [md.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0]
    movers = int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != 4)).sum())
    if not torch.equal(migrate_cuda.migrate(scode, fields, fills), migrate_cuda.migrate_reference(scode, fields, fills)):
        raise AssertionError("B2: kernel output is not bit-equal to the plain version")
    errors["migrate"] = 0.0

    times["cell_force"] = (_cuda_ms(lambda: cell_cuda.grid_force(gs.xg, gs.yg, p), 50),
                           _cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p), 10))
    times["cell_force_energy"] = (
        _cuda_ms(lambda: cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=True), 50),
        _cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=True), 10))
    times["migrate"] = (_cuda_ms(lambda: migrate_cuda.migrate(scode, fields, fills), 50),
                        _cuda_ms(lambda: migrate_cuda.migrate_reference(scode, fields, fills), 10))
    work2 = _pair_work((gs.xg, gs.yg), gs.occ, md.cps, md.cap, md.box, p.cutoff2)
    bounds["cell_force"], bounds["cell_force_energy"] = _force_bounds(work2, 2, gs.xg.numel())
    bounds["migrate"] = _migrate_bound(fields.shape[0], gs.xg.numel())
    print(f"phase 2 B1 forces: max abs diff {errors['cell_force']:.3e} (max |f| {fmax:.1f}); "
          f"energy variant: forces {err_ef:.3e}, e/w max abs diff {err_e:.3e}, sums within rtol 1e-5; "
          f"B2: bit-equal, {movers} movers; pair work: {work2[0]} distance tests, "
          f"{work2[1]} in the cutoff", flush=True)
    for name in ("cell_force", "cell_force_energy", "migrate"):
        print(f"phase 2 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)

    # -- 3. B1 against the dense oracle ----------------------------------------
    # particles at least cutoff + skin from the seams: neither they nor their
    # partners cross one, so the dense minimum image and the kernel subtract
    # the same float32 coordinates
    fx, fy = md.force_kernel(gs.xg, gs.yg)
    f_part = md.particle_order(gs, fx, fy)
    pos = md.positions(gs)
    margin = cfg.cutoff + md.skin
    interior = torch.nonzero(((pos >= margin) & (pos < md.box - margin)).all(dim=1)).squeeze(1)
    pick = interior[torch.randperm(interior.numel(), generator=torch.Generator().manual_seed(0))[:1024].to(dev)]
    f_dense = LennardJones(box=md.box, cutoff=cfg.cutoff).force(pos, rows=pick)
    err_o = float((f_part[pick] - f_dense).abs().max())
    if not err_o <= 1e-4:
        raise AssertionError(f"B1 vs dense oracle: max abs diff {err_o:.3e} > 1e-4")
    print(f"phase 3 B1 vs dense oracle (1024 particles, from all 100k): max abs diff {err_o:.3e}",
          flush=True)

    # -- 4. a small 2D run on the card against the same run on the CPU --------
    small = override(cfg, n=4096, eq_steps=100, prod_steps=100, sample_every=50)
    hist = {}
    for where in ("cuda", "cpu"):
        s0 = lj_fluid.init_state(small, where)
        s_eq, ovf_eq = lj_fluid.equilibrate(small, s0)
        _, (_, ke, pe), ovf = lj_fluid.production(small, s_eq)
        if bool(ovf_eq) or bool(ovf):
            raise AssertionError(f"small run on {where}: overflow")
        hist[where] = (ke.cpu().double(), pe.cpu().double())
    for a, b, name in zip(hist["cuda"], hist["cpu"], ("ke", "pe")):
        rel = float(((a - b).abs() / b.abs()).max())
        if not rel <= 1e-4:
            raise AssertionError(f"N=4096 {name} history, card vs CPU: rel diff {rel:.3e} > 1e-4")
    print(f"phase 4 N=4096 (R={lj_fluid._make_grid_md(small, dev).rows_per_block}), 200 steps: card and "
          "CPU energy histories agree within rtol 1e-4", flush=True)

    # -- 5. the 2D main path -----------------------------------------------------
    def check_run(res, label: str, c=cfg, drift: bool = True):
        """Overflow False, histories of the right shape and finite, finite
        pressure, and (NVE runs) energy drift < 1e-4."""
        n_samples = c.prod_steps // c.sample_every
        if res.overflow:
            raise AssertionError(f"{label}: capacity/skin overflow flagged")
        if tuple(res.r_history.shape[:2]) != (n_samples, c.n):
            raise AssertionError(f"{label}: r_history shape {tuple(res.r_history.shape)}")
        for name, t in (("r_history", res.r_history), ("ke", res.ke_history), ("pe", res.pe_history),
                        ("g(r)", res.rdf_g)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        if drift and not res.energy_drift < 1e-4:
            raise AssertionError(f"{label}: energy drift {res.energy_drift:.3e} >= 1e-4")
        if not math.isfinite(res.pressure):
            raise AssertionError(f"{label}: non-finite pressure")

    def report_run(res, phase: str, counts: dict, rebuilds: int, c=cfg):
        steps = c.eq_steps + c.prod_steps
        ms_step = 1e3 * (res.time_eq_s + res.time_prod_s) / steps
        print(f"phase {phase} N={c.n}: {ms_step:.4f} ms/step, "
              f"{res.particle_steps_per_sec:.4e} particle-steps/s "
              f"(eq {res.time_eq_s:.3f} s, prod {res.time_prod_s:.3f} s, build+warm-up "
              f"{res.time_compile_s:.3f} s, g(r) {res.time_rdf_s:.3f} s); energy drift "
              f"{res.energy_drift:.3e}; P* {res.pressure:.4f}; kT_eq {res.kt_eq:.4f}; production "
              f"cadence {res.cadence}; rebuilds (migrate launches) {rebuilds}; launches {counts}",
              flush=True)

    reset_counts()
    res = lj_fluid.run(cfg, device="cuda")
    path2 = {"cell_force": cell_cuda.LAUNCHES, "cell_force_energy": cell_cuda.ENERGY_LAUNCHES,
             "migrate": migrate_cuda.LAUNCHES}
    report_run(res, "5 lj_fluid.run", path2, path2["migrate"])
    check_run(res, "2D main path")
    for name, count in path2.items():
        if count <= 0:
            raise AssertionError(f"2D main path never launched kernel {name}")
    launches.update(path2)

    # -- 6. the 3D main path -----------------------------------------------------
    reset_counts()
    cfg3 = override(cfg, dim=3)
    res3 = lj_fluid.run(cfg3, device="cuda")
    path3 = {"cell_force3": cell_cuda3.LAUNCHES, "cell_force3_energy": cell_cuda3.ENERGY_LAUNCHES,
             "cell_force3_static": cell_cuda3.STATIC_LAUNCHES, "migrate3": migrate_cuda3.LAUNCHES}
    report_run(res3, "6 lj_fluid.run dim=3", path3, path3["migrate3"], cfg3)
    check_run(res3, "3D main path", cfg3)
    for name, count in path3.items():
        if count <= 0:
            raise AssertionError(f"3D main path never launched kernel {name}")
    launches.update(path3)

    # -- 7. 3D kernels vs plain versions at the N=100k shapes -----------------
    # 90 steps of the fixed driver from the main path's final state: the
    # last window leaves coordinates unwrapped
    md3 = lj_fluid._make_grid_md(cfg3, dev)
    gs3 = md3.init(res3.state.position, res3.state.velocity)
    gs3 = md3.make_production_run_fixed(90, res3.cadence or 9)(gs3)
    occ3 = gs3.occ > 0.5
    coords3 = (gs3.xg, gs3.yg, gs3.zg)
    unwrapped3 = int((occ3 & torch.stack([(g < 0) | (g >= md3.box) for g in coords3]).any(0)).sum())
    mo, cov = int(gs3.max_occ), md3.static_cov
    p3 = cell_cuda3.CellForce3Params.from_grid(md3.grid_fn)
    print(f"phase 7 3D grid {tuple(gs3.xg.shape)}, skin {md3.skin:.4f}, max occupancy {mo}, B5 bound "
          f"{cov}, {unwrapped3} particles outside [0, box); overflow so far {bool(gs3.overflow)}",
          flush=True)
    if mo > cov:
        raise AssertionError(f"3D state: max occupancy {mo} > B5 bound {cov}; B5 and B4 differ here")

    args3 = (*coords3, p3)
    b4 = cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ)
    r4 = cell_cuda3.grid_force3_reference(*args3, mo)
    errors["cell_force3"] = _max_diff(b4, r4, occ3, "B4 forces", 1e-4)
    b4e = cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ, with_energy=True)
    r4e = cell_cuda3.grid_force3_reference(*args3, mo, with_energy=True)
    err4ef = _max_diff(b4e[:3], r4e[:3], occ3, "B4 energy variant forces", 1e-4)
    err4e = _sums_close(b4e[3:], r4e[3:], "B4 energy variant", 1e-5)
    errors["cell_force3_energy"] = max(err4ef, err4e)
    b5 = cell_cuda3.grid_force3(*args3, static_cov=cov)
    r5 = cell_cuda3.grid_force3_reference(*args3, cov)
    errors["cell_force3_static"] = _max_diff(b5, r5, occ3, "B5 forces", 1e-4)
    err54 = _max_diff(b5, b4, occ3, "B5 vs B4 forces", 1e-4)
    f3max = float(torch.stack(r4).norm(dim=0)[occ3].max())

    _, _, _, scode3, _, _ = md3._migration_dest3(gs3)
    fields3 = torch.stack([torch.remainder(g, md3.box) for g in coords3]
                          + [gs3.vxg, gs3.vyg, gs3.vzg, gs3.fxg, gs3.fyg, gs3.fzg, gs3.pid.float(),
                             gs3.crx, gs3.cry, gs3.crz, gs3.cvx, gs3.cvy, gs3.cvz])
    fills3 = [md3.sentinel] + [0.0] * 8 + [-1.0] + [0.0] * 6
    k_mov = md3.migrate_k_mov
    movers3 = int(((scode3 >= 0) & (torch.div(scode3, md3.cap, rounding_mode="floor") != migrate_cuda3.STAY)).sum())
    m6, mov_of = migrate_cuda3.migrate3(scode3, fields3, fills3, k_mov=k_mov)
    m7, _ = migrate_cuda3.migrate3(scode3, fields3, fills3)
    mr = migrate_cuda3.migrate3_reference(scode3, fields3, fills3)
    for name, got in (("B6", m6), ("B7", m7)):
        if not torch.equal(got, mr):
            raise AssertionError(f"{name}: kernel output is not bit-equal to the plain version")
    if not torch.equal(m6, m7):
        raise AssertionError("B6 and B7 outputs differ")
    errors["migrate3"] = errors["migrate3_flat"] = 0.0

    mo_t = gs3.max_occ
    times["cell_force3"] = (_cuda_ms(lambda: cell_cuda3.grid_force3(*args3, max_occ=mo_t), 50),
                            _cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, mo), 5))
    times["cell_force3_energy"] = (
        _cuda_ms(lambda: cell_cuda3.grid_force3(*args3, max_occ=mo_t, with_energy=True), 50),
        _cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, mo, with_energy=True), 5))
    times["cell_force3_static"] = (_cuda_ms(lambda: cell_cuda3.grid_force3(*args3, static_cov=cov), 50),
                                   _cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, cov), 5))
    times["migrate3"] = (_cuda_ms(lambda: migrate_cuda3.migrate3(scode3, fields3, fills3, k_mov=k_mov), 50),
                         _cuda_ms(lambda: migrate_cuda3.migrate3_reference(scode3, fields3, fills3), 10))
    times["migrate3_flat"] = (_cuda_ms(lambda: migrate_cuda3.migrate3(scode3, fields3, fills3), 50),
                              _cuda_ms(lambda: migrate_cuda3.migrate3_reference(scode3, fields3, fills3), 10))
    work3 = _pair_work(coords3, gs3.occ, md3.cps, mo, md3.box, p3.cutoff2)
    bounds["cell_force3"], bounds["cell_force3_energy"] = _force_bounds(work3, 3, gs3.xg.numel())
    bounds["cell_force3_static"] = bounds["cell_force3"]
    bounds["migrate3"] = bounds["migrate3_flat"] = _migrate_bound(fields3.shape[0], gs3.xg.numel())
    print(f"phase 7 B4 forces: max abs diff {errors['cell_force3']:.3e} (max |f| {f3max:.1f}); "
          f"B4 energy variant: forces {err4ef:.3e}, e/w max abs diff {err4e:.3e}, sums within rtol "
          f"1e-5; B5: vs plain {errors['cell_force3_static']:.3e}, vs B4 {err54:.3e}; B6, B7: "
          f"bit-equal to the plain version and to each other, {movers3} movers, mov_of "
          f"{bool(mov_of)} (k_mov {k_mov}); pair work: {work3[0]} distance tests, {work3[1]} in "
          f"the cutoff", flush=True)
    for name in ("cell_force3", "cell_force3_energy", "cell_force3_static", "migrate3", "migrate3_flat"):
        print(f"phase 7 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
    del b4, r4, b4e, r4e, b5, r5, m6, m7, mr

    # -- 8. B4 against the dense oracle ----------------------------------------
    f3 = md3.forces(gs3.replace(**dict(zip(("fxg", "fyg", "fzg"), md3.force_kernel(*coords3, gs3.max_occ)))))
    pos3 = md3.positions(gs3)
    margin3 = cfg.cutoff + md3.skin
    interior3 = torch.nonzero(((pos3 >= margin3) & (pos3 < md3.box - margin3)).all(dim=1)).squeeze(1)
    pick3 = interior3[torch.randperm(interior3.numel(), generator=torch.Generator().manual_seed(0))[:1024].to(dev)]
    f_dense3 = LennardJones(box=md3.box, cutoff=cfg.cutoff).force(pos3, rows=pick3)
    err_o3 = float((f3[pick3] - f_dense3).abs().max())
    if not err_o3 <= 1e-4:
        raise AssertionError(f"B4 vs dense oracle: max abs diff {err_o3:.3e} > 1e-4")
    print(f"phase 8 B4 vs dense oracle (1024 interior particles, from all 100k): max abs diff "
          f"{err_o3:.3e}", flush=True)

    # -- 9. a small 3D run on the card against the same run on the CPU --------
    small3 = override(cfg3, n=8192, eq_steps=100, prod_steps=100, sample_every=50)
    hist3, flags, cadence3 = {}, {}, None
    for where in ("cuda", "cpu"):
        s0 = lj_fluid.init_state(small3, where)
        s_eq, ovf_eq = lj_fluid.equilibrate(small3, s0)
        if cadence3 is None:  # the card's, so both sides rebuild on the same steps
            cadence3 = lj_fluid.production_cadence(small3, float(temperature(s_eq)))
        _, (_, ke, pe), ovf = lj_fluid.production(small3, s_eq, cadence3)
        flags[where] = (bool(ovf_eq), bool(ovf))
        hist3[where] = (ke.cpu().double(), pe.cpu().double())
    if flags["cuda"] != flags["cpu"]:
        raise AssertionError(f"N=8192 3D overflow flags (eq, prod) differ: card {flags['cuda']}, cpu {flags['cpu']}")
    for a, b, name in zip(hist3["cuda"], hist3["cpu"], ("ke", "pe")):
        rel = float(((a - b).abs() / b.abs()).max())
        if not rel <= 1e-4:
            raise AssertionError(f"N=8192 3D {name} history, card vs CPU: rel diff {rel:.3e} > 1e-4")
    print(f"phase 9 3D N=8192, 200 steps (production cadence {cadence3}): card and CPU energy "
          f"histories agree within rtol 1e-4; overflow flags (eq, prod) {flags['cpu']} on both",
          flush=True)

    # -- 10. the flat migrate (B7) against the compacted one (B6) -------------
    flat_steps, cadence = 198, res3.cadence or 9
    finals = {}
    for compact in (False, True):
        md_m = GridMD3(md3.grid_fn, sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=True,
                       static_cov="auto", migrate_k_mov=k_mov, migrate_compact=compact, device=dev)
        reset_counts()
        finals[compact] = md_m.make_production_run_fixed(flat_steps, cadence)(
            md_m.init(res3.state.position, res3.state.velocity))
        if not compact:
            launches["migrate3_flat"] = migrate_cuda3.FLAT_LAUNCHES
            if migrate_cuda3.FLAT_LAUNCHES <= 0 or migrate_cuda3.LAUNCHES:
                raise AssertionError("the migrate_compact=False run did not rebuild through B7 alone")
    for name in ("xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "occ", "pid",
                 "crx", "cry", "crz", "cvx", "cvy", "cvz", "max_occ", "dmax2"):
        if not torch.equal(getattr(finals[False], name), getattr(finals[True], name)):
            raise AssertionError(f"B7 run vs B6 run: {name} differs")
    print(f"phase 10 {flat_steps} steps at cadence {cadence} from the equilibrated 3D state: "
          f"{launches['migrate3_flat']} B7 launches, final state bit-equal to the B6 run; overflow "
          f"B7 {bool(finals[False].overflow)}, B6 {bool(finals[True].overflow)}", flush=True)

    # -- 11. B8 against its plain version ---------------------------------------
    def check_pairwise(pos, p, label: str, with_energy: bool) -> float:
        """B8 (or its energy variant) against the plain version on ``pos``:
        forces within 1e-4 * max |f|, the energy sum at rtol 1e-5, and two
        launches bit-equal. Returns the max abs difference."""
        got = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
        again = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
        want = pairwise_cuda.lj_force_pairwise_reference(pos, p, with_energy)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two launches on one input are not bit-equal")
        fmax = float(want[0].abs().max())
        err = float((got[0] - want[0]).abs().max())
        if not err <= 1e-4 * fmax:
            raise AssertionError(f"{label}: forces max abs diff {err:.3e} > 1e-4 * {fmax:.3e}")
        if with_energy:
            se, sr = float(got[1].double().sum()), float(want[1].double().sum())
            if not abs(se - sr) <= 1e-5 * abs(sr):
                raise AssertionError(f"{label}: energy sum {se} vs {sr}, beyond rtol 1e-5")
            err = max(err, float((got[1] - want[1]).abs().max()))
        print(f"phase 11 {label}{' energy variant' if with_energy else ''}: max abs diff {err:.3e} "
              f"(max |f| {fmax:.1f}), bit-equal across two launches", flush=True)
        return err

    def melted(c):
        """Positions 100 steps into the melt from ``c``'s lattice start."""
        return lj_fluid.equilibrate(override(c, eq_steps=100), lj_fluid.init_state(c, dev))[0].position

    dense = override(MDConfig(), n=16_384, rho=0.8, kt=1.0, dt=1e-3, cutoff=None, init="lattice",
                     eq_steps=2000, prod_steps=2000, sample_every=100)
    pos_d = melted(dense)
    pp = pairwise_cuda.PairwiseParams(box=dense.box_size)
    errors["pairwise_lj"] = check_pairwise(pos_d, pp, f"B8 N={dense.n} 2D PBC", False)
    errors["pairwise_lj_energy"] = check_pairwise(pos_d, pp, f"B8 N={dense.n} 2D PBC", True)
    dense4 = override(dense, n=4096)
    pos4 = melted(dense4)
    pos4_3d = melted(override(dense4, dim=3))
    for with_energy in (False, True):
        check_pairwise(pos4, pairwise_cuda.PairwiseParams(box=dense4.box_size, cutoff=2.5),
                       f"B8 N={dense4.n} 2D PBC cutoff 2.5", with_energy)
        check_pairwise(pos4_3d, pairwise_cuda.PairwiseParams(), f"B8 N={dense4.n} 3D no box", with_energy)
    times["pairwise_lj"] = (_cuda_ms(lambda: pairwise_cuda.lj_force_pairwise(pos_d, pp), 50),
                            _cuda_ms(lambda: pairwise_cuda.lj_force_pairwise_reference(pos_d, pp), 5))
    times["pairwise_lj_energy"] = (
        _cuda_ms(lambda: pairwise_cuda.lj_force_pairwise(pos_d, pp, True), 50),
        _cuda_ms(lambda: pairwise_cuda.lj_force_pairwise_reference(pos_d, pp, True), 5))
    bounds["pairwise_lj"], bounds["pairwise_lj_energy"] = _pairwise_bounds(dense.n, 2)
    slices, slice_len = pairwise_cuda._slices(dense.n)
    print(f"phase 11 B8 launch at N={dense.n}: {slices} j slices of {slice_len}, "
          f"{pairwise_cuda.THREADS}-thread blocks", flush=True)
    for name in ("pairwise_lj", "pairwise_lj_energy"):
        print(f"phase 11 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)

    # -- 12. the dense main path -------------------------------------------------
    impl_d = lj_fluid.resolve_impl(dense, dev)
    if impl_d != "dense_pallas":
        raise AssertionError(f"N={dense.n} without a cutoff resolves to {impl_d}, not dense_pallas")
    reset_counts()
    resd = lj_fluid.run(dense, device="cuda")
    path_d = {"pairwise_lj": pairwise_cuda.LAUNCHES, "pairwise_lj_energy": pairwise_cuda.ENERGY_LAUNCHES}
    _, d_coef, d_resid = resd.transport()
    steps_d = dense.eq_steps + dense.prod_steps
    print(f"phase 12 lj_fluid.run N={dense.n} ({impl_d}, no cutoff): "
          f"{1e3 * (resd.time_eq_s + resd.time_prod_s) / steps_d:.4f} ms/step, "
          f"{resd.particle_steps_per_sec:.4e} particle-steps/s (eq {resd.time_eq_s:.3f} s, prod "
          f"{resd.time_prod_s:.3f} s, build+warm-up {resd.time_compile_s:.3f} s, g(r) "
          f"{resd.time_rdf_s:.3f} s); energy drift {resd.energy_drift:.3e}; kT_eq {resd.kt_eq:.4f}; "
          f"D* {d_coef:.4e} (fit rms {d_resid:.1e}); P* {resd.pressure}; launches {path_d}", flush=True)
    if resd.overflow:
        raise AssertionError("dense main path: overflow flagged")
    if tuple(resd.r_history.shape) != (dense.prod_steps // dense.sample_every, dense.n, 2):
        raise AssertionError(f"dense main path: r_history shape {tuple(resd.r_history.shape)}")
    for name, t in (("r_history", resd.r_history), ("ke", resd.ke_history), ("pe", resd.pe_history),
                    ("g(r)", resd.rdf_g)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"dense main path: non-finite {name}")
    if not resd.energy_drift < 1e-4:
        raise AssertionError(f"dense main path: energy drift {resd.energy_drift:.3e} >= 1e-4")
    if not math.isnan(resd.pressure):
        raise AssertionError("dense main path: pressure is measured on the grid engine only")
    for name, count in path_d.items():
        if count <= 0:
            raise AssertionError(f"dense main path never launched kernel {name}")
    launches.update(path_d)

    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import profile_device

    os.makedirs("chiprun_out", exist_ok=True)
    traced = override(dense, prod_steps=2 * dense.sample_every)
    dev_s, table = profile_device(lambda: lj_fluid.production(traced, resd.state),
                                  os.path.join("chiprun_out", "chip_smoke_dense_trace.json"))
    busy_ms = 1e3 * dev_s / traced.prod_steps
    wall_ms = 1e3 * resd.time_prod_s / dense.prod_steps
    print(table)
    print(f"phase 12 profile (production, {traced.prod_steps} traced steps): device busy {busy_ms:.4f} "
          f"ms/step of {wall_ms:.4f} ms/step untraced wall; busy share {busy_ms / wall_ms:.3f}, "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)

    # -- 13, 14. dense and list paths on the card against the CPU ---------------
    def card_vs_cpu(small, phase: str) -> None:
        """The same equilibrate + production on the card and on the CPU:
        energies at rtol 1e-4, no overflow on either."""
        hist, impls = {}, {}
        for where in ("cuda", "cpu"):
            impls[where] = lj_fluid.resolve_impl(small, where)
            s_eq, ovf_eq = lj_fluid.equilibrate(small, lj_fluid.init_state(small, where))
            _, (_, ke, pe), ovf = lj_fluid.production(small, s_eq)
            if bool(ovf_eq) or bool(ovf):
                raise AssertionError(f"phase {phase} on {where}: overflow")
            hist[where] = (ke.cpu().double(), pe.cpu().double())
        worst = 0.0
        for a, b, name in zip(hist["cuda"], hist["cpu"], ("ke", "pe")):
            rel = float(((a - b).abs() / b.abs()).max())
            if not rel <= 1e-4:
                raise AssertionError(f"phase {phase} {name} history, card vs CPU: rel diff {rel:.3e} > 1e-4")
            worst = max(worst, rel)
        print(f"phase {phase} N={small.n}, {small.eq_steps + small.prod_steps} steps: card "
              f"({impls['cuda']}) and CPU ({impls['cpu']}) energy histories agree within rtol 1e-4 "
              f"(max rel diff {worst:.2e}); overflow False on both", flush=True)

    card_vs_cpu(override(dense, n=2048, eq_steps=100, prod_steps=100, sample_every=20), "13 dense")
    for impl in ("neighbor", "cell"):
        card_vs_cpu(override(dense, n=4096, cutoff=2.5, force_impl=impl, eq_steps=100, prod_steps=100,
                             sample_every=20), f"14 {impl}")

    # -- 15. 2D kernels at the packed shapes -----------------------------------
    def advanced(c):
        """The grid engine of ``c`` and a state 20 steps after a (trailing)
        rebuild, 150 windows from the lattice: some coordinates outside
        [0, box), unwrapped."""
        m = lj_fluid._make_grid_md(c, dev)
        kk, gg = lj_fluid._grid_inner_steps(c, m)
        st = lj_fluid.init_state(c, dev)
        g = m.make_production_run(150 * kk, kk, gate_frac=gg)(m.init(st.position, st.velocity))
        return m, m._make_window(m.force_kernel, 20)(g)

    cfg16 = override(cfg, n=16_384)
    cfg1m = override(cfg, n=1_000_000)
    packed = {}
    for label, c in (("N=16,384", cfg16), ("N=1M", cfg1m)):
        m, g = advanced(c)
        r = m.rows_per_block
        occ_p = g.occ > 0.5
        pk = cell_cuda.CellForceParams.from_grid(m.grid_fn)
        outside = int((occ_p & ((g.xg < 0) | (g.xg >= m.box) | (g.yg < 0) | (g.yg >= m.box))).sum())
        f1 = cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r)
        f2 = cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r)
        fr = cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r)
        e1 = cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r, with_energy=True)
        e2 = cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r, with_energy=True)
        er = cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r, with_energy=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(f1 + e1, f2 + e2)):
            raise AssertionError(f"B3 {label}: two launches on one input are not bit-equal")
        err_f = _max_diff(f1, fr, occ_p, f"B3 {label} forces", 1e-4)
        err_ef3 = _max_diff(e1[:2], er[:2], occ_p, f"B3 {label} energy variant forces", 1e-4)
        err_e3 = _sums_close(e1[2:], er[2:], f"B3 {label} energy variant", 1e-5)
        t_f = (_cuda_ms(lambda: cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r), 50),
               _cuda_ms(lambda: cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r), 5))
        t_e = (_cuda_ms(lambda: cell_cuda_packed.grid_force_packed(g.xg, g.yg, pk, r, with_energy=True), 50),
               _cuda_ms(lambda: cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r, with_energy=True), 5))
        work_p = _pair_work((cell_cuda_packed.unpack(g.xg, r), cell_cuda_packed.unpack(g.yg, r)),
                            cell_cuda_packed.unpack(g.occ, r), m.cps, m.cap, m.box, pk.cutoff2)
        b_f, b_e = _force_bounds(work_p, 2, g.xg.numel())
        packed[label] = dict(md=m, gs=g, errors=(err_f, max(err_ef3, err_e3)), times=(t_f, t_e), bounds=(b_f, b_e))
        print(f"phase 15 {label}: grid {tuple(g.xg.shape)} (R={r}, G={m.n_blocks}), {outside} particles "
              f"outside [0, box); B3 forces max abs diff {err_f:.3e} (max |f| "
              f"{float(torch.hypot(fr[0], fr[1])[occ_p].max()):.1f}); energy variant: forces {err_ef3:.3e}, "
              f"e/w max abs diff {err_e3:.3e}, sums within rtol 1e-5; two launches bit-equal; pair work: "
              f"{work_p[0]} distance tests, {work_p[1]} in the cutoff", flush=True)
        for name, t, b in (("cell_force_packed", t_f, b_f), ("cell_force_packed_energy", t_e, b_e)):
            print(f"phase 15 {label} time {name}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
                  f"bound {b[0]:.5f} ms ({b[1]}) per call", flush=True)
        del f1, f2, fr, e1, e2, er

    m1, g1 = packed["N=1M"]["md"], packed["N=1M"]["gs"]
    _, _, scode_p, _, _ = m1._migration_dest(g1)
    fields_p = torch.stack([torch.remainder(g1.xg, m1.box), torch.remainder(g1.yg, m1.box),
                            g1.vxg, g1.vyg, g1.fxg, g1.fyg, g1.pid.float(), g1.crx, g1.cry, g1.cvx, g1.cvy])
    r1 = m1.rows_per_block
    sub = torch.div(torch.arange(m1.lanes, device=dev), m1.cps, rounding_mode="floor")
    dxp = torch.div(torch.div(scode_p, m1.cap, rounding_mode="floor"), 3, rounding_mode="floor") - 1
    crossing = int(((scode_p >= 0) & (((dxp == -1) & (sub == 0)) | ((dxp == 1) & (sub == r1 - 1)))).sum())
    if not torch.equal(migrate_cuda.migrate(scode_p, fields_p, fills, r1),
                       migrate_cuda.migrate_reference(scode_p, fields_p, fills, r1)):
        raise AssertionError("B2 packed: kernel output is not bit-equal to the plain version")
    errors["migrate_packed"] = 0.0
    times["migrate_packed"] = (_cuda_ms(lambda: migrate_cuda.migrate(scode_p, fields_p, fills, r1), 50),
                               _cuda_ms(lambda: migrate_cuda.migrate_reference(scode_p, fields_p, fills, r1), 10))
    bounds["migrate_packed"] = _migrate_bound(fields_p.shape[0], g1.xg.numel())
    for i, name in enumerate(("cell_force_packed", "cell_force_packed_energy")):
        errors[name] = packed["N=1M"]["errors"][i]
        times[name] = packed["N=1M"]["times"][i]
        bounds[name] = packed["N=1M"]["bounds"][i]
    print(f"phase 15 B2 packed N=1M (R={r1}): bit-equal, {crossing} movers across a block seam; time "
          f"kernel {times['migrate_packed'][0]:.4f} ms, plain {times['migrate_packed'][1]:.4f} ms, bound "
          f"{bounds['migrate_packed'][0]:.5f} ms ({bounds['migrate_packed'][1]}) per call", flush=True)
    del fields_p, scode_p

    # -- 16. B3 against the dense oracle ----------------------------------------
    m16, g16 = packed["N=16,384"]["md"], packed["N=16,384"]["gs"]
    fx16, fy16 = m16.force_kernel(g16.xg, g16.yg)
    f16 = m16.particle_order(g16, fx16, fy16)
    pos16 = m16.positions(g16)
    margin16 = cfg.cutoff + m16.skin
    inner16 = torch.nonzero(((pos16 >= margin16) & (pos16 < m16.box - margin16)).all(dim=1)).squeeze(1)
    pick16 = inner16[torch.randperm(inner16.numel(), generator=torch.Generator().manual_seed(0))[:1024].to(dev)]
    err_o16 = float((f16[pick16] - LennardJones(box=m16.box, cutoff=cfg.cutoff).force(pos16, rows=pick16)).abs().max())
    if not err_o16 <= 1e-4:
        raise AssertionError(f"B3 vs dense oracle: max abs diff {err_o16:.3e} > 1e-4")
    print(f"phase 16 B3 vs dense oracle (1024 interior particles, from all 16,384): max abs diff "
          f"{err_o16:.3e}", flush=True)
    del packed, m1, g1, g16

    # -- 17. the packed main paths -----------------------------------------------
    for c in (cfg16, cfg1m):
        mp = lj_fluid._make_grid_md(c, dev)
        kp, gp = lj_fluid._grid_inner_steps(c, mp)
        reset_counts()
        resp = lj_fluid.run(c, device="cuda")
        path_p = {"cell_force_packed": cell_cuda_packed.LAUNCHES,
                  "cell_force_packed_energy": cell_cuda_packed.ENERGY_LAUNCHES,
                  "migrate_packed": migrate_cuda.PACKED_LAUNCHES}
        unpacked = (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES, migrate_cuda.LAUNCHES)
        print(f"phase 17 N={c.n}: R={mp.rows_per_block}, G={mp.n_blocks}, grid {mp.grid_shape}, "
              f"{kp}-step windows at gate {gp}", flush=True)
        report_run(resp, "17 lj_fluid.run packed", path_p, path_p["migrate_packed"], c)
        check_run(resp, f"packed main path N={c.n}", c)
        for name, count in path_p.items():
            if count <= 0:
                raise AssertionError(f"packed main path N={c.n} never launched kernel {name}")
        if any(unpacked):
            raise AssertionError(f"packed main path N={c.n} launched B1 / unpacked B2: {unpacked}")
        if c is cfg1m:
            launches.update(path_p)

    traced1m = override(cfg1m, prod_steps=2 * cfg1m.sample_every)
    dev_s1m, table1m = profile_device(lambda: lj_fluid.production(traced1m, resp.state),
                                      os.path.join("chiprun_out", "chip_smoke_1m_trace.json"))
    busy1m = 1e3 * dev_s1m / traced1m.prod_steps
    wall1m = 1e3 * resp.time_prod_s / cfg1m.prod_steps
    print(table1m)
    print(f"phase 17 N=1M profile (production, {traced1m.prod_steps} traced steps): device busy {busy1m:.4f} "
          f"ms/step of {wall1m:.4f} ms/step untraced wall; busy share {busy1m / wall1m:.3f}, idle share "
          f"{1 - busy1m / wall1m:.3f}", flush=True)
    del resp

    # -- 18. the packed engine at N=4096 on the card against the CPU -----------
    small18 = override(cfg, n=4096)
    st18 = lj_fluid.init_state(small18, "cpu")
    gf18 = lj_fluid._make_grid_md(small18, "cpu").grid_fn
    k18, gate18 = lj_fluid._grid_inner_steps(small18, GridMD(gf18, device="cpu"))
    for r18 in (1, 4):
        ens = {}
        for where in ("cuda", "cpu"):
            m18 = GridMD(gf18, dt=small18.dt, compensated=True, rows_per_block=r18, device=where)
            g18 = m18.init(st18.position, st18.velocity)
            g18 = m18.make_production_run(100, k18, gate_frac=gate18)(g18)
            ke18, pe18 = [], []
            for _ in range(2):
                g18 = m18.make_production_run(50, k18, gate_frac=gate18)(g18)
                ke18.append(float(m18.kinetic_energy(g18)))
                pe18.append(float(m18.potential_energy(g18)))
            if bool(g18.overflow):
                raise AssertionError(f"phase 18 R={r18} on {where}: overflow")
            ens[where] = torch.tensor(ke18 + pe18, dtype=torch.float64)
        rel18 = float(((ens["cuda"] - ens["cpu"]).abs() / ens["cpu"].abs()).max())
        if not rel18 <= 1e-4:
            raise AssertionError(f"phase 18 R={r18}: card vs CPU energies rel diff {rel18:.3e} > 1e-4")
        print(f"phase 18 N=4096 engine with rows_per_block={r18} (grid {m18.grid_shape}), 200 steps: card and "
              f"CPU energies agree within rtol 1e-4 (max rel diff {rel18:.2e})", flush=True)

    # -- 19. Langevin ------------------------------------------------------------
    for dim in (2, 3):
        cl = override(cfg, dim=dim, thermostat="langevin", gamma=1.0)
        resl = lj_fluid.run(cl, device="cuda")
        check_run(resl, f"Langevin dim={dim}", cl, drift=False)
        kt_prod = 2.0 * resl.ke_history.double() / (cl.n * dim)
        kt_mean = float(kt_prod.mean())
        if not abs(kt_mean - cl.kt) <= 0.05 * cl.kt:
            raise AssertionError(f"Langevin dim={dim}: mean production kT {kt_mean:.4f} not within 5% of {cl.kt}")
        ml = lj_fluid._make_grid_md(cl, dev)
        kl, gl = lj_fluid._grid_inner_steps(cl, ml)
        gsl = ml.init(resl.state.position, resl.state.velocity, seed=lj_fluid._grid_seed(cl))
        gsl = ml.make_production_run(100, kl, gate_frac=gl, thermostat=lj_fluid._grid_thermostat(cl))(gsl)
        empty = gsl.occ < 0.5
        v_empty = max(float(getattr(gsl, f"v{a}g")[empty].abs().max()) for a in ml.AXES)
        if v_empty != 0.0 or int(gsl.occ.sum()) != cl.n or bool(gsl.overflow):
            raise AssertionError(f"Langevin dim={dim}: empty-slot |v| {v_empty}, {int(gsl.occ.sum())} "
                                 f"particles, overflow {bool(gsl.overflow)}")
        ms_l = 1e3 * (resl.time_eq_s + resl.time_prod_s) / (cl.eq_steps + cl.prod_steps)
        print(f"phase 19 Langevin dim={dim} N={cl.n} (gamma {cl.gamma}): {ms_l:.4f} ms/step, "
              f"{resl.particle_steps_per_sec:.4e} particle-steps/s (eq {resl.time_eq_s:.3f} s, prod "
              f"{resl.time_prod_s:.3f} s); production kT mean {kt_mean:.4f} (min {float(kt_prod.min()):.4f}, "
              f"max {float(kt_prod.max()):.4f}), kT_eq {resl.kt_eq:.4f}, P* {resl.pressure:.4f}; "
              f"after 100 more steps: empty-slot |v| max {v_empty}, {int(gsl.occ.sum())} particles", flush=True)

    # -- 20. B9 through its factory ----------------------------------------------
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.gravity import Gravity

    rng = np.random.default_rng(2020)
    library = {}
    for dim, n, tag in ((2, 16_384, ""), (3, 65_536, "3")):
        pos_g = torch.from_numpy((rng.standard_normal((n, dim)) * 10.0).astype(np.float32)).to(dev)
        m_g = torch.from_numpy((0.5 + rng.random(n)).astype(np.float32)).to(dev)
        accel = pairwise_cuda.make_gravity_accel_pairwise(n, g=1.0, softening=0.1)
        accel_phi = pairwise_cuda.make_gravity_accel_pairwise(n, g=1.0, softening=0.1, with_potential=True)
        reset_counts()
        a_k = accel(pos_g, m_g)
        a_kp, phi_k = accel_phi(pos_g, m_g)
        torch.cuda.synchronize()
        names = (f"pairwise_gravity{tag}", f"pairwise_gravity{tag}_potential")
        launches[names[0]] = pairwise_cuda.GRAVITY_LAUNCHES
        launches[names[1]] = pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES
        if min(launches[names[0]], launches[names[1]]) <= 0:
            raise AssertionError(f"B9 N={n}: the factory did not launch the kernel")
        if not (torch.equal(a_k, accel(pos_g, m_g)) and torch.equal(phi_k, accel_phi(pos_g, m_g)[1])):
            raise AssertionError(f"B9 N={n}: two launches on one input are not bit-equal")
        a_r, phi_r = pairwise_cuda.gravity_accel_pairwise_reference(pos_g, m_g, 1.0, 0.1, True)
        errs = []
        for label, got, want in (("a", a_k, a_r), ("a (potential variant)", a_kp, a_r), ("phi", phi_k, phi_r)):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"B9 N={n} {label}: max abs diff {err:.3e} > 1e-5 * {scale:.3e}")
            errs.append(err / scale)
        errors[names[0]], errors[names[1]] = float((a_k - a_r).abs().max()), max(
            float((a_kp - a_r).abs().max()), float((phi_k - phi_r).abs().max()))
        energy_s = ""
        if n == 16_384:
            e_k = 0.5 * float(torch.sum(m_g.double() * phi_k.double()))
            e_ref = float(Gravity(g=1.0, mode="plummer", softening=0.1).energy(pos_g.double(), m_g.double()))
            if not abs(e_k - e_ref) <= 1e-5 * abs(e_ref):
                raise AssertionError(f"B9 N={n}: 0.5 sum(m phi) {e_k} vs Gravity.energy {e_ref}, beyond rtol 1e-5")
            energy_s = f"; 0.5 sum(m phi) {e_k:.6e} vs Gravity.energy {e_ref:.6e} (rel {abs(e_k - e_ref) / abs(e_ref):.2e})"
        times[names[0]] = (_cuda_ms(lambda: accel(pos_g, m_g), 20),
                           _cuda_ms(lambda: pairwise_cuda.gravity_accel_pairwise_reference(pos_g, m_g, 1.0, 0.1), 3))
        times[names[1]] = (_cuda_ms(lambda: accel_phi(pos_g, m_g), 20),
                           _cuda_ms(lambda: pairwise_cuda.gravity_accel_pairwise_reference(pos_g, m_g, 1.0, 0.1, True), 3))
        bounds[names[0]], bounds[names[1]] = _gravity_bounds(n, dim)
        print(f"phase 20 B9 N={n} {dim}D: launches {launches[names[0]]} + {launches[names[1]]} (potential); "
              f"a, a (potential variant), phi max abs diff / max |.|: {errs[0]:.2e}, {errs[1]:.2e}, "
              f"{errs[2]:.2e}; two launches bit-equal{energy_s}", flush=True)
        for name in names:
            print(f"phase 20 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
                  f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
        del pos_g, m_g, a_k, a_kp, phi_k, a_r, phi_r
    torch.cuda.empty_cache()

    # -- 21. B10 through make_bandwidth_op, alone and under the timed loop -----
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench import ops as bench_ops
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench import runners
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import BenchConfig

    for dtype, n_el, name in ((torch.float32, 64 << 20, "copy"), (torch.bfloat16, 128 << 20, "copy_bf16")):
        gen = torch.Generator(device=dev).manual_seed(21)
        src = torch.randn(n_el, generator=gen, device=dev).to(dtype)
        op = bench_ops.make_bandwidth_op(n_el, dtype=dtype, mode="pallas_copy")
        out = op(src)
        if op.n_elems != n_el or not torch.equal(out, src):
            raise AssertionError(f"B10 {dtype}: the copy is not bit-equal to its source")
        errors[name] = float((out.float() - src.float()).abs().max())
        dst = torch.empty_like(src)
        times[name] = (_cuda_ms(lambda: copy_cuda.chunked_copy(src), 20),
                       _cuda_ms(lambda: copy_cuda.copy_reference(src), 20))
        library[name] = _cuda_ms(lambda: dst.copy_(src), 20)
        bounds[name] = _bound(0.0, op.bytes_per_call)  # each byte read once and written once
        ctx = runners.BenchContext(BenchConfig(warmup=1, repeats=2, steps=20), print, dev)
        reset_counts()
        avg = runners._timed_loop(ctx, op, (src,), 1, chain="direct")
        launches[name] = copy_cuda.COPY_LAUNCHES
        if launches[name] <= 0:
            raise AssertionError(f"B10 {dtype}: the timed loop did not launch the kernel")
        print(f"phase 21 B10 {dtype} {n_el} elements ({op.bytes_per_call // 2 >> 20} MiB): bit-equal; "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, dst.copy_ "
              f"{library[name]:.4f} ms, bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call; "
              f"_timed_loop (direct, 20 steps): {avg * 1e3:.4f} ms a copy, "
              f"{op.bytes_per_call / avg / 2**30:.1f} GiB/s, {launches[name]} launches", flush=True)
        del src, dst, out
    torch.cuda.empty_cache()

    # -- 22. the op suite ---------------------------------------------------------
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.isolate import run_sweep_isolated

    sweep = dict(warmup=1, repeats=2, steps=20, matrix_size=4096, matrix_depth=6, conv_size=128,
                 batch_size=64, conv_cin=32, conv_cout=64)
    peak_gibs = PEAK_HBM_BYTES / 2**30
    for precision, peak in (("float32", PEAK_FP32_FLOPS), ("bfloat16", PEAK_BF16_FLOPS)):
        t22 = time.perf_counter()
        rows = runners.run_sweep(BenchConfig(precision=precision, **sweep), log=lambda m: None, device=dev)
        if [r["test"] for r in rows] != [name for name, _ in runners.ALL_BENCHMARKS]:
            raise AssertionError(f"sweep {precision}: rows {[r['test'] for r in rows]}")
        for r in rows:
            rate, limit = (r["tflops"], peak / 1e12) if "tflops" in r else (r["bandwidth_gbs"], peak_gibs)
            if "error" in r or not (math.isfinite(rate) and 0 < rate < limit):
                raise AssertionError(f"sweep {precision} {r['test']}: {r} (limit {limit:.1f})")
            unit = "TFLOPS" if "tflops" in r else "GiB/s"
            print(f"phase 22 sweep {precision} {r['test']}: {r['avg_ms']:.4f} ms, {rate:.2f} {unit}", flush=True)
        print(f"phase 22 sweep {precision}: six rows in {time.perf_counter() - t22:.1f} s", flush=True)
        torch.cuda.empty_cache()
    rows_i, info_i, _ = run_sweep_isolated(BenchConfig(**{**sweep, "steps": 5}, ops=("2D", "Bandwidth")),
                                           log=lambda m: None, device="cuda")
    if [r["test"] for r in rows_i] != ["2D", "Bandwidth"] or any("error" in r for r in rows_i):
        raise AssertionError(f"isolated sweep rows: {rows_i}")
    print(f"phase 22 isolated sweep (worker on {info_i.get('device_kind')}, float32 matmul precision "
          f"{info_i.get('float32_matmul_precision')}): "
          + "; ".join(f"{r['test']} {r['avg_ms']:.4f} ms" for r in rows_i), flush=True)

    # -- 23. the n-body main path -------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import NBodyConfig
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import nbody_merger as nb
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators import rk4_step_fn
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators_adaptive import dopri5_integrate

    cfg_nb = NBodyConfig()
    reset_counts()
    res_nb = nb.run(cfg_nb, device="cuda")
    ys_nb = res_nb.trajectory_flat
    if tuple(ys_nb.shape) != (cfg_nb.num_steps + 1, 4 * cfg_nb.n_bodies) or not bool(torch.isfinite(ys_nb).all()):
        raise AssertionError(f"n-body: trajectory {tuple(ys_nb.shape)} not finite or of the wrong shape")
    if not bool(torch.isfinite(res_nb.h_plus).all()) or not (math.isfinite(res_nb.lyapunov) and res_nb.lyapunov > 0):
        raise AssertionError(f"n-body: h_plus finite {bool(torch.isfinite(res_nb.h_plus).all())}, "
                             f"Lyapunov {res_nb.lyapunov}")
    cpu300 = override(cfg_nb, num_steps=300, sim_time=cfg_nb.sim_time * 300 / cfg_nb.num_steps)
    ys_cpu = nb.simulate(cpu300, nb.init_state_flat(cpu300, "cpu"), torch.tensor(cpu300.masses)).double()
    ys_card = ys_nb[:301].cpu().double()
    margin = 0.0
    for sl in (slice(0, 2 * cfg_nb.n_bodies), slice(2 * cfg_nb.n_bodies, None)):
        a, b = ys_card[:, sl], ys_cpu[:, sl]
        atol = 1e-5 * float(b.abs().max())
        # the largest share of the allowed difference rtol * |b| + atol used
        margin = max(margin, float(((a - b).abs() / (1e-5 * b.abs() + atol)).max()))
    if not margin <= 1.0:
        raise AssertionError(f"n-body first 300 steps, card vs CPU: {margin:.3f} of the rtol 1e-5 allowance")
    masses_nb = torch.tensor(cfg_nb.masses, device=dev)
    y0_nb = nb.init_state_flat(cfg_nb, dev)
    step_nb = rk4_step_fn(nb.make_ode(cfg_nb, masses_nb), cfg_nb.sim_time / cfg_nb.num_steps)
    y_nb = step_nb(y0_nb, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            y_nb = step_nb(y_nb, 0.0)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ms_rk4 = 1e3 * res_nb.sim_wall_s / cfg_nb.num_steps
    print(f"phase 23 nbody_merger.run (default: 3 bodies, {cfg_nb.num_steps} RK4 steps): "
          f"simulation {res_nb.sim_wall_s * 1e3:.2f} ms = {ms_rk4:.4f} ms per RK4 step "
          f"({len(dev_events) / 10:.0f} device ops and {sum(e.self_device_time_total for e in dev_events) / 10:.1f} us "
          f"device time a step, traced); tangent Lyapunov {res_nb.lyapunov:.6f}; max |h_+| "
          f"{float(res_nb.h_plus.abs().max()):.4e}; first 300 steps vs CPU: {margin:.4f} of the rtol 1e-5 "
          f"allowance used", flush=True)
    t23 = time.perf_counter()
    d5 = dopri5_integrate(nb.make_ode(cfg_nb, masses_nb), y0_nb, nb.time_grid(cfg_nb, dev),
                          rtol=cfg_nb.rtol, atol=cfg_nb.atol)
    torch.cuda.synchronize()
    t_d5 = time.perf_counter() - t23
    if d5.steps_exceeded or not bool(torch.isfinite(d5.ys).all()):
        raise AssertionError(f"n-body dopri5: steps_exceeded {d5.steps_exceeded}")
    lam2 = float(nb.lyapunov(override(cfg_nb, lyapunov_method="two_trajectory"), y0_nb, masses_nb, d0=1e-2))
    if not (math.isfinite(lam2) and (lam2 > 0) == (res_nb.lyapunov > 0)):
        raise AssertionError(f"n-body two-trajectory estimate {lam2} against tangent {res_nb.lyapunov}")
    print(f"phase 23 dopri5 (rtol {cfg_nb.rtol}, atol {cfg_nb.atol}): {d5.steps_taken} attempts, "
          f"{d5.ode_evals} ODE evaluations, steps_exceeded False, {t_d5:.3f} s "
          f"({1e3 * t_d5 / d5.steps_taken:.4f} ms an attempt, one host read each); two-trajectory "
          f"Lyapunov (d0 1e-2) {lam2:.6f}, the tangent one's sign", flush=True)
    # the full-length tangent estimate on the CPU, and on the card with y0[0]
    # one float32 ulp up and down: how far roundoff alone moves it
    t23 = time.perf_counter()
    lam_cpu = float(nb.lyapunov(cfg_nb, nb.init_state_flat(cfg_nb, "cpu"), torch.tensor(cfg_nb.masses)))
    t_cpu = time.perf_counter() - t23
    lam_ulp = []
    for toward in (math.inf, -math.inf):
        y_ulp = y0_nb.clone()
        y_ulp[0] = torch.nextafter(y_ulp[0], torch.tensor(toward, device=dev))
        lam_ulp.append(float(nb.lyapunov(cfg_nb, y_ulp, masses_nb)))
    if not all(math.isfinite(v) for v in (lam_cpu, *lam_ulp)):
        raise AssertionError(f"n-body tangent Lyapunov: CPU {lam_cpu}, one ulp up and down {lam_ulp}")
    print(f"phase 23 tangent Lyapunov over all {cfg_nb.num_steps} steps: card {res_nb.lyapunov:.6f}, CPU "
          f"{lam_cpu:.6f} ({t_cpu:.1f} s); card with y0[0] one ulp up {lam_ulp[0]:.6f}, one ulp down "
          f"{lam_ulp[1]:.6f}", flush=True)

    # -- 24. result --------------------------------------------------------------
    root = "jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc/"
    ref = "jax_tpus_benchmark_physics_simulation_tpu/"
    kref = ref + "ops/kernels/"
    meta = {
        "cell_force": ("cell_force.cu", kref + "cell_pallas.py:82"),
        "cell_force_energy": ("cell_force.cu", kref + "cell_pallas.py:82"),
        "migrate": ("migrate.cu", kref + "migrate_pallas.py:80"),
        "cell_force_packed": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        "cell_force_packed_energy": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        "migrate_packed": ("migrate.cu", kref + "migrate_pallas.py:80"),
        "cell_force3": ("cell_force3.cu", kref + "cell_pallas3.py:99"),
        "cell_force3_energy": ("cell_force3.cu", kref + "cell_pallas3.py:99"),
        "cell_force3_static": ("cell_force3.cu", kref + "cell_pallas3.py:336"),
        "migrate3": ("migrate3.cu", kref + "migrate_pallas3.py:158"),
        "migrate3_flat": ("migrate3.cu", kref + "migrate_pallas3.py:94"),
        "pairwise_lj": ("pairwise_lj.cu", kref + "pairwise_pallas.py:48"),
        "pairwise_lj_energy": ("pairwise_lj.cu", kref + "pairwise_pallas.py:48"),
        "pairwise_gravity": ("pairwise_gravity.cu", kref + "pairwise_pallas.py:196"),
        "pairwise_gravity_potential": ("pairwise_gravity.cu", kref + "pairwise_pallas.py:196"),
        "pairwise_gravity3": ("pairwise_gravity.cu", kref + "pairwise_pallas.py:196"),
        "pairwise_gravity3_potential": ("pairwise_gravity.cu", kref + "pairwise_pallas.py:196"),
        "copy": ("copy.cu", ref + "bench/ops.py:71"),
        "copy_bf16": ("copy.cu", ref + "bench/ops.py:71"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": root + src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name, (src, tpu) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
