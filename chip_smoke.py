"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the repository root. It builds the CUDA kernels from
``jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc`` (one
``nvcc`` per source, all at once), then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, the kernel build time and each kernel's registers a
   thread and spill bytes from the build log (``-Xptxas -v``), and whether
   this run built the library or loaded an earlier build of the same
   sources;
2. 2D kernels at the N=100k shapes (121 x 16 x 121 grid) on a state whose
   positions are unwrapped near the seams, each against its plain PyTorch
   version: B1 (the tile kernel) forces (max abs diff <= 1e-4 over occupied
   slots), B1 energy variant (e and w sums at rtol 1e-5), B2 (one launch:
   fill and scatter; the 11 planes where they lie and the allocation's
   occupancy, as the engine passes them) bit-equal, also on an overflow
   state (a cell crowded past its capacity), and so is the previous B2
   design (stack, fill, scatter; ``tests/torch_migrate_designs.py``);
   B1 in both variants torch.equal to B1's loop and over two launches;
   timed with CUDA events, B1 and its energy variant in 7 interleaved
   repeats beside B1's loop and at candidate tiles (the default tile and
   block size printed), B2 in 7 interleaved repeats behind a spin of the
   card beside the previous design, its stack, fill and scatter, and each
   wrapper's host us a call;
3. B1 forces on 1024 particles against the dense O(N^2) oracle computed
   from all 100k particles (atol 1e-4);
4. a 2D run at N=4096 on the card against the same run on the CPU (the
   plain versions), energies at rtol 1e-4;
5. the 2D main path, ``lj_fluid.run`` at N=100k (rho 0.8, cutoff 2.5,
   dt 1e-3, lattice init, Kahan on, 2000 + 2000 steps), with every launch
   counter set to 0 just before: overflow False, finite energies, energy
   drift < 1e-4, and B1, B1-energy, B2 and the fused leapfrog pass
   (``leapfrog_cuda``) launched and B1's loop not, and A1 (the
   allocation's kernels, ``alloc_cuda``) once a rebuild; then
   the card's busy share over 200 traced production steps and B1's share
   of device time; then one rebuild under the profiler: its device ops by
   name and count, one B2 launch (``migrate_kernel``) and no fill or
   scatter kernel, beside the same rebuild on the previous B2 design;
6. the 3D main path, ``lj_fluid.run`` with ``dim=3`` at N=100k (the same
   configuration; skin 0.1316, 19 cells per side, fixed production
   cadence from the measured kT), with every counter set to 0 just before:
   overflow False, finite histories, drift < 1e-4, finite P*, and B4,
   B4-energy, B5 (the counted kernel), B6, the fused leapfrog pass, the
   partner list's build and the list form of the counted kernel launched
   and B4's and B5's full loops not, and A1 once a rebuild; then the card's busy share over 200 traced production
   steps and the counted kernel's (B5 and B4) share of device time; then
   one rebuild under the profiler: its device ops by name and count, one
   B6 launch (``migrate3_kernel``) and no call of the plain mover flag;
7. 3D kernels at the N=100k shapes (19 x 32 x 361 grid) on a state 90
   steps from the main path's final one, some coordinates outside
   [0, box), max occupancy within B5's bound: B4 and B5 forces against
   their plain versions (<= 1e-4 over occupied slots), B4's energy variant
   (forces <= 1e-4, e and w sums at rtol 1e-5), B5 (the counted kernel)
   torch.equal to B5's full loop and B4 (the counted kernel at the
   capacity's shared memory, bound ``max_occ`` read on the card)
   torch.equal to B4's loop, both variants and over two launches, and B4
   torch.equal to B5 there; on the melt 90 steps from the lattice at the
   same N (fullest cell above B5's bound: the hybrid windows run B4), B4
   in both variants torch.equal to B4's loop, over two launches and at the
   full capacity, within 1e-4 of the plain version; the partner list at
   B5 and at B4 on the first state: the build kernel against its plain
   version (counts, entries, targets marked full), the list form
   torch.equal to the counted kernel and over two launches and within
   1e-4 of its plain version; B6 and B7 (one launch
   each: fill, scatter, flag) on the planes where they lie, and the
   previous design (fill + scatter + plain flag,
   ``tests/torch_migrate3_designs.py``), bit-equal to the plain version
   with the plain flag, and B6 on the N=8192 lattice start at k_mov 8,
   where the flag trips; timed with CUDA events in 7 interleaved repeats,
   each call queued behind a spin of the card: B4 and its energy variant
   beside B4's loop and B5 on both states (B4 also at the full capacity on
   the melt), B6 and B7 beside the previous design, B5 and its energy
   variant beside B5's full loop and at the strip widths ceil(19 / k),
   the list form and the build at B5 and B4 beside the counted kernel,
   k = 1 to 4; L1, the fused leapfrog pass (``leapfrog_cuda``), on the
   same state as in phase 15;
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
    box; timed with CUDA events at N=16,384 (its launch geometry printed);
12. the dense main path, ``lj_fluid.run`` at N=16,384 with no cutoff
    (rho 0.8, dt 1e-3, lattice init, 2000 + 2000 steps, ``force_impl``
    auto, which resolves to ``dense_pallas``), with every counter set to 0
    just before: overflow False, finite histories and g(r), drift < 1e-4,
    pressure NaN (as in the JAX package), B8 and its energy variant
    launched; then the card's busy share over 200 traced production steps
    and B8's share of device time (``torch.profiler``, trace in
    ``chiprun_out/``);
13. a dense run at N=2048 with no cutoff (100 + 100 steps), auto on both
    sides (B8 on the card, ``dense_xla`` on the CPU): energies at rtol 1e-4;
14. the list paths, ``neighbor`` and ``cell`` at N=4096 with cutoff 2.5
    (100 + 100 steps), card against CPU: energies at rtol 1e-4, overflow
    False on both;
15. 2D kernels at the packed shapes, on states 20 steps after a rebuild
    (coordinates unwrapped near the seams, block-crossing rows included):
    B3 at N=16,384 (cutoff 2.5: 49 cells per side, R=49, grid 1 x 16 x
    2401) and at N=1M (385 cells per side, R=7, grid 55 x 16 x 2695), with
    the state's count grid: both variants torch.equal to B1's loop on the
    unpacked grids (packed back) and over two launches, and within 1e-4 of
    the plain version over occupied slots (the energy variant's e and w
    sums at rtol 1e-5); B3 and B1's loop on the unpacked grids timed in 7
    interleaved repeats (median, min, max); B3's partner list at both
    shapes: its build against its plain version, the list form torch.equal
    to B3 and over two launches and within 1e-4 of its plain version, the
    list form, its build and B3 timed in 7 interleaved repeats (kernels-line
    rows ``cell_force_list`` and ``cell_list_build``, each with its bound,
    N=16,384's numbers among their extra keys); packed B2 at both shapes as in
    phase 2 (bit-equal, also at overflow, and at N=1M with movers across a
    block seam; timed beside the previous design), and one N=1M rebuild's
    device ops with B2 and with the previous design; L1 (the fused
    leapfrog pass, ``leapfrog_cuda``) on the N=1M state: the fused window
    at 1, 4 and 7 steps torch.equal to the eager window
    (``tests/torch_window_eager.py``) in every field it writes, ``dmax2``,
    ``overflow`` and ``time``, the state it was given unchanged; its
    step, first-step and closing launches timed in 7 interleaved repeats
    beside the eager passes of the same updates, each with its byte bound
    (22, 18 and 10 planes; ``tests/torch_leapfrog_designs.launch_times``);
16. B3 forces on 1024 interior particles of the N=16,384 packed state
    against the dense oracle computed from all 16,384 (atol 1e-4);
17. the packed main paths, ``lj_fluid.run`` at N=16,384 and at N=1M with
    cutoff 2.5 (rho 0.8, dt 1e-3, lattice init, Kahan on, 2000 + 2000
    steps), every counter set to 0 just before each: overflow False,
    finite histories, drift < 1e-4, B3, B3-energy, packed B2, B3's list
    form and its build launched, no partner-list overflow, and B1 and
    unpacked B2 not; at N=16,384 the same run again with the partner list
    off (B3's counted loop every step), its ms/step beside the first's; at
    N=1M also its ms/step, the card's busy
    share over 200 traced production steps and B3's share of device time;
18. the grid engine at N=4096 (cutoff 2.5; phase 4 runs it at its default
    R=24) with ``rows_per_block`` 1 (B1, the tile kernel; its loop not
    launched) and 4 (G=6): 100 + 100 steps on the card against the same on
    the CPU, energies at rtol 1e-4;
19. ``lj_fluid.run`` with the Langevin thermostat (gamma 1.0) at N=100k in
    2D and 3D (2000 + 2000 steps): overflow False, the mean kinetic
    temperature of the production samples within 5% of kT, the noise
    kernel launched once a Langevin step of the run, and after 100 more
    Langevin steps (one noise launch each, the state's global step 100 on)
    every empty slot's velocity exactly 0; in both runs one launch of the
    fused BAOAB pass (``baoab_cuda``) a Langevin step beside the noise
    launch, and on the last state the fused window at 1 and 4 steps
    torch.equal to the eager Langevin window
    (``tests/torch_window_eager.eager_langevin_window``), the state it was
    given unchanged, its step launch timed beside the eager passes of the
    same updates (bound: 30 planes in 3D); then the noise kernel at
    ``lj2d-nvt-n1m``'s grid (N=1M, 55 x 16 x 2695 slots) on the lattice
    start's ids, after 200 Langevin steps across the global step 2^32 (one
    launch a step): within 4 float32 ulps of the plain version on the CPU,
    exact zeros on the empty slots, timed in 7 interleaved repeats beside
    the plain version on the card and the per-window ``torch.randn`` draw
    it replaced; there, too, one BAOAB step launch a Langevin step, the
    fused window torch.equal to the eager one, and the step launch timed
    beside the eager step's passes (bound: 20 planes of the 2.37M slots in
    2D, 189.7 MB; kernels-line row ``baoab_step``); no BAOAB kernel spills;
20. B9 (all-pairs softened gravity) through ``make_gravity_accel_pairwise``
    at N=16,384 in 2D and N=65,536 in 3D (positions normal * 10, masses
    0.5 + U(0, 1) from a numpy seed, softening 0.1, g 1), with and without
    the potential, every counter set to 0 just before: acceleration and phi
    within 1e-5 * max |.| of the plain version, two launches bit-equal, and
    at N=16,384 0.5 * sum(m * phi) against ``Gravity(mode="plummer")
    .energy`` at rtol 1e-5; the previous B9 design
    (``tests/torch_gravity_designs.py``) within the same tolerance; both
    variants timed in 7 interleaved repeats beside the previous design, and
    the special-function unit's time for one rsqrt a pair printed;
21. B10 (the bandwidth op's copy) through ``make_bandwidth_op(mode=
    "pallas_copy")`` at 64Mi float32 and 128Mi bfloat16 elements (256 MiB
    each): bit-equal to the source, and on direct calls of odd sizes (3
    blocks of 16 KB + 1001 vectors + 4 bytes, 3.5 blocks an SM + 4 bytes);
    B10 and ``dst.copy_(src)`` timed in 7 interleaved repeats (median, min,
    max), and the plain version
    (``clone``); then B10 under ``runners._timed_loop`` (chain ``direct``,
    20 steps), with every counter set to 0 just before, and its GiB/s;
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
24. the 2D halo kernels at N=97,044 (``scaling._round_to_divisible_n``
    of 100k for devices [1, 2, 4]: 120 cells per side, R=1) on a state 20
    steps after a rebuild: over 1, 2 and 4 row blocks with the halo rows
    (the x seam added as the exchange adds it), B1 halo (the tile kernel,
    both variants, on the ``(rows + 2)`` grids and on the local grids with
    the edge rows) bit-equal to B1 on the whole grid and to B1 halo's loop,
    and over 1, 2, 3 and 4 row blocks B2 halo, on the rebuild's inputs and
    at overflow, bit-equal to B2 on the whole grid, to its plain halo
    version and to the previous design; B1 halo within 1e-4 of its plain
    version; timed at one rank's shape (world size 1: 122 rows in, 120 out)
    beside B1 and B2, B1 halo in 7 interleaved repeats beside its loop, B2
    halo in 7 interleaved repeats behind a spin beside the previous design
    and its fill and scatter;
25. the 3D halo kernels at N=100k rounded for devices [1, 2] (the skin
    rounded to 2 devices: 18 cells per side) on a state 90 steps into the
    melt: over 1, 2 and 3 x-row blocks B4 halo (both variants), B5 halo
    (the counted kernel, both variants) and B6 halo (and the previous
    design) bit-equal
    to the whole-grid kernels, B4 halo and B5 halo also to their loops'
    halo forms, B6 halo's mover flag where B6 raises it, and within 1e-4
    of their plain versions; timed at one rank's shape in 7 interleaved
    repeats behind a spin of the card: B4 halo (both variants) beside its
    loop, B6 halo beside the previous design, beside the whole-grid B4, B5
    and B6, and B5 halo beside its full loop and at the strip widths
    ceil(18 / k), k = 1 to 4;
26. the row-sharded engines on the card: an NCCL process group of world
    size 1 from an in-process store, then ``lj_fluid.run`` (2000 + 2000
    steps) on ``ShardedGridMD`` at the 2D N of phase 24 and on
    ``ShardedGridMD3`` (hybrid B5/B4 halo windows, lj_fluid's k_mov 16, as
    ``mdscale`` builds it too) at the 3D N of phase 25, every counter set to 0 just before each: overflow False,
    finite histories and P*, drift < 1e-4, every halo kernel launched and
    no whole-grid kernel; then the unsharded engine at the same N (its
    ms/step printed beside the sharded one's) and 50 steps of trajectory
    parity at ``scaling._check_parity``'s rtol = atol = 2e-4, and what an
    all-reduce on the group and one step's edge-row exchange cost each (in
    2D with the ``(rows + 2)`` copies the 3D engine makes and without them,
    as the 2D engine's force takes the edge rows); the 2D engine's busy
    share over 200 traced production steps and B1 halo's share of device
    time, and one rebuild under the profiler (one B2 halo launch, beside
    the previous design's ops); for the 3D engine one rebuild under the
    profiler (one B6 halo launch, no plain mover flag), a rebuild's exchange of the code and
    field edge rows with the stack and the ``(rows + 2)`` copies that B6
    halo reads, its busy share and the counted
    kernel's share of device time, and its mover flag at 18 cells per side
    (False); the group is destroyed at the end;
27. ``em3`` (``models/em_three_particles.run``) in the default
    configuration (3 particles, 1000 steps, dt 0.01, float32) with each
    integrator (Boris and the reference's): finite ``(1001, 3, 2)``
    trajectories; the first 50 steps against the same run on the CPU at
    rtol 1e-4, atol 1e-5 (JAX's ``tests/test_em3.py``); all 1000 steps in
    float64 against the CPU's at ``tests/test_torch_em3.py``'s measured
    tolerances; the timed run's ms and ms a step, the device ops a step
    (``utils/profiling.device_op_count``) and the busy share over 100
    traced steps (no custom kernel: three particles are launch latency);
28. ``vmc`` (``models/quantum_oscillator.run``) at full width (10,000
    walkers, dim 3, ``n_equil`` 100, step 2.0, lr 0.02; DMC 500 steps at dt
    0.01), only the depth cut (300 epochs instead of 3000), then DMC again
    from the VMC ensemble with the multinomial resampler: |alpha - 0.5|,
    |E_VMC - 1.5| and each DMC mean after burn-in 100 within 0.05 of 1.5
    (JAX's ``tests/test_mc.py`` bounds); the anharmonic model at dim 1
    (``tests/test_mc.py``'s configuration) within 2e-2 (VMC) and 1e-2 (DMC)
    of its diagonalization oracle; card against CPU at draws made on the
    CPU (rtol 1e-6): both models' local energies, ``metropolis_update``
    (accepts away from near-ties), both resamplers (indices away from
    near-ties of a comb point and a CDF step), one Adam update, one DMC
    step with each resampler; ms a sweep, an epoch and a DMC step, device
    ops a sweep, the busy share of an epoch and of DMC steps, and the
    default 3000 epochs' time worked out from the ms an epoch;
29. A1, the rebuild's allocation as three kernel passes (``alloc_cuda``),
    at both benchmark cells' states (``port_bench``'s adapter from a seed:
    ``lj2d-n1m``, N=1M packed at R=7, and ``lj3d-inlj-2m``, in.lj's
    2,048,000 atoms; ``tests/torch_alloc_designs.cell_report``): torch.equal
    to the eager allocation in every output after 1, 4 and 6 steps of a
    window and with its edge cases planted (overflow raised there only),
    timed in 7 interleaved repeats beside the eager allocation, with its
    byte bound, the device ops of one allocation, and its launches over one
    production block, one a rebuild;
30. prints a JSON line with each kernel's launches on its main path,
    error, times, and bound (the larger of the operations over the card's
    float32 peak and the bytes over its memory rate, counted on this run's
    inputs), B3's with ``full_capacity_ms`` (B1's loop on the unpacked
    grids), B1's and B1 halo's four rows with ``loop_ms`` (B1's loop, which
    no path runs, its launches in ``loop_launches``) and ``tile``, B5's and
    B5 halo's with ``loop_ms`` (B5's full loop, which no path runs) and
    ``strip``, B2's three forms with the previous design's times (whole,
    fill, scatter, stack), the wrappers' host us and one rebuild's device
    ops, B9's with ``previous_ms``, the list form's (B5 list) with the
    counted kernel's ``counted_ms`` and B4's, its bound from the listed
    tests and the list's words, the build's (B5 list build: every
    candidate tested, the list written) with B4's, A1's at both cells
    (``alloc``, ``alloc3``) with the eager allocation as ``plain_ms``, its
    device ops and a block's launches, the noise kernel's
    (``langevin_noise``) with the plain version as ``plain_ms``, the
    ``torch.randn`` draw as ``randn_ms`` and its ulps, the BAOAB step's
    (``baoab_step``) with the eager step's passes as ``plain_ms`` and the
    3D N=100k step's as ``dim3_*``, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no last line.
Without a CUDA device it stops before doing anything.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import (
    cuda_ms,
    device_op_count,
    host_us,
    interleaved_ms,
    spread,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import roofline

# B8 at N=16,384 (2D, PBC, no cutoff) before its redesign (one thread an
# i-particle, two IEEE divides a pair, no FMA): this script's phase 11 on an
# NVIDIA H100 80GB HBM3 at 700 W; tests/torch_pairwise_designs.py builds that
# design and times it beside the kernel in one process
PREVIOUS_B8_MS = 0.5691


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


def _force_bounds(work, dim: int, n_slots: int, n_in_slots=None, extra_in_bytes: int = 0):
    """Bounds of the force kernel and its energy variant: a distance test
    costs 3d - 1 operations, an in-cutoff pair 7 + 2d more (one divide,
    s^6, the force magnitude, d products and d sums), 14 + 2d with the
    energy and virial; d coordinate grids in (``n_in_slots`` each, the halo
    rows included; default ``n_slots``) and ``extra_in_bytes`` (B3's count
    grid), d (or d + 2) out."""
    candidates, in_cut = work
    tests = (3 * dim - 1) * candidates
    n_in = n_slots if n_in_slots is None else n_in_slots
    return (roofline.bound(tests + (7 + 2 * dim) * in_cut, 4 * dim * (n_in + n_slots) + extra_in_bytes),
            roofline.bound(tests + (14 + 2 * dim) * in_cut, 4 * (dim * n_in + (dim + 2) * n_slots) + extra_in_bytes))


def _list_use(plist, occ):
    """``(words, full, entries)`` of a partner list at the occupied targets
    ``occ`` (``(cps, bound, cps, cps)``): the 16-bit words the list form
    reads, each strip's counts and every listed target's entries up to its
    last group of four; the targets marked full; the entries of the
    others."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3

    _, place = cell_cuda3._list_targets(occ, plist.strip, plist.stride)
    counts = plist.counts.reshape(-1)[place]
    full = counts == cell_cuda3.LIST_FULL
    used = int(((counts + 3) // 4 * 4)[~full].sum())
    return plist.n_strips * plist.stride + used, int(full.sum()), int(counts[~full].sum())


def _lists_equal(got, want, occ) -> bool:
    """Two partner lists of one binning hold the same counts, and the same
    entries up to each occupied target's last group (all ``k`` where
    full); the words past it are pad."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3

    _, place = cell_cuda3._list_targets(occ, got.strip, got.stride)
    cg, cw = got.counts.reshape(-1)[place], want.counts.reshape(-1)[place]
    if not torch.equal(cg, cw):
        return False
    n = torch.where(cg == cell_cuda3.LIST_FULL, got.k, (cg + 3) // 4 * 4)
    used = torch.arange(got.k, device=cg.device)[None] < n[:, None]
    eg, ew = (x.entries.reshape(-1, x.k)[place] for x in (got, want))
    return torch.equal(torch.where(used, eg, 0), torch.where(used, ew, 0))


def _list2_use(plist, num):
    """``(words, full, entries)`` of B3's partner list at the targets
    ``num``: the 16-bit words the list form reads (each target's count and
    its entries up to its last group of four), the targets marked full, the
    entries of the others."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3

    counts = plist.counts[num]
    full = counts == cell_cuda3.LIST_FULL
    used = int(((counts + 3) // 4 * 4)[~full].sum())
    return num.numel() + used, int(full.sum()), int(counts[~full].sum())


def _lists2_equal(got, want, counts, cap: int) -> bool:
    """Two of B3's partner lists of one binning, whatever order their
    strips were numbered in, number the targets 0 .. n-1 and hold each
    target's count and its entries up to its last group (all ``k`` where
    full); the words past it are pad."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3, cell_cuda_packed

    _, ng, _ = cell_cuda_packed._targets(counts, got, cap)
    _, nw, _ = cell_cuda_packed._targets(counts, want, cap)
    dense = torch.arange(ng.numel(), device=ng.device)
    cg, cw = got.counts[ng], want.counts[nw]
    if not (torch.equal(ng.sort().values, dense) and torch.equal(nw.sort().values, dense) and torch.equal(cg, cw)):
        return False
    n = torch.where(cg == cell_cuda3.LIST_FULL, got.k, (cg + 3) // 4 * 4)
    used = torch.arange(got.k, device=cg.device)[None] < n[:, None]
    return torch.equal(torch.where(used, got.entries[ng], 0), torch.where(used, want.entries[nw], 0))


def _migrate_bound(n_fields: int, n_out: int, n_moved: int, n_in=None):
    """A permutation: the code grid read (``n_in`` slots, the halo rows
    included; default ``n_out``), the F fields of the ``n_moved`` sources
    that land in the output read (an empty slot's fields need no read), F
    planes of ``n_out`` written. The allocation's occupancy, which B2 and B6
    read to tell the slots to fill, is an input of their design, not of
    the function (the plain versions and the TPU kernels take none), and is
    not counted."""
    n_in = n_out if n_in is None else n_in
    return roofline.bound(0.0, 4 * (n_in + n_moved * n_fields + n_out * n_fields))


def _counted_times(args, cov: int, halo: bool, repeats: int = 7):
    """B5 (``halo``: B5 halo) on the grids of ``args`` in ``repeats``
    interleaved rounds: the counted kernel at its default strip and with
    the energy, B5's full loop likewise, and the counted kernel at the
    strips ``ceil(ncz / k)``, k = 1 to 4, each queued behind a spin of the
    card (``cuda_ms``'s ``lead``). Returns the timings and the default
    strip."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3

    p = args[-1]
    run = cell_cuda3.grid_force3_halo if halo else cell_cuda3.grid_force3
    fns = {
        "counted": lambda: run(*args, static_cov=cov),
        "loop": lambda: cell_cuda3.grid_force3_static_loop(*args, cov, halo=halo),
        "counted_e": lambda: run(*args, with_energy=True, static_cov=cov),
        "loop_e": lambda: cell_cuda3.grid_force3_static_loop(*args, cov, True, halo=halo),
    }
    for k in range(1, 5):
        w = -(-p.cps // k)
        fns.setdefault(f"strip {w}", lambda w=w: cell_cuda3._forces3(args[:3], p, None, False, cov, halo, strip=w))
    rows = args[0].shape[0] - 2 if halo else p.cps
    return interleaved_ms(fns, repeats, lead=True), cell_cuda3.strip_width(p, rows, cov, False, args[0].device)


def _print_counted_times(label: str, t: dict, strip: int, bound, ncz: int) -> None:
    print(f"{label} time (medians of 7 interleaved repeats of 20 calls, lead): counted kernel (strip {strip} of "
          f"{ncz} z-cells) {spread(t['counted'])}, B5's full loop {spread(t['loop'])}; energy variants: "
          f"counted {spread(t['counted_e'])}, full loop {spread(t['loop_e'])}; bound {bound[0]:.5f} ms "
          f"({bound[1]}); strips: " + ", ".join(f"{k.split()[1]}: {v[0]:.4f}" for k, v in t.items()
                                                if k.startswith("strip")), flush=True)


# tile candidates (rows x columns, each balanced to the grid as the default
# is) timed beside the default tile of B1 and B1 halo
TILE_CANDIDATES = ((1, 32), (2, 32), (4, 32), (8, 32), (2, 16), (4, 16), (8, 16), (2, 64))


def _balanced(n: int, target: int) -> int:
    """``ceil(n / ceil(n / target))``, as ``csrc/cell_force.cu`` balances a
    tile's rows and columns."""
    return -(-n // -(-n // target))


def _tile_times(cell_cuda, args, rows: int, halo: bool, repeats: int = 7):
    """B1 (``halo``: B1 halo) on ``args`` = ``(x, y, p)`` in ``repeats``
    interleaved rounds: the tile kernel at its default tile and B1's loop,
    each in both variants, and the tile kernel at the candidate tiles, each
    queued behind a spin of the card (``cuda_ms``'s ``lead``: the tile
    kernel takes less device time than its wrapper takes on the host).
    Returns the timings and each variant's default ``(H, W, threads)``."""
    x, y, p = args
    run = cell_cuda.grid_force_halo if halo else cell_cuda.grid_force
    loop = cell_cuda.grid_force_halo_loop if halo else cell_cuda.grid_force_loop
    fns = {"tile": lambda: run(x, y, p), "loop": lambda: loop(x, y, p),
           "tile_e": lambda: run(x, y, p, True), "loop_e": lambda: loop(x, y, p, True)}
    for h, w in TILE_CANDIDATES:
        t = (_balanced(rows, h), _balanced(p.cps, w))
        fns.setdefault(f"tile {t[0]}x{t[1]}", lambda t=t: run(x, y, p, tile=t))
        fns.setdefault(f"tile_e {t[0]}x{t[1]}", lambda t=t: run(x, y, p, True, tile=t))
    tiles = tuple(cell_cuda.tile_shape(p, rows, e, x.device) for e in (False, True))
    return interleaved_ms(fns, repeats, lead=True), tiles


def _print_tile_times(label: str, t: dict, tiles, bound) -> None:
    (h, w, th), (he, we, the) = tiles
    cands = [k.split()[1] for k in t if k.startswith("tile ")]
    print(f"{label} time (medians of 7 interleaved repeats of 20 calls): tile kernel (tile {h}x{w}, {th} threads) "
          f"{spread(t['tile'])}, B1's loop {spread(t['loop'])}; energy variants: tile kernel (tile {he}x{we}, "
          f"{the} threads) {spread(t['tile_e'])}, loop {spread(t['loop_e'])}; bound {bound[0]:.5f} ms "
          f"({bound[1]}); tiles (force, energy): " + ", ".join(
              f"{c}: {t['tile ' + c][0]:.4f}, {t['tile_e ' + c][0]:.4f}" for c in cands), flush=True)


def _kernel_alone_ms(fn, kernel_key: str, path: str, reps: int = 20) -> float:
    """The device ms a call of the kernels whose name holds ``kernel_key``
    over ``reps`` calls of ``fn()`` under the profiler: the kernel alone,
    whatever the host's time between two launches."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import profile_device

    fn()
    _, _, by_name = profile_device(lambda: [fn() for _ in range(reps)], path)
    dev_s = sum(v for k, v in by_name.items() if kernel_key in k)
    if dev_s <= 0:
        raise AssertionError(f"no {kernel_key} in the profile")
    return 1e3 * dev_s / reps


def _designs(name: str):
    """``tests/<name>.py``, a previous kernel design's source, build
    function and wrapper (``torch_migrate3_designs``: B6's;
    ``torch_migrate_designs``: B2's; ``torch_gravity_designs``: B9's),
    imported from this script's ``tests/``."""
    import importlib

    here = os.path.dirname(os.path.abspath(__file__))
    for path in (here, os.path.join(here, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    return importlib.import_module(name)


def _kernel_name(mangled: str) -> str:
    """``migrate_kernel<true>`` for the mangled name of a kernel template in
    a source's anonymous namespace (``_ZN<n><namespace><n><name>I...E``);
    the first 48 characters of any other name."""
    m = re.match(r"_ZN(\d+)", mangled)
    k = m.end() + int(m.group(1)) if m else 0
    n = re.match(r"(\d+)", mangled[k:]) if m else None
    if not n:
        return mangled[:48]
    start = k + n.end()
    end = start + int(n.group(1))
    tail = mangled[end:]
    args = re.findall(r"L([bi])(\d+)E", tail[: tail.find("Ev")]) if tail.startswith("I") else []
    shown = ["true" if a == ("b", "1") else "false" if a == ("b", "0") else a[1] for a in args]
    return mangled[start:end] + (f"<{', '.join(shown)}>" if shown else "")


def _ptxas(log_text: str) -> dict:
    """``{kernel: (registers, spill bytes)}`` from the ``-Xptxas -v`` lines of
    a build log, each kernel named by its name and template arguments as
    ``migrate_kernel<true>``."""
    out, name, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name, spill = None, 0
    return out


def _short_names(ops: dict) -> dict:
    """``device_op_count``'s counts by the bare kernel or op name."""
    short = {}
    for k, v in ops.items():
        bare = k.replace("(anonymous namespace)::", "").replace("void ", "")
        name = re.split(r"[<(]", bare, maxsplit=1)[0].split("::")[-1][:48] or k[:48]
        short[name] = short.get(name, 0) + v
    return short


def _rebuild_ops_2d(md, gs, label: str, previous_migrate) -> dict:
    """One rebuild of the 2D engine ``md`` (unpacked, packed or sharded)
    from ``gs`` under the profiler, with B2 and again with ``md._migrate``
    replaced by ``previous_migrate(scode, planes, fills, occ)`` (the previous
    design: stack, fill, scatter): prints both ops by name and count, and
    checks that B2 launched once, as one ``migrate_kernel``, with no fill or
    scatter kernel. Returns ``{"ops": n, "previous_ops": n}``."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda

    def b2_launches():
        return migrate_cuda.LAUNCHES + migrate_cuda.PACKED_LAUNCHES + migrate_cuda.HALO_LAUNCHES

    before = b2_launches()
    md._rebuild_migrate(gs)
    launched = b2_launches() - before
    ops = device_op_count(lambda: md._rebuild_migrate(gs))
    md._migrate = lambda *args: (previous_migrate(*args), None)
    try:
        ops_prev = device_op_count(lambda: md._rebuild_migrate(gs))
    finally:
        del md._migrate
    short, short_prev = _short_names(ops), _short_names(ops_prev)
    b2 = short.get("migrate_kernel", 0)
    if b2 != 1 or launched != 1 or short.get("migrate_fill_kernel") or short.get("migrate_scatter_kernel"):
        raise AssertionError(f"{label} rebuild: {b2} migrate_kernel on the card, {launched} B2 launches; ops {ops}")
    print(f"{label} one rebuild: {sum(ops.values())} device ops, {b2} B2 launch (migrate_kernel); with the "
          f"previous design (stack, fill, scatter) {sum(ops_prev.values())}; ops by name: "
          + ", ".join(f"{k} x{v}" for k, v in sorted(short.items())) + "; previous: "
          + ", ".join(f"{k} x{v}" for k, v in sorted(short_prev.items())), flush=True)
    return {"ops": sum(ops.values()), "previous_ops": sum(ops_prev.values())}


def _b2_checked_times(designs, prev, md, gs, label: str):
    """B2 (packed where ``md`` packs) on the rebuild's inputs of ``gs`` and
    of its overflow state (``designs.overflow_state``): the kernel, the
    planes passed where they lie, and the previous design torch.equal to
    the plain version; then, on ``gs``'s inputs, 7 interleaved repeats of
    20 calls behind a spin of the card: B2, the previous design (stack,
    fill and scatter), its stack, fill and scatter alone; the host us a
    call of B2's wrapper and of the previous design's; the plain version's
    ms. Returns ``(times, host_us, plain_ms, inputs)``."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda

    r = md.rows_per_block
    for name, st in (("state", gs), ("overflow state", designs.overflow_state(md, gs))):
        scode, occ, planes, fills, overflow = designs.rebuild_inputs(md, st)
        want = migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, r)
        if not torch.equal(migrate_cuda.migrate(scode, planes, fills, r, occ=occ), want):
            raise AssertionError(f"B2 {label} ({name}): kernel output is not bit-equal to the plain version")
        if not torch.equal(designs.previous(prev, scode, planes, fills, r), want):
            raise AssertionError(f"B2 {label} ({name}): the previous design is not bit-equal to the plain version")
        if bool(overflow) is not (name == "overflow state"):
            raise AssertionError(f"B2 {label} ({name}): overflow {bool(overflow)}")
    scode, occ, planes, fills, _ = designs.rebuild_inputs(md, gs)
    stacked = torch.stack(planes)
    fns = {
        "B2": lambda: migrate_cuda.migrate(scode, planes, fills, r, occ=occ),
        "previous": lambda: designs.previous(prev, scode, planes, fills, r),
        "stack": lambda: torch.stack(planes),
        "fill": lambda: designs.previous(prev, scode, stacked, fills, r, what=1),
        "scatter": lambda: designs.previous(prev, scode, stacked, fills, r, what=2),
    }
    t = interleaved_ms(fns, lead=True)
    host = {k: host_us(fns[k]) for k in ("B2", "previous")}
    plain = cuda_ms(lambda: migrate_cuda.migrate_reference(scode, stacked, fills, r), 10)
    return t, host, plain, (scode, occ, planes, fills)


def _b2_extra(t: dict, host: dict, prefix: str = "") -> dict:
    """The kernels line's keys of B2's previous design and host times."""
    return {f"{prefix}previous_ms": t["previous"][0], f"{prefix}previous_fill_ms": t["fill"][0],
            f"{prefix}previous_scatter_ms": t["scatter"][0], f"{prefix}stack_ms": t["stack"][0],
            f"{prefix}host_us": host["B2"], f"{prefix}previous_host_us": host["previous"]}


def _leapfrog_checked_times(md, s, label: str):
    """L1 on the engine ``md``'s state ``s``: the fused window at 1, 4 and
    7 steps torch.equal to the eager window in every field it writes,
    ``dmax2``, ``overflow`` and ``time``, and ``s`` unchanged by it; then
    ``tests/torch_leapfrog_designs.launch_times``: each launch beside the
    eager passes of the same updates, and its byte bound."""
    import torch

    eager = _designs("torch_window_eager")
    given = {k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)}
    for n in (1, 4, 7):
        eager.assert_states_equal(md, md._make_window(md.force_kernel, n)(s),
                                  eager.eager_window(md, md.force_kernel, n)(s))
    torch.cuda.synchronize()
    changed = [k for k, v in given.items() if not torch.equal(getattr(s, k), v)]
    if changed:
        raise AssertionError(f"L1 {label}: the fused window wrote the state it was given: {changed}")
    t, b, _ = _designs("torch_leapfrog_designs").launch_times(md, s)
    print(f"phase {label} L1: the fused window (1, 4, 7 steps) torch.equal to the eager window in every "
          f"field, dmax2, overflow and time; the state it was given unchanged", flush=True)
    for name in ("step", "first", "close"):
        print(f"phase {label} time leapfrog_{name} (medians of 7 interleaved repeats of 20 calls, lead): kernel "
              f"{spread(t[name])}, eager passes {spread(t['eager_' + name])}; bound {b[name][0]:.5f} ms "
              f"({b[name][1]})", flush=True)
    return t, b


def _baoab_checked_times(md, s, thermostat, label: str):
    """The fused BAOAB pass on the engine ``md``'s Langevin state ``s``:
    the fused window at 1 and 4 steps torch.equal to the eager Langevin
    window in every field it writes, ``dmax2``, ``overflow``, ``time`` and
    the global step, and ``s`` unchanged by it; then one step launch beside
    the eager passes of the same updates (kick, refresh, drifts, Kahan
    positions, displacement max; the noise and the force left out of
    both), medians of 7 interleaved repeats of 20 calls behind a spin of the
    card, and the step's byte bound: f, xi and the fields v, pos, disp (cr)
    read, the fields written. ``(t, bound)``."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import baoab_cuda, leapfrog_cuda, noise_cuda

    eager = _designs("torch_window_eager")
    given = {k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)}
    for n in (1, 4):
        got = md._make_window(md.force_kernel, n, thermostat)(s)
        want = eager.eager_langevin_window(md, md.force_kernel, n, thermostat)(s)
        eager.assert_states_equal(md, got, want)
        if got.rng_counter != want.rng_counter:
            raise AssertionError(f"BAOAB {label}: global step {got.rng_counter}, eager {want.rng_counter}")
    torch.cuda.synchronize()
    changed = [k for k, v in given.items() if not torch.equal(getattr(s, k), v)]
    if changed:
        raise AssertionError(f"BAOAB {label}: the fused window wrote the state it was given: {changed}")
    axes = md.AXES
    dim, dt, comp = len(axes), md.dt, bool(md.compensated)
    gamma, kt = thermostat
    c1 = float(math.exp(-gamma * dt))
    c2 = float(math.sqrt(kt * (1.0 - c1 * c1)))
    v = [getattr(s, f"v{a}g") for a in axes]
    pos = [getattr(s, f"{a}g") for a in axes]
    disp = [getattr(s, f"disp{a}") for a in axes]
    cr = [getattr(s, f"cr{a}") for a in axes] if comp else None
    f = [getattr(s, f"f{a}g") for a in axes]
    xi = list(noise_cuda.langevin_noise(s.rng_seed, s.rng_counter, s.pid, dim))
    bo = baoab_cuda.Baoab(v, pos, disp, cr, dt=dt, c1=c1, c2=c2)
    bo.step(f, xi)
    dm = leapfrog_cuda.sumsq(disp)

    def eager_step():
        vh = [x + dt * fa for x, fa in zip(v, f)]
        vp = [c1 * x + c2 * xi[k] for k, x in enumerate(vh)]
        inc = [0.5 * dt * (x + y) for x, y in zip(vh, vp)]
        p, c, d = list(pos), list(cr or [None] * dim), list(disp)
        for k in range(dim):
            if comp:
                p[k], c[k] = leapfrog_cuda.kadd(p[k], c[k], inc[k])
            else:
                p[k] = p[k] + inc[k]
            d[k] = d[k] + inc[k]
        return torch.maximum(dm, leapfrog_cuda.sumsq(d))

    t = interleaved_ms({"step": lambda: bo.step(f, xi), "eager_step": eager_step}, lead=True)
    planes = dim * (2 + 2 * (3 + int(comp)))
    bound = roofline.bound(0.0, 4 * planes * s.xg.numel())
    print(f"phase {label} BAOAB: the fused window (1, 4 steps) torch.equal to the eager window in every field, "
          f"dmax2, overflow, time and the global step; the state it was given unchanged", flush=True)
    print(f"phase {label} time baoab_step (medians of 7 interleaved repeats of 20 calls, lead): kernel "
          f"{spread(t['step'])}, eager passes {spread(t['eager_step'])}; bound {bound[0]:.5f} ms ({planes} planes, "
          f"{bound[1]}), {100 * bound[0] / t['step'][0]:.1f}% of it", flush=True)
    return t, bound


def _rebuild_ops(md, gs, label: str) -> None:
    """One rebuild of the 3D engine ``md`` from ``gs`` under the profiler:
    prints the device ops by name and count, and checks that B6 (or B6
    halo) launched once, as one ``migrate3_kernel``, and that the plain
    mover flag (``migrate_cuda3.mover_overflow``) was not called."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3

    calls = []
    plain = migrate_cuda3.mover_overflow
    migrate_cuda3.mover_overflow = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        before = migrate_cuda3.LAUNCHES + migrate_cuda3.HALO_LAUNCHES
        md._rebuild_migrate(gs)
        launched = migrate_cuda3.LAUNCHES + migrate_cuda3.HALO_LAUNCHES - before
        ops = device_op_count(lambda: md._rebuild_migrate(gs))
    finally:
        migrate_cuda3.mover_overflow = plain
    b6 = sum(v for k, v in ops.items() if "migrate3_kernel" in k)
    if b6 != 1 or launched != 1 or calls:
        raise AssertionError(f"{label} rebuild: {b6} migrate3_kernel on the card, {launched} B6 launches, "
                             f"mover_overflow called {len(calls)} times; ops {ops}")
    short = _short_names(ops)
    print(f"{label} one rebuild: {sum(ops.values())} device ops, {b6} B6 launch (migrate3_kernel), "
          f"mover_overflow called 0 times; ops by name: " + ", ".join(f"{k} x{v}" for k, v in sorted(short.items())),
          flush=True)


# the float64 tolerances of tests/test_torch_em3.py (ten times how far one ulp
# of one start coordinate moves the orbit): (steps compared, max |diff|)
EM3_F64_ATOL = {"boris": ((1000, 1e-10),), "reference": ((400, 1e-9), (1000, 5e-4))}


def _margin(got, want, rtol: float, atol: float) -> float:
    """The largest share of the allowance ``atol + rtol * |want|`` that
    ``|got - want|`` uses (<= 1 passes), both moved to the CPU in float64."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _near_ties(w_cpu, w_dev, u, resampler: str):
    """``(near, gap)``: which comb points of a resampling by the uniform(s)
    ``u`` (a CPU tensor) lie within ``gap`` + 1e-6 of a step of the CPU's
    CDF of the weights ``w_cpu``, ``gap`` the largest difference between
    that CDF and the card's of ``w_dev`` (the card adds the cumsum in
    another order). An index can differ between the two devices only at
    such a point."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.resampling import _sanitize

    n = w_cpu.shape[0]
    cdf = torch.cumsum(_sanitize(w_cpu), 0)
    gap = float((torch.cumsum(_sanitize(w_dev), 0).cpu() - cdf).abs().max())
    points = u.expand(n) if resampler == "multinomial" else (torch.arange(n, dtype=torch.float32) + u) / n
    pos = torch.searchsorted(cdf, points).clamp(1, n - 1)
    return torch.minimum((points - cdf[pos - 1]).abs(), (points - cdf[pos]).abs()) <= gap + 1e-6, gap


def _busy_line(label: str, fn, wall_ms: float, units: int, unit: str, trace: str) -> float:
    """Runs ``fn()`` (``units`` steps or sweeps) under the profiler and
    prints its device time a unit beside ``wall_ms``, the untraced wall time
    a unit; returns the busy share."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import profile_device

    dev_s, _, _ = profile_device(fn, trace)
    dev_ms = 1e3 * dev_s / units
    share = dev_ms / wall_ms
    print(f"{label}: device busy {dev_ms:.4f} ms a {unit} of {wall_ms:.4f} ms wall (untraced); busy share "
          f"{share:.4f}, idle share {1 - share:.4f}", flush=True)
    if os.path.exists(trace):
        os.remove(trace)  # traces are large; the numbers are printed
    return share


def _em3_phase(smi: str) -> None:
    """Phase 27: ``em3`` on the card (see the module docstring)."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import EM3Config, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import em_three_particles as em3

    cfg = EM3Config()
    for integrator in ("boris", "reference"):
        c = override(cfg, integrator=integrator)
        res = em3.run(c, device="cuda")
        traj = res.trajectory
        if tuple(traj.shape) != (c.n_steps + 1, 3, 2) or not bool(torch.isfinite(traj).all()):
            raise AssertionError(f"phase 27 em3 {integrator}: trajectory {tuple(traj.shape)} not finite or misshaped")
        _, cpu = em3.simulate(c, em3.default_initial_state(device="cpu"))
        m50 = _margin(traj[:51], cpu[:51], 1e-4, 1e-5)
        if not m50 <= 1.0:
            raise AssertionError(f"phase 27 em3 {integrator} first 50 steps, card vs CPU: {m50:.3f} of the "
                                 f"rtol 1e-4, atol 1e-5 allowance")
        _, t64 = em3.simulate(c, em3.default_initial_state(torch.float64, "cuda"))
        _, c64 = em3.simulate(c, em3.default_initial_state(torch.float64, "cpu"))
        diff = (t64.cpu() - c64).abs()
        f64 = []
        for steps, atol in EM3_F64_ATOL[integrator]:
            d = float(diff[: steps + 1].max())
            if not d <= atol:
                raise AssertionError(f"phase 27 em3 {integrator} float64, first {steps} steps card vs CPU: "
                                     f"max |diff| {d:.3e} > {atol:g}")
            f64.append(f"{steps} steps {d:.3e} (<= {atol:g})")
        # one step's device ops, and the busy share over 100 traced steps
        state = em3.default_initial_state(device="cuda")
        init_fn, step_fn = em3.build_step(c, state)
        s = step_fn(init_fn(state))
        ops = device_op_count(lambda: [step_fn(s) for _ in range(10)])
        wall_ms = 1e3 * res.wall_time_s / c.n_steps
        print(f"{smi}: phase 27 em3 {integrator} (default: 3 particles, {c.n_steps} steps, dt {c.dt}, float32): "
              f"timed run {res.wall_time_s * 1e3:.2f} ms = {wall_ms:.4f} ms a step, "
              f"{sum(ops.values()) / 10:.1f} device ops a step (no custom kernel: three particles are pure "
              f"launch latency); card vs CPU: first 50 steps {m50:.4f} of the rtol 1e-4, atol 1e-5 "
              f"allowance; float64 max |diff| {', '.join(f64)}", flush=True)
        short = override(c, n_steps=100)
        _busy_line(f"{smi}: phase 27 em3 {integrator} (100 traced steps)", lambda: em3.simulate(short, state),
                   wall_ms, 100, "step", os.path.join("chiprun_out", "chip_smoke_em3_trace.json"))


def _vmc_phase(smi: str) -> None:
    """Phase 28: ``vmc`` on the card at full width (see the module
    docstring)."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.mc import adam, dmc, metropolis, models, resampling, vmc
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import quantum_oscillator

    dev = torch.device("cuda")
    # only the depth is cut: 300 epochs instead of the default 3000
    cfg = override(VMCDMCConfig(), n_epochs=300)
    res = quantum_oscillator.run(cfg, device=dev)
    mean_s, err_s = (float(v) for v in res.dmc.mean_energy(burn_in=100))
    t0 = time.perf_counter()
    res_m = dmc.run_dmc(models.HarmonicOscillator(dim=cfg.dim), res.vmc.params, res.vmc.walkers,
                        res.vmc.generator, override(cfg, resampler="multinomial"))
    torch.cuda.synchronize()
    dmc_m_s = time.perf_counter() - t0
    mean_m, err_m = (float(v) for v in res_m.mean_energy(burn_in=100))
    checks = {"|alpha - 0.5|": abs(res.vmc_alpha - 0.5), "|E_VMC - 1.5|": abs(res.vmc_energy - 1.5),
              "|E_DMC(systematic) - 1.5|": abs(mean_s - 1.5), "|E_DMC(multinomial) - 1.5|": abs(mean_m - 1.5)}
    bad = {k: v for k, v in checks.items() if not v < 0.05}
    hists = (res.vmc.energy_history, res.dmc.energy_history, res_m.energy_history, res.dmc.walkers)
    if bad or not all(bool(torch.isfinite(h).all()) for h in hists):
        raise AssertionError(f"phase 28 vmc: {bad} (bound 0.05), histories finite "
                             f"{[bool(torch.isfinite(h).all()) for h in hists]}")
    if res.vmc.energy_history.shape != (cfg.n_epochs,) or res.dmc.energy_history.shape != (cfg.n_dmc,):
        raise AssertionError(f"phase 28 vmc: histories {tuple(res.vmc.energy_history.shape)}, "
                             f"{tuple(res.dmc.energy_history.shape)}")
    ms_epoch = 1e3 * res.vmc_wall_s / cfg.n_epochs
    ms_dmc = 1e3 * res.dmc_wall_s / cfg.n_dmc
    print(f"{smi}: phase 28 vmc (widths: {cfg.n_walkers} walkers, dim {cfg.dim}, n_equil {cfg.n_equil}, step "
          f"{cfg.step_size}, lr {cfg.lr}; depth cut: {cfg.n_epochs} epochs instead of 3000; DMC {cfg.n_dmc} steps "
          f"at dt {cfg.dmc_dt}): alpha {res.vmc_alpha:.6f}, E_VMC {res.vmc_energy:.6f}, E_DMC systematic "
          f"{mean_s:.6f} +- {err_s:.6f}, multinomial {mean_m:.6f} +- {err_m:.6f} (exact 1.5, bounds 0.05); VMC "
          f"{res.vmc_wall_s:.3f} s = {ms_epoch:.4f} ms an epoch, DMC {res.dmc_wall_s:.3f} s = {ms_dmc:.4f} ms a "
          f"step (multinomial {1e3 * dmc_m_s / cfg.n_dmc:.4f}); the default 3000 epochs worked out as 3000 x "
          f"{ms_epoch:.4f} ms = {3000 * ms_epoch / 1e3:.1f} s (worked out, not run)", flush=True)

    # the anharmonic model at dim 1 against its diagonalization oracle
    cfg_a = override(VMCDMCConfig(), potential="anharmonic", lam=0.2, dim=1, n_walkers=1000, n_epochs=200,
                     n_equil=10, epoch_chunk=50, lr=0.05, n_dmc=150)
    res_a = quantum_oscillator.run(cfg_a, device=dev)
    mean_a = float(res_a.dmc.mean_energy()[0])
    d_vmc, d_dmc = abs(res_a.vmc_energy - res_a.exact_energy), abs(mean_a - res_a.exact_energy)
    if not (d_vmc < 2e-2 and d_dmc < 1e-2):
        raise AssertionError(f"phase 28 anharmonic: |E_VMC - exact| {d_vmc:.3e} (bound 2e-2), |E_DMC - exact| "
                             f"{d_dmc:.3e} (bound 1e-2)")
    print(f"phase 28 anharmonic (dim 1, lam 0.2, 1000 walkers, 200 epochs, 150 DMC steps): E_VMC "
          f"{res_a.vmc_energy:.6f}, E_DMC {mean_a:.6f}, oracle {res_a.exact_energy:.6f} (|diff| {d_vmc:.2e} < 2e-2, "
          f"{d_dmc:.2e} < 1e-2); alpha {float(res_a.vmc.params['alpha']):.6f}, beta "
          f"{float(res_a.vmc.params['beta']):.6f}; VMC {res_a.vmc_wall_s:.3f} s, DMC {res_a.dmc_wall_s:.3f} s",
          flush=True)

    # card against CPU at fixed draws made on the CPU
    n, dim = cfg.n_walkers, cfg.dim
    g = torch.Generator().manual_seed(2028)
    x = torch.randn((n, dim), generator=g) * 1.2
    u_prop, u_acc = torch.rand((n, dim), generator=g) - 0.5, torch.rand((n,), generator=g)
    u_multi, u_sys, noise = torch.rand((n,), generator=g), torch.rand((), generator=g), torch.randn((n, dim), generator=g)
    harm, anh = models.HarmonicOscillator(dim=dim), models.AnharmonicOscillator(dim=dim, lam=0.2)
    p_cpu = {"harmonic": torch.tensor(0.45), "anharmonic": {"alpha": torch.tensor(0.6), "beta": torch.tensor(0.05)}}
    p_dev = {k: adam.tree_map(lambda t: t.to(dev), v) for k, v in p_cpu.items()}
    margins = {}
    for name, m in (("harmonic", harm), ("anharmonic", anh)):
        margins[f"local_energy {name}"] = _margin(m.local_energy(p_dev[name], x.to(dev)),
                                                  m.local_energy(p_cpu[name], x), 1e-6,
                                                  1e-6 * float(m.local_energy(p_cpu[name], x).abs().max()))
    update = metropolis.make_metropolis_update(harm.log_psi, cfg.step_size)
    w_dev, _ = update(x.to(dev), p_dev["harmonic"], u_prop.to(dev), u_acc.to(dev))
    w_cpu, _ = update(x, p_cpu["harmonic"], u_prop, u_acc)
    prop = x + cfg.step_size * u_prop
    thr = torch.exp(2.0 * (harm.log_psi(p_cpu["harmonic"], prop) - harm.log_psi(p_cpu["harmonic"], x)))
    tie = (u_acc - thr).abs() <= 1e-6
    acc_dev, acc_cpu = (w_dev.cpu() != x).any(dim=1), (w_cpu != x).any(dim=1)
    if bool(((acc_dev != acc_cpu) & ~tie).any()):
        raise AssertionError(f"phase 28 metropolis_update card vs CPU: {int(((acc_dev != acc_cpu) & ~tie).sum())} "
                             f"accepts differ away from a near-tie")
    margins["metropolis_update"] = _margin(w_dev.cpu()[~tie], w_cpu[~tie], 1e-6, 1e-6 * float(w_cpu.abs().max()))
    e = harm.local_energy(p_cpu["harmonic"], x)
    weights = torch.exp(-(e - e.mean()) * 0.5)
    n_ties, gaps = 0, {}
    for rname, u in (("multinomial", u_multi), ("systematic", u_sys)):
        fn = resampling.RESAMPLERS_FROM[rname]
        rows = torch.arange(n, dtype=torch.float32)[:, None]
        i_dev = fn(rows.to(dev), weights.to(dev), u.to(dev)).cpu()[:, 0]
        i_cpu = fn(rows, weights, u)[:, 0]
        near, gap = _near_ties(weights, weights.to(dev), u, rname)
        gaps[rname] = gap
        if bool(((i_dev != i_cpu) & ~near).any()):
            raise AssertionError(f"phase 28 {rname} resampler card vs CPU: {int(((i_dev != i_cpu) & ~near).sum())} "
                                 f"indices differ away from a near-tie")
        n_ties += int(near.sum())
    grads = {"alpha": torch.tensor(0.031), "beta": torch.tensor(-0.0042)}
    state = adam.AdamState(count=torch.tensor(41, dtype=torch.int32), mu={"alpha": torch.tensor(0.02),
                           "beta": torch.tensor(-0.003)}, nu={"alpha": torch.tensor(4e-4), "beta": torch.tensor(1e-5)})
    u_cpu, _ = adam.adam_update(grads, state, cfg.lr)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    u_dev, _ = adam.adam_update(adam.tree_map(to_dev, grads), adam.AdamState(
        count=state.count.to(dev), mu=adam.tree_map(to_dev, state.mu), nu=adam.tree_map(to_dev, state.nu)), cfg.lr)
    margins["adam update"] = max(_margin(a, b, 1e-6, 1e-6 * cfg.lr)
                                 for a, b in zip(adam.tree_leaves(u_dev), adam.tree_leaves(u_cpu)))
    for rname, u in (("multinomial", u_multi), ("systematic", u_sys)):
        step = dmc.make_dmc_update(harm, p_cpu["harmonic"], cfg.dmc_dt, rname)
        step_dev = dmc.make_dmc_update(harm, p_dev["harmonic"], cfg.dmc_dt, rname)
        w_c, e_c = step(x, u, noise)
        w_d, e_d = step_dev(x.to(dev), u.to(dev), noise.to(dev))
        margins[f"dmc step {rname} E_ref"] = _margin(e_d, e_c, 1e-6, 0.0)
        e_l, e_ld = harm.local_energy(p_cpu["harmonic"], x), harm.local_energy(p_dev["harmonic"], x.to(dev))
        near, gaps[f"dmc {rname}"] = _near_ties(torch.exp(-(e_l - e_c) * cfg.dmc_dt),
                                                torch.exp(-(e_ld - e_d) * cfg.dmc_dt), u, rname)
        keep = ~near
        n_ties += int(near.sum())
        margins[f"dmc step {rname} walkers"] = _margin(w_d.cpu()[keep], w_c[keep], 1e-6,
                                                        1e-6 * float(w_c.abs().max()))
    bad = {k: v for k, v in margins.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"phase 28 card vs CPU at fixed draws: {bad} of the allowance (rtol 1e-6)")
    print("phase 28 card vs CPU at fixed draws (10000 walkers, dim 3; share of the rtol 1e-6 allowance used): "
          + ", ".join(f"{k} {v:.4f}" for k, v in margins.items())
          + f"; resampled indices and walkers equal away from {n_ties} near-ties of a comb point and a CDF step "
          f"(within 1e-6 + the CDFs' largest card-CPU difference: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + ")", flush=True)

    # a sweep's device ops and wall time, an epoch's busy share
    sweep = metropolis.make_metropolis_sweep(harm.log_psi, cfg.step_size)
    gen = torch.Generator(device=dev).manual_seed(7)
    w0 = torch.randn((n, dim), device=dev, generator=gen)
    alpha = torch.tensor(0.5, device=dev)
    ops = device_op_count(lambda: [sweep(w0, alpha, gen) for _ in range(10)])
    sweep(w0, alpha, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = w0
    for _ in range(500):
        w, _ = sweep(w, alpha, gen)
    torch.cuda.synchronize()
    ms_sweep = 1e3 * (time.perf_counter() - t0) / 500
    print(f"{smi}: phase 28 Metropolis sweep ({n} walkers, dim {dim}): {ms_sweep:.4f} ms a sweep (500 sweeps, "
          f"host loop), {sum(ops.values()) / 10:.1f} device ops a sweep: "
          + ", ".join(f"{k} x{v // 10}" for k, v in sorted(_short_names(ops).items())), flush=True)
    epoch = vmc.make_epoch_step(harm, cfg)
    opt = adam.adam_init(alpha)
    epoch(w0, alpha, gen, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        epoch(w0, alpha, gen, opt)
    torch.cuda.synchronize()
    ms_ep = 1e3 * (time.perf_counter() - t0) / 3
    _busy_line(f"{smi}: phase 28 VMC epoch (100 sweeps + gradient + Adam, 1 traced epoch)",
               lambda: epoch(w0, alpha, gen, opt), ms_ep, 1, "epoch",
               os.path.join("chiprun_out", "chip_smoke_vmc_trace.json"))
    step = dmc.make_dmc_step(harm, alpha, cfg.dmc_dt, cfg.resampler)
    ops = device_op_count(lambda: [step(w0, gen) for _ in range(10)])
    print(f"phase 28 DMC step ({cfg.resampler}): {sum(ops.values()) / 10:.1f} device ops a step", flush=True)
    _busy_line(f"{smi}: phase 28 DMC step (20 traced steps; wall from the run)",
               lambda: [step(w0, gen) for _ in range(20)], ms_dmc, 20, "step",
               os.path.join("chiprun_out", "chip_smoke_dmc_trace.json"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import (
        _build,
        alloc_cuda,
        baoab_cuda,
        cell_cuda,
        cell_cuda3,
        cell_cuda_packed,
        copy_cuda,
        leapfrog_cuda,
        migrate_cuda,
        migrate_cuda3,
        noise_cuda,
        pairwise_cuda,
    )
    import torch.distributed as dist

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks, make_mesh

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def launch_counts() -> dict:
        """Every kernel's launch counter, by its name in the kernels line."""
        return {
            "cell_force": cell_cuda.LAUNCHES, "cell_force_energy": cell_cuda.ENERGY_LAUNCHES,
            "migrate": migrate_cuda.LAUNCHES, "cell_force_packed": cell_cuda_packed.LAUNCHES,
            "cell_force_packed_energy": cell_cuda_packed.ENERGY_LAUNCHES,
            "migrate_packed": migrate_cuda.PACKED_LAUNCHES, "cell_force3": cell_cuda3.LAUNCHES,
            "cell_force3_energy": cell_cuda3.ENERGY_LAUNCHES, "cell_force3_counted": cell_cuda3.COUNTED_LAUNCHES,
            "cell_force3_static": cell_cuda3.STATIC_LAUNCHES,
            "migrate3": migrate_cuda3.LAUNCHES, "migrate3_flat": migrate_cuda3.FLAT_LAUNCHES,
            "cell_force_halo": cell_cuda.HALO_LAUNCHES, "cell_force_halo_energy": cell_cuda.HALO_ENERGY_LAUNCHES,
            "migrate_halo": migrate_cuda.HALO_LAUNCHES, "cell_force3_halo": cell_cuda3.HALO_LAUNCHES,
            "cell_force3_halo_energy": cell_cuda3.HALO_ENERGY_LAUNCHES,
            "cell_force3_counted_halo": cell_cuda3.HALO_COUNTED_LAUNCHES,
            "cell_force3_static_halo": cell_cuda3.HALO_STATIC_LAUNCHES, "migrate3_halo": migrate_cuda3.HALO_LAUNCHES,
            "cell_force_loop": cell_cuda.LOOP_LAUNCHES, "cell_force_loop_energy": cell_cuda.LOOP_ENERGY_LAUNCHES,
            "cell_force_halo_loop": cell_cuda.HALO_LOOP_LAUNCHES,
            "cell_force_halo_loop_energy": cell_cuda.HALO_LOOP_ENERGY_LAUNCHES,
            "cell_force3_loop": cell_cuda3.LOOP_LAUNCHES, "cell_force3_halo_loop": cell_cuda3.HALO_LOOP_LAUNCHES,
            "leapfrog_step": leapfrog_cuda.STEP_LAUNCHES, "leapfrog_close": leapfrog_cuda.CLOSE_LAUNCHES,
            "cell_force3_list": cell_cuda3.LIST_LAUNCHES, "cell_list3_build": cell_cuda3.LIST_BUILD_LAUNCHES,
            "cell_force_list": cell_cuda_packed.LIST_LAUNCHES, "cell_list_build": cell_cuda_packed.LIST_BUILD_LAUNCHES,
            "alloc": alloc_cuda.LAUNCHES, "langevin_noise": noise_cuda.LAUNCHES,
            "baoab_step": baoab_cuda.STEP_LAUNCHES, "baoab_close": baoab_cuda.CLOSE_LAUNCHES,
        }

    def reset_counts():
        cell_cuda.LAUNCHES = cell_cuda.ENERGY_LAUNCHES = migrate_cuda.LAUNCHES = 0
        cell_cuda_packed.LAUNCHES = cell_cuda_packed.ENERGY_LAUNCHES = migrate_cuda.PACKED_LAUNCHES = 0
        cell_cuda3.LAUNCHES = cell_cuda3.ENERGY_LAUNCHES = cell_cuda3.STATIC_LAUNCHES = 0
        cell_cuda3.COUNTED_LAUNCHES = cell_cuda3.HALO_COUNTED_LAUNCHES = 0
        migrate_cuda3.LAUNCHES = migrate_cuda3.FLAT_LAUNCHES = 0
        pairwise_cuda.LAUNCHES = pairwise_cuda.ENERGY_LAUNCHES = 0
        pairwise_cuda.GRAVITY_LAUNCHES = pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES = 0
        copy_cuda.COPY_LAUNCHES = 0
        cell_cuda.HALO_LAUNCHES = cell_cuda.HALO_ENERGY_LAUNCHES = migrate_cuda.HALO_LAUNCHES = 0
        cell_cuda3.HALO_LAUNCHES = cell_cuda3.HALO_ENERGY_LAUNCHES = cell_cuda3.HALO_STATIC_LAUNCHES = 0
        migrate_cuda3.HALO_LAUNCHES = 0
        cell_cuda.LOOP_LAUNCHES = cell_cuda.LOOP_ENERGY_LAUNCHES = 0
        cell_cuda.HALO_LOOP_LAUNCHES = cell_cuda.HALO_LOOP_ENERGY_LAUNCHES = 0
        cell_cuda3.LOOP_LAUNCHES = cell_cuda3.HALO_LOOP_LAUNCHES = 0
        leapfrog_cuda.STEP_LAUNCHES = leapfrog_cuda.CLOSE_LAUNCHES = 0
        cell_cuda3.LIST_LAUNCHES = cell_cuda3.LIST_BUILD_LAUNCHES = 0
        cell_cuda_packed.LIST_LAUNCHES = cell_cuda_packed.LIST_BUILD_LAUNCHES = 0
        alloc_cuda.LAUNCHES = 0
        noise_cuda.LAUNCHES = 0
        baoab_cuda.STEP_LAUNCHES = baoab_cuda.CLOSE_LAUNCHES = 0

    def loop_launches() -> dict:
        """B1's and B4's loop launches, which no path may make."""
        return {k: v for k, v in launch_counts().items() if "_loop" in k}

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    t0, wall0 = time.perf_counter(), time.time()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"torch {torch.__version__}; CUDA {torch.version.cuda}; kernel build {build_s:.2f} s",
          flush=True)
    log = os.path.splitext(lib._name)[0] + ".log"
    with open(log) as f:
        regs = _ptxas(f.read())
    # a library built earlier from the same sources and flags is loaded, not built again
    built = "built in this run" if os.path.getmtime(log) >= wall0 else "from the log of an earlier build"
    print(f"phase 1 registers a thread (spill bytes), -Xptxas -v, {built}: " + ", ".join(
        f"{k} {v[0]} ({v[1]})" for k, v in sorted(regs.items())), flush=True)

    times, errors, bounds, launches = {}, {}, {}, {}
    extra = {}  # more keys of a kernel's entry in the kernels line

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
    # the tile kernel against B1's loop, which sums the same pairs in the
    # same order: the same bits, in both variants and over two launches
    again = cell_cuda.grid_force(gs.xg, gs.yg, p) + cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=True)
    loop2 = cell_cuda.grid_force_loop(gs.xg, gs.yg, p) + cell_cuda.grid_force_loop(gs.xg, gs.yg, p, with_energy=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(fk + ek, again)):
        raise AssertionError("B1: two launches on one input are not bit-equal")
    if not all(torch.equal(a, b) for a, b in zip(fk + ek, loop2)):
        raise AssertionError("B1: the tile kernel is not torch.equal to B1's loop")
    del again, loop2

    # B2 (one launch: fill and scatter) on the rebuild's inputs as the engine
    # passes them (the planes where they lie, the allocation's occupancy)
    # and at overflow, against the plain version and the previous design
    # (stack, fill, scatter; tests/torch_migrate_designs.py)
    designs2 = _designs("torch_migrate_designs")
    prev_b2 = designs2.build(_build.BUILD_DIR / "designs")
    t2m, host2, plain2, (scode, occ_n, planes, fills) = _b2_checked_times(designs2, prev_b2, md, gs, "N=100k")
    movers = int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != 4)).sum())
    errors["migrate"] = 0.0

    t2, tile2 = _tile_times(cell_cuda, (gs.xg, gs.yg, p), md.cps, halo=False)
    times["cell_force"] = (t2["tile"][0], cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p), 10))
    times["cell_force_energy"] = (
        t2["tile_e"][0], cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=True), 10))
    extra["cell_force"] = {"loop_ms": t2["loop"][0], "tile": list(tile2[0])}
    extra["cell_force_energy"] = {"loop_ms": t2["loop_e"][0], "tile": list(tile2[1])}
    times["migrate"] = (t2m["B2"][0], plain2)
    extra["migrate"] = _b2_extra(t2m, host2)
    work2 = _pair_work((gs.xg, gs.yg), gs.occ, md.cps, md.cap, md.box, p.cutoff2)
    bounds["cell_force"], bounds["cell_force_energy"] = _force_bounds(work2, 2, gs.xg.numel())
    bounds["migrate"] = _migrate_bound(len(planes), gs.xg.numel(), int(occ_n.sum()))
    print(f"phase 2 B1 forces: max abs diff {errors['cell_force']:.3e} (max |f| {fmax:.1f}); "
          f"energy variant: forces {err_ef:.3e}, e/w max abs diff {err_e:.3e}, sums within rtol 1e-5; "
          f"B1 (the tile kernel, both variants) torch.equal to B1's loop and over two launches; "
          f"B2 and its previous design: bit-equal, also at overflow, {movers} movers; pair work: {work2[0]} "
          f"distance tests, {work2[1]} in the cutoff", flush=True)
    for name in ("cell_force", "cell_force_energy", "migrate"):
        print(f"phase 2 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
    print(f"{smi}: phase 2 B2 time (medians of 7 interleaved repeats of 20 calls, lead): B2 {spread(t2m['B2'])}, "
          f"the previous design (stack, fill, scatter) {spread(t2m['previous'])}, its stack {spread(t2m['stack'])}, "
          f"fill {spread(t2m['fill'])}, scatter {spread(t2m['scatter'])}; host us a call: B2 {host2['B2']:.1f}, "
          f"previous {host2['previous']:.1f}", flush=True)
    _print_tile_times(f"{smi}: phase 2 B1", t2, tile2, bounds["cell_force"])
    alone2 = {name: _kernel_alone_ms(fn, key, os.path.join("chiprun_out", "chip_smoke_b1_alone.json"))
              for name, fn, key in (("tile kernel", lambda: cell_cuda.grid_force(gs.xg, gs.yg, p),
                                     "cell_force_tile_kernel"),
                                    ("loop", lambda: cell_cuda.grid_force_loop(gs.xg, gs.yg, p), "cell_force_kernel"))}
    print(f"{smi}: phase 2 B1 alone on the card (profiler, 20 calls): " +
          ", ".join(f"{k} {v:.4f} ms" for k, v in alone2.items()), flush=True)

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
    reset_counts()
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
    if any(loop_launches().values()):
        raise AssertionError(f"N=4096 run launched B1's loop: {loop_launches()}")
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
             "migrate": migrate_cuda.LAUNCHES, "leapfrog_step": leapfrog_cuda.STEP_LAUNCHES,
             "alloc": alloc_cuda.LAUNCHES}
    report_run(res, "5 lj_fluid.run", path2, path2["migrate"])
    check_run(res, "2D main path")
    if path2["alloc"] != path2["migrate"]:
        raise AssertionError(f"2D main path: {path2['alloc']} allocations on the card, {path2['migrate']} rebuilds")
    for name, count in path2.items():
        if count <= 0:
            raise AssertionError(f"2D main path never launched kernel {name}")
    if any(loop_launches().values()):
        raise AssertionError(f"2D main path launched B1's loop: {loop_launches()}")
    launches.update(path2)
    loop_main = dict(loop_launches())  # B1's loop on the main paths: 0

    # -- 6. the 3D main path -----------------------------------------------------
    reset_counts()
    cfg3 = override(cfg, dim=3)
    res3 = lj_fluid.run(cfg3, device="cuda")
    path3 = {"cell_force3": cell_cuda3.LAUNCHES, "cell_force3_energy": cell_cuda3.ENERGY_LAUNCHES,
             "cell_force3_counted": cell_cuda3.COUNTED_LAUNCHES, "migrate3": migrate_cuda3.LAUNCHES,
             "leapfrog_step": leapfrog_cuda.STEP_LAUNCHES, "cell_force3_list": cell_cuda3.LIST_LAUNCHES,
             "cell_list3_build": cell_cuda3.LIST_BUILD_LAUNCHES, "alloc3": alloc_cuda.LAUNCHES}
    report_run(res3, "6 lj_fluid.run dim=3", path3, path3["migrate3"], cfg3)
    check_run(res3, "3D main path", cfg3)
    if path3["alloc3"] != path3["migrate3"]:
        raise AssertionError(f"3D main path: {path3['alloc3']} allocations on the card, {path3['migrate3']} rebuilds")
    for name, count in path3.items():
        if count <= 0:
            raise AssertionError(f"3D main path never launched kernel {name}")
    if cell_cuda3.STATIC_LAUNCHES or cell_cuda3.LOOP_LAUNCHES:
        raise AssertionError("3D main path launched B5's full loop or B4's loop")
    launches.update(path3)
    loop_main3 = cell_cuda3.LOOP_LAUNCHES  # B4's loop on the 3D main path: 0

    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import profile_device

    def busy_line(label, res_run, c, traced_run, kernel_keys, kernel_label):
        """The card's busy share over ``traced_run``'s steps (traced) against
        the run's untraced production ms/step, and the named kernels' share
        of device time; prints the profiler's table and the line."""
        dev_s, table, by_name = traced_run
        busy = 1e3 * dev_s / (2 * c.sample_every)
        wall = 1e3 * res_run.time_prod_s / c.prod_steps
        k_ms = 1e3 * sum(v for k, v in by_name.items() if any(n in k for n in kernel_keys)) / (2 * c.sample_every)
        if k_ms <= 0:
            raise AssertionError(f"{label} profile: no {kernel_label} kernel in the trace")
        print(table)
        print(f"{label} profile (production, {2 * c.sample_every} traced steps): device busy {busy:.4f} ms/step "
              f"of {wall:.4f} ms/step untraced wall; busy share {busy / wall:.3f}, idle share "
              f"{1 - busy / wall:.3f}; {kernel_label} {k_ms:.4f} ms/step = {k_ms / busy:.3f} of device time",
              flush=True)

    traced2 = override(cfg, prod_steps=2 * cfg.sample_every)
    busy_line(f"{smi}: phase 5 2D N=100k", res, cfg,
              profile_device(lambda: lj_fluid.production(traced2, res.state, res.cadence),
                             os.path.join("chiprun_out", "chip_smoke_2d_trace.json")),
              ("cell_force_tile_kernel",), "B1")
    g5 = md.init(res.state.position, res.state.velocity)
    ops5 = _rebuild_ops_2d(md, md._window_for(g5, k)(g5), f"{smi}: phase 5 2D N=100k",
                         lambda sc, pl, fl, oc: designs2.previous(prev_b2, sc, pl, fl))
    extra["migrate"].update(rebuild_ops=ops5["ops"], previous_rebuild_ops=ops5["previous_ops"])

    traced3 = override(cfg3, prod_steps=2 * cfg3.sample_every)
    busy_line("phase 6 3D N=100k", res3, cfg3,
              profile_device(lambda: lj_fluid.production(traced3, res3.state, res3.cadence),
                             os.path.join("chiprun_out", "chip_smoke_3d_trace.json")),
              ("cell_force3_counted_kernel",), "B5 and B4 (the counted kernel)")
    md6 = lj_fluid._make_grid_md(cfg3, dev)
    g6 = md6.init(res3.state.position, res3.state.velocity)
    _rebuild_ops(md6, md6._window_for(g6, res3.cadence or 9)(g6), "phase 6 3D N=100k")

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

    def same(got, want) -> bool:
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, want))

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
    errors["cell_force3_counted"] = _max_diff(b5, r5, occ3, "B5 forces", 1e-4)
    f3max = float(torch.stack(r4).norm(dim=0)[occ3].max())
    # B5 as launched (the counted kernel) against B5's full loop, B4 as
    # launched (the counted kernel at the capacity's shared memory) against
    # B4's loop, both variants: the same pairs in the same order, so the same
    # bits; and B4 and B5 agree bit for bit where max_occ <= cov
    b5e = cell_cuda3.grid_force3(*args3, with_energy=True, static_cov=cov)
    err5e = max(_max_diff(b5e[:3], r4e[:3], occ3, "B5 energy variant forces", 1e-4),
                _sums_close(b5e[3:], r4e[3:], "B5 energy variant", 1e-5))
    for energy, got, got4 in ((False, b5, b4), (True, b5e, b4e)):
        if not same(got, cell_cuda3.grid_force3_static_loop(*args3, cov, energy)):
            raise AssertionError(f"B5 (energy {energy}): the counted kernel is not torch.equal to B5's full loop")
        if not same(got, cell_cuda3.grid_force3(*args3, with_energy=energy, static_cov=cov)):
            raise AssertionError(f"B5 (energy {energy}): two launches on one input are not bit-equal")
        if not same(got4, cell_cuda3.grid_force3_loop(*args3, max_occ=gs3.max_occ, with_energy=energy)):
            raise AssertionError(f"B4 (energy {energy}): the counted kernel is not torch.equal to B4's loop")
        if not same(got4, cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ, with_energy=energy)):
            raise AssertionError(f"B4 (energy {energy}): two launches on one input are not bit-equal")
        if not same(got4, got):
            raise AssertionError(f"B4 and B5 (energy {energy}) differ at max occupancy {mo} <= cov {cov}")
    strip4 = cell_cuda3.strip_width(p3, md3.cps, None, False, dev)

    # the partner list on the same state, at B5 and at B4 (as the windows
    # build it): the build kernel against its plain version (counts,
    # entries, targets marked full), the list form torch.equal to the
    # counted kernel on the positions the list was built on and over two
    # launches, and within 1e-4 of its plain version
    lists3 = {}
    for label, lcov, lb in (("B5", cov, cov), ("B4", None, mo)):
        pl, full = cell_cuda3.build_partner_list3(*args3, md3.list_r2, md3.list_cap, gs3.max_occ, lcov)
        want, n_full = cell_cuda3.build_partner_list3_reference(*args3, md3.list_r2, md3.list_cap, lb, lcov or 0,
                                                                pl.strip)
        occ_b = coords3[0].view(md3.cps, md3.cap, md3.cps, md3.cps)[:, :lb] != p3.sentinel
        torch.cuda.synchronize()
        if not (_lists_equal(pl, want, occ_b) and int(full) == int(n_full)):
            raise AssertionError(f"{label} list build: counts, entries or the {int(full)} targets marked full "
                                 f"differ from the plain version's ({int(n_full)})")
        got = cell_cuda3.grid_force3(*args3, gs3.max_occ, static_cov=lcov, plist=pl)
        if not same(got, b5 if lcov else b4):
            raise AssertionError(f"{label} list form: not torch.equal to the counted kernel")
        if not same(got, cell_cuda3.grid_force3(*args3, gs3.max_occ, static_cov=lcov, plist=pl)):
            raise AssertionError(f"{label} list form: two launches on one input are not bit-equal")
        err = _max_diff(got, cell_cuda3.grid_force3_list_reference(*args3, pl, lb), occ3,
                        f"{label} list form forces", 1e-4)
        lists3[label] = (pl, lb, err, *_list_use(pl, occ_b))
        del want, got
    errors["cell_force3_list"] = max(v[2] for v in lists3.values())
    errors["cell_list3_build"] = 0.0

    # the hybrid windows' other state: the melt 90 steps from the lattice at
    # the same N, its fullest cell above cov, where the windows run B4 (the
    # main path's equilibration ran B4 there); B4 in both variants, with its
    # run-time bound and at the full capacity, torch.equal to B4's loop
    st7 = lj_fluid.init_state(cfg3, dev)
    gm = md3.make_production_run_fixed(90, 9)(md3.init(st7.position, st7.velocity))
    mo_m, occm = int(gm.max_occ), gm.occ > 0.5
    if mo_m <= cov:
        raise AssertionError(f"phase 7 melt state: max occupancy {mo_m} <= B5 bound {cov}")
    argm = (gm.xg, gm.yg, gm.zg, p3)
    for energy in (False, True):
        got = cell_cuda3.grid_force3(*argm, max_occ=gm.max_occ, with_energy=energy)
        for other in (cell_cuda3.grid_force3_loop(*argm, max_occ=gm.max_occ, with_energy=energy),
                      cell_cuda3.grid_force3(*argm, max_occ=gm.max_occ, with_energy=energy),
                      cell_cuda3.grid_force3(*argm, with_energy=energy)):
            if not same(got, other):
                raise AssertionError(f"B4 (energy {energy}) at max occupancy {mo_m} > cov {cov}: not torch.equal "
                                     "to B4's loop, to a second launch or to B4 at the full capacity")
        ref = cell_cuda3.grid_force3_reference(*argm, mo_m, with_energy=energy)
        err = _max_diff(got[:3], ref[:3], occm, "B4 forces above cov", 1e-4)
        if energy:
            err = max(err, _sums_close(got[3:], ref[3:], "B4 energy variant above cov", 1e-5))
        errors["cell_force3_energy" if energy else "cell_force3"] = max(
            errors["cell_force3_energy" if energy else "cell_force3"], err)
        del got, ref

    # B6 and B7 (one launch each) on the rebuild's inputs as the engine
    # passes them (the planes where they lie, the allocation's occupancy),
    # against the plain version, the plain flag and the previous design
    # (fill + scatter + plain flag, tests/torch_migrate3_designs.py)
    designs = _designs("torch_migrate3_designs")
    prev_b6 = designs.build(_build.BUILD_DIR / "designs")
    scode3, occ_new3, planes3, fills3 = designs.rebuild_inputs(md3, gs3)
    fields3 = torch.stack(planes3)
    k_mov = md3.migrate_k_mov
    movers3 = int(((scode3 >= 0) & (torch.div(scode3, md3.cap, rounding_mode="floor") != migrate_cuda3.STAY)).sum())
    m6, mov_of = migrate_cuda3.migrate3(scode3, planes3, fills3, k_mov=k_mov, occ=occ_new3)
    m7, _ = migrate_cuda3.migrate3(scode3, planes3, fills3, occ=occ_new3)
    mr = migrate_cuda3.migrate3_reference(scode3, fields3, fills3)
    mp, mov_p = designs.previous(prev_b6, scode3, planes3, fills3, k_mov)
    for name, got in (("B6", m6), ("B7", m7), ("the previous B6 design", mp)):
        if not torch.equal(got, mr):
            raise AssertionError(f"{name}: kernel output is not bit-equal to the plain version")
    if not bool(mov_of) is bool(mov_p) is bool(migrate_cuda3.mover_overflow(scode3, k_mov)):
        raise AssertionError("B6's mover flag differs from mover_overflow's")
    errors["migrate3"] = errors["migrate3_flat"] = 0.0
    # a state that trips the flag: the 3D lattice start at N=8192 with k_mov
    # 8 (the JAX package's lj_fluid value), at its first rebuild whose codes
    # have more than 8 movers in a cell
    cfg8 = override(cfg3, n=8192)
    md8 = GridMD3(lj_fluid._make_grid_md(cfg8, dev).grid_fn, dt=cfg.dt, compensated=True, static_cov="auto",
                  migrate_k_mov=8, device=dev)
    s8 = lj_fluid.init_state(cfg8, dev)
    g8 = md8.init(s8.position, s8.velocity)
    k8, gate8 = lj_fluid._grid_inner_steps(cfg8, md8)
    for window8 in range(1, 101):  # gated windows, until the codes have > 8 movers in a cell
        g8 = md8._window_for(g8, k8)(g8)
        sc8, oc8, pl8, fl8 = designs.rebuild_inputs(md8, g8)
        if bool(migrate_cuda3.mover_overflow(sc8, 8)):
            break
        if bool(md8._needs_rebuild(g8, gate8)):
            g8 = md8._rebuild_migrate(g8)
    else:
        raise AssertionError(f"N=8192 lattice start: no window in {100 * k8} steps with > 8 movers in a cell")
    got8, flag8 = migrate_cuda3.migrate3(sc8, pl8, fl8, k_mov=8, occ=oc8)
    if not (torch.equal(got8, migrate_cuda3.migrate3_reference(sc8, torch.stack(pl8), fl8)) and bool(flag8)):
        raise AssertionError("B6 at N=8192, k_mov 8: output or mover flag differs from the plain version's")

    t7 = interleaved_ms({
        "B4": lambda: cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ),
        "B4's loop": lambda: cell_cuda3.grid_force3_loop(*args3, max_occ=gs3.max_occ),
        "B5": lambda: cell_cuda3.grid_force3(*args3, static_cov=cov),
        "B4 energy": lambda: cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ, with_energy=True),
        "B4's loop energy": lambda: cell_cuda3.grid_force3_loop(*args3, max_occ=gs3.max_occ, with_energy=True),
        # B4 at the strip widths ceil(19 / k), k = 1 to 4 (its default: strip4)
        **{f"B4 strip {w}": (lambda w=w: cell_cuda3._forces3(args3[:3], p3, gs3.max_occ, False, None, False,
                                                            strip=w))
           for w in sorted({-(-md3.cps // k) for k in range(1, 5)}, reverse=True)},
    }, lead=True)
    t7m = interleaved_ms({
        "B4": lambda: cell_cuda3.grid_force3(*argm, max_occ=gm.max_occ),
        "B4 full capacity": lambda: cell_cuda3.grid_force3(*argm),
        "B4's loop": lambda: cell_cuda3.grid_force3_loop(*argm, max_occ=gm.max_occ),
        "B5": lambda: cell_cuda3.grid_force3(*argm, static_cov=cov),
        "B4 energy": lambda: cell_cuda3.grid_force3(*argm, max_occ=gm.max_occ, with_energy=True),
        "B4 energy full capacity": lambda: cell_cuda3.grid_force3(*argm, with_energy=True),
        "B4's loop energy": lambda: cell_cuda3.grid_force3_loop(*argm, max_occ=gm.max_occ, with_energy=True),
    }, lead=True)
    pl5, pl4 = lists3["B5"][0], lists3["B4"][0]
    t7l3 = interleaved_ms({
        "B5 list": lambda: cell_cuda3.grid_force3(*args3, static_cov=cov, plist=pl5),
        "B5": lambda: cell_cuda3.grid_force3(*args3, static_cov=cov),
        "B4 list": lambda: cell_cuda3.grid_force3(*args3, gs3.max_occ, plist=pl4),
        "B4": lambda: cell_cuda3.grid_force3(*args3, max_occ=gs3.max_occ),
        "B5 build": lambda: cell_cuda3.build_partner_list3(*args3, md3.list_r2, md3.list_cap, static_cov=cov),
        "B4 build": lambda: cell_cuda3.build_partner_list3(*args3, md3.list_r2, md3.list_cap, gs3.max_occ),
    }, lead=True)
    t7mig = interleaved_ms({
        "B6": lambda: migrate_cuda3.migrate3(scode3, planes3, fills3, k_mov=k_mov, occ=occ_new3),
        "previous B6": lambda: designs.previous(prev_b6, scode3, planes3, fills3, k_mov),
        "B7": lambda: migrate_cuda3.migrate3(scode3, planes3, fills3, occ=occ_new3),
        "previous B7": lambda: designs.previous(prev_b6, scode3, planes3, fills3),
    }, lead=True)
    times["cell_force3"] = (t7["B4"][0], cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, mo), 5))
    times["cell_force3_energy"] = (
        t7["B4 energy"][0], cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, mo, with_energy=True), 5))
    t7c, strip7 = _counted_times(args3, cov, False)
    times["cell_force3_counted"] = (t7c["counted"][0], cuda_ms(lambda: cell_cuda3.grid_force3_reference(*args3, cov), 5))
    extra["cell_force3_counted"] = {"loop_ms": t7c["loop"][0], "strip": strip7}
    plain_m3 = cuda_ms(lambda: migrate_cuda3.migrate3_reference(scode3, fields3, fills3), 10)
    times["migrate3"] = (t7mig["B6"][0], plain_m3)
    times["migrate3_flat"] = (t7mig["B7"][0], plain_m3)
    work3 = _pair_work(coords3, gs3.occ, md3.cps, mo, md3.box, p3.cutoff2)
    bounds["cell_force3"], bounds["cell_force3_energy"] = _force_bounds(work3, 3, gs3.xg.numel())
    bounds["cell_force3_counted"] = bounds["cell_force3"]
    workm = _pair_work(argm[:3], gm.occ, md3.cps, mo_m, md3.box, p3.cutoff2)
    bm, bme = _force_bounds(workm, 3, gm.xg.numel())
    extra["cell_force3"] = {"loop_ms": t7["B4's loop"][0], "strip": strip4, "above_cov_ms": t7m["B4"][0],
                            "above_cov_loop_ms": t7m["B4's loop"][0],
                            "above_cov_full_capacity_ms": t7m["B4 full capacity"][0],
                            "above_cov_bound_ms": bm[0]}
    extra["cell_force3_energy"] = {"loop_ms": t7["B4's loop energy"][0], "above_cov_ms": t7m["B4 energy"][0],
                                   "above_cov_loop_ms": t7m["B4's loop energy"][0], "above_cov_bound_ms": bme[0]}
    # the flag's byte is not counted
    bounds["migrate3"] = bounds["migrate3_flat"] = _migrate_bound(len(planes3), gs3.xg.numel(), int(occ_new3.sum()))
    extra["migrate3"] = {"previous_ms": t7mig["previous B6"][0]}
    extra["migrate3_flat"] = {"previous_ms": t7mig["previous B7"][0]}
    # the list form tests the listed entries of each target (a full one:
    # a mean target's candidates) and reads the list's words; the build
    # tests every candidate and writes them
    words5, full5, listed5 = lists3["B5"][3:]
    tests5 = listed5 + full5 * work3[0] // int(occ3.sum())
    times["cell_force3_list"] = (t7l3["B5 list"][0],
                                 cuda_ms(lambda: cell_cuda3.grid_force3_list_reference(*args3, pl5, cov), 5))
    times["cell_list3_build"] = (t7l3["B5 build"][0], cuda_ms(
        lambda: cell_cuda3.build_partner_list3_reference(*args3, md3.list_r2, md3.list_cap, cov, cov, pl5.strip), 5))
    bounds["cell_force3_list"] = _force_bounds((tests5, work3[1]), 3, gs3.xg.numel(), extra_in_bytes=2 * words5)[0]
    bounds["cell_list3_build"] = roofline.bound(8 * work3[0], 12 * gs3.xg.numel() + 2 * words5)
    extra["cell_force3_list"] = {"counted_ms": t7l3["B5"][0], "b4_ms": t7l3["B4 list"][0],
                                 "b4_counted_ms": t7l3["B4"][0], "k": md3.list_cap, "strip": pl5.strip,
                                 "tests": tests5, "full": full5, "b4_full": lists3["B4"][4]}
    extra["cell_list3_build"] = {"b4_ms": t7l3["B4 build"][0], "words": words5}
    print(f"phase 7 B4 forces: max abs diff {errors['cell_force3']:.3e} (max |f| {f3max:.1f}); "
          f"B4 energy variant: forces {err4ef:.3e}, e/w max abs diff {err4e:.3e}, sums within rtol "
          f"1e-5; B5: vs plain {errors['cell_force3_counted']:.3e}, energy variant vs B4's {err5e:.3e}, "
          f"both variants torch.equal to B5's full loop and over two launches; B4 (the counted kernel, strip "
          f"{strip4}) both variants torch.equal to B4's loop, over two launches and to B5 (max occupancy {mo} "
          f"<= cov {cov}); B6, B7 and the previous B6 design: bit-equal to the plain version, {movers3} movers, "
          f"mov_of {bool(mov_of)} (k_mov {k_mov}); at N=8192 (k_mov 8) the codes after window {window8} trip the flag: B6 "
          f"bit-equal, mov_of True; pair work: {work3[0]} distance tests, {work3[1]} in the cutoff", flush=True)
    print(f"phase 7 melt state (90 steps from the lattice): max occupancy {mo_m} > cov {cov}; B4 both variants "
          f"torch.equal to B4's loop, over two launches and at the full capacity ({md3.cap}), within 1e-4 of the "
          f"plain version; pair work {workm[0]} distance tests, {workm[1]} in the cutoff; bound {bm[0]:.5f} ms, "
          f"energy {bme[0]:.5f} ms", flush=True)
    print(f"phase 7 partner list (k {md3.list_cap}, radius {math.sqrt(md3.list_r2):.5f}, strip {pl5.strip}): "
          f"B5's and B4's builds bit-equal to the plain version (targets marked full: B5 {full5}, B4 "
          f"{lists3['B4'][4]}); the list form at B5 and B4 torch.equal to the counted kernel and over two "
          f"launches, within {errors['cell_force3_list']:.3e} of its plain version; {tests5} listed tests "
          f"against {work3[0]} candidates ({work3[0] / max(tests5, 1):.2f}x), {words5} list words", flush=True)
    for label, tt in ((f"phase 7 B4 (max occupancy {mo} <= cov {cov})", t7),
                      ("phase 7 the list form and its build against the counted kernel", t7l3),
                      (f"phase 7 B4 on the melt state (max occupancy {mo_m} > cov {cov})", t7m),
                      ("phase 7 B6, B7 and the previous design", t7mig)):
        print(f"{smi}: {label} (medians of 7 interleaved repeats of 20 calls, lead): "
              + ", ".join(f"{k} {spread(v)}" for k, v in tt.items()), flush=True)
    print(f"phase 7 B4 against B5 on one state within cov: {t7['B4'][0]:.4f} against {t7['B5'][0]:.4f} ms "
          f"({t7['B4'][0] / t7['B5'][0] - 1:+.1%})", flush=True)
    for name in ("cell_force3", "cell_force3_energy", "cell_force3_counted", "cell_force3_list", "cell_list3_build",
                 "migrate3", "migrate3_flat"):
        print(f"phase 7 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
    _print_counted_times("phase 7 B5", t7c, strip7, bounds["cell_force3"], md3.cps)
    t7l, b7l = _leapfrog_checked_times(md3, gs3, f"7 3D N={cfg3.n}")
    del b4, r4, b4e, r4e, b5, b5e, r5, m6, m7, mr, mp, gm, g8, md8, lists3, pl5, pl4

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
    if int(finals[False].mover_flags) != 0:
        raise AssertionError("the B7 run counted a mover flag")
    print(f"phase 10 {flat_steps} steps at cadence {cadence} from the equilibrated 3D state: "
          f"{launches['migrate3_flat']} B7 launches, final state bit-equal to the B6 run; overflow "
          f"B7 {bool(finals[False].overflow)}, B6 {bool(finals[True].overflow)}; mover flags B6 "
          f"{int(finals[True].mover_flags)}", flush=True)

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
    times["pairwise_lj"] = (cuda_ms(lambda: pairwise_cuda.lj_force_pairwise(pos_d, pp), 50),
                            cuda_ms(lambda: pairwise_cuda.lj_force_pairwise_reference(pos_d, pp), 5))
    times["pairwise_lj_energy"] = (
        cuda_ms(lambda: pairwise_cuda.lj_force_pairwise(pos_d, pp, True), 50),
        cuda_ms(lambda: pairwise_cuda.lj_force_pairwise_reference(pos_d, pp, True), 5))
    bounds["pairwise_lj"], bounds["pairwise_lj_energy"] = roofline.pairwise_bounds(dense.n, 2)
    row_blocks, slices, slice_len = pairwise_cuda._geometry(dense.n)
    print(f"phase 11 B8 launch at N={dense.n}: {row_blocks} row blocks of {pairwise_cuda.ROWS} "
          f"i-particles ({pairwise_cuda.THREADS} threads, 4 each) x {slices} j slices of {slice_len} = "
          f"{row_blocks * slices} blocks, then the slice sum", flush=True)
    for name in ("pairwise_lj", "pairwise_lj_energy"):
        print(f"phase 11 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call = "
              f"{bounds[name][0] / times[name][0]:.3f} of the bound", flush=True)
    print(f"phase 11 B8 N={dense.n}: {times['pairwise_lj'][0]:.4f} ms a call against the previous design's "
          f"{PREVIOUS_B8_MS} ms and the bound {bounds['pairwise_lj'][0]:.5f} ms", flush=True)

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

    traced = override(dense, prod_steps=2 * dense.sample_every)
    busy_line("phase 12 all pairs N=16,384", resd, dense,
              profile_device(lambda: lj_fluid.production(traced, resd.state),
                             os.path.join("chiprun_out", "chip_smoke_dense_trace.json")),
              ("pairwise_lj_kernel", "pairwise_reduce_kernel"), "B8 (pair kernel and slice sum)")

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
        cnt = g.counts
        xu, yu = (cell_cuda_packed.unpack(t, r).contiguous() for t in (g.xg, g.yg))

        def b3(energy=False):
            return cell_cuda_packed.grid_force_packed(g.xg, g.yg, cnt, pk, r, with_energy=energy)

        def b1_unpacked(energy=False):
            return cell_cuda.grid_force_loop(xu, yu, pk, with_energy=energy)

        f1, f2, e1, e2 = b3(), b3(), b3(True), b3(True)
        fr = cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r)
        er = cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r, with_energy=True)
        # the frozen yardstick: B1's full-capacity loop on the unpacked view
        # sums the same pairs in the same order
        yard = tuple(cell_cuda_packed.pack(t, r) for t in b1_unpacked() + b1_unpacked(True))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(f1 + e1, f2 + e2)):
            raise AssertionError(f"B3 {label}: two launches on one input are not bit-equal")
        if not all(torch.equal(a, b) for a, b in zip(f1 + e1, yard)):
            raise AssertionError(f"B3 {label}: not bit-equal to B1's loop on the unpacked grids")
        err_f = _max_diff(f1, fr, occ_p, f"B3 {label} forces", 1e-4)
        err_ef3 = _max_diff(e1[:2], er[:2], occ_p, f"B3 {label} energy variant forces", 1e-4)
        err_e3 = _sums_close(e1[2:], er[2:], f"B3 {label} energy variant", 1e-5)
        t15 = interleaved_ms({"b3": b3, "b1": b1_unpacked, "b3_e": lambda: b3(True),
                               "b1_e": lambda: b1_unpacked(True)})
        t_f = (t15["b3"][0], cuda_ms(lambda: cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r), 5))
        t_e = (t15["b3_e"][0],
               cuda_ms(lambda: cell_cuda_packed.grid_force_packed_reference(g.xg, g.yg, pk, r, with_energy=True), 5))
        work_p = _pair_work((xu, yu), cell_cuda_packed.unpack(g.occ, r), m.cps, m.cap, m.box, pk.cutoff2)
        b_f, b_e = _force_bounds(work_p, 2, g.xg.numel(), extra_in_bytes=cnt.numel() * cnt.element_size())
        # B3's partner list on the same state (as the windows build it): the
        # build kernel against its plain version (prefix, counts, entries,
        # targets marked full), the list form torch.equal to B3 on the
        # positions the list was built on and over two launches, within 1e-4
        # of its plain version; the list form, its build and B3 timed in turns
        pl, full_l = cell_cuda_packed.build_partner_list2(g.xg, g.yg, cnt, pk, r, m.list_r2, m.list_cap, m.n)
        want_l, n_full_l = cell_cuda_packed.build_partner_list2_reference(g.xg, g.yg, cnt, pk, r, m.list_r2,
                                                                          m.list_cap, pl.stride, pl.strip)
        _, num_l, _ = cell_cuda_packed._targets(cnt, pl, m.cap)
        torch.cuda.synchronize()
        if not (_lists2_equal(pl, want_l, cnt, m.cap) and int(full_l) == int(n_full_l)):
            raise AssertionError(f"B3 list build {label}: the numbering, counts, entries or the {int(full_l)} "
                                 f"targets marked full differ from the plain version's ({int(n_full_l)})")
        fl = cell_cuda_packed.grid_force_packed(g.xg, g.yg, cnt, pk, r, plist=pl)
        if not (all(torch.equal(a, b) for a, b in zip(fl, f1))
                and all(torch.equal(a, b) for a, b in zip(fl, cell_cuda_packed.grid_force_packed(
                    g.xg, g.yg, cnt, pk, r, plist=pl)))):
            raise AssertionError(f"B3 list form {label}: not torch.equal to B3, or two launches differ")
        err_l = _max_diff(fl, cell_cuda_packed.grid_force_packed_list_reference(g.xg, g.yg, cnt, pk, r, pl), occ_p,
                          f"B3 list form {label}", 1e-4)
        t15l = interleaved_ms({
            "b3": b3, "list": lambda: cell_cuda_packed.grid_force_packed(g.xg, g.yg, cnt, pk, r, plist=pl),
            "build": lambda: cell_cuda_packed.build_partner_list2(g.xg, g.yg, cnt, pk, r, m.list_r2, m.list_cap,
                                                                  m.n)})
        words_l, full_n, listed_n = _list2_use(pl, num_l)
        tests_l = listed_n + full_n * work_p[0] // int(cnt.sum())
        # the list form reads the count grid, the list's prefix and its used
        # words; the build tests every candidate (8 operations each) and
        # writes the words
        b_l = _force_bounds((tests_l, work_p[1]), 2, g.xg.numel(), extra_in_bytes=8 * cnt.numel() + 2 * words_l)[0]
        b_b = roofline.bound(8 * work_p[0], 8 * g.xg.numel() + 8 * cnt.numel() + 2 * words_l)
        packed[label] = dict(md=m, gs=g, errors=(err_f, max(err_ef3, err_e3)), times=(t_f, t_e), bounds=(b_f, b_e),
                             full=(t15["b1"][0], t15["b1_e"][0]),
                             list=dict(err=err_l, t=t15l, bounds=(b_l, b_b), words=words_l, full=full_n,
                                       tests=tests_l, k=m.list_cap, pl=pl, cnt=cnt))
        print(f"phase 15 {label}: B3's partner list (k {m.list_cap}, radius {math.sqrt(m.list_r2):.5f}): the build "
              f"equal to its plain version ({int(full_l)} targets full), the list form torch.equal to B3 and over "
              f"two launches, within {err_l:.3e} of its plain version; {tests_l} listed tests against "
              f"{work_p[0]} candidates; time (medians of 7 interleaved repeats of 20 calls): B3 "
              f"{spread(t15l['b3'])}, list form {spread(t15l['list'])}, build {spread(t15l['build'])}; bounds "
              f"{b_l[0]:.5f} ms ({b_l[1]}), build {b_b[0]:.5f} ms ({b_b[1]})", flush=True)
        del want_l, fl
        print(f"phase 15 {label}: grid {tuple(g.xg.shape)} (R={r}, G={m.n_blocks}), {outside} particles "
              f"outside [0, box), {int(cnt.sum())} particles, at most {int(cnt.max())} a cell; B3 (force and "
              f"energy variants) torch.equal to B1's loop on the unpacked grids and over two launches; forces max abs "
              f"diff {err_f:.3e} from the plain version (max |f| {float(torch.hypot(fr[0], fr[1])[occ_p].max()):.1f}); "
              f"energy variant: forces {err_ef3:.3e}, e/w max abs diff {err_e3:.3e}, sums within rtol 1e-5; "
              f"pair work: {work_p[0]} distance tests, {work_p[1]} in the cutoff", flush=True)
        for name, t, b, kk, kb in (("cell_force_packed", t_f, b_f, "b3", "b1"),
                                   ("cell_force_packed_energy", t_e, b_e, "b3_e", "b1_e")):
            print(f"phase 15 {label} time {name}: kernel {spread(t15[kk])}, B1's full-capacity loop on the "
                  f"unpacked grids {spread(t15[kb])} (medians of 7 interleaved repeats of 20 calls); plain "
                  f"{t[1]:.4f} ms, bound {b[0]:.5f} ms ({b[1]}) per call", flush=True)
        del f1, f2, fr, e1, e2, er, yard, xu, yu

    # B2 packed at both shapes, as in phase 2; at N=1M also the movers across
    # a block seam and one rebuild's device ops with B2 and the previous design
    t15m = {}
    for label in ("N=16,384", "N=1M"):
        mq, gq = packed[label]["md"], packed[label]["gs"]
        t15m[label] = _b2_checked_times(designs2, prev_b2, mq, gq, label)
    m1, g1 = packed["N=1M"]["md"], packed["N=1M"]["gs"]
    r1 = m1.rows_per_block
    tq, hostq, plainq, (scode_p, occ_p, planes_p, _) = t15m["N=1M"]
    sub = torch.div(torch.arange(m1.lanes, device=dev), m1.cps, rounding_mode="floor")
    dxp = torch.div(torch.div(scode_p, m1.cap, rounding_mode="floor"), 3, rounding_mode="floor") - 1
    crossing = int(((scode_p >= 0) & (((dxp == -1) & (sub == 0)) | ((dxp == 1) & (sub == r1 - 1)))).sum())
    if crossing <= 0:
        raise AssertionError("B2 packed N=1M: no mover across a block seam")
    errors["migrate_packed"] = 0.0
    times["migrate_packed"] = (tq["B2"][0], plainq)
    bounds["migrate_packed"] = _migrate_bound(len(planes_p), g1.xg.numel(), int(occ_p.sum()))
    t16, host16, plain16, (_, occ16, planes16, _) = t15m["N=16,384"]
    g16s = packed["N=16,384"]["gs"]
    b16 = _migrate_bound(len(planes16), g16s.xg.numel(), int(occ16.sum()))
    ops15 = _rebuild_ops_2d(m1, g1, f"{smi}: phase 15 N=1M packed (R={r1})",
                          lambda sc, pl, fl, oc: designs2.previous(prev_b2, sc, pl, fl, r1))
    extra["migrate_packed"] = {**_b2_extra(tq, hostq), "rebuild_ops": ops15["ops"],
                               "previous_rebuild_ops": ops15["previous_ops"], "n16384_ms": t16["B2"][0],
                               "n16384_plain_ms": plain16, "n16384_bound_ms": b16[0],
                               **_b2_extra(t16, host16, "n16384_")}
    for i, name in enumerate(("cell_force_packed", "cell_force_packed_energy")):
        errors[name] = packed["N=1M"]["errors"][i]
        times[name] = packed["N=1M"]["times"][i]
        bounds[name] = packed["N=1M"]["bounds"][i]
        extra[name] = {"full_capacity_ms": packed["N=1M"]["full"][i]}
    l1m, l16 = packed["N=1M"]["list"], packed["N=16,384"]["list"]
    errors["cell_force_list"], errors["cell_list_build"] = l1m["err"], 0.0
    times["cell_force_list"] = (l1m["t"]["list"][0], cuda_ms(lambda: cell_cuda_packed.grid_force_packed_list_reference(
        g1.xg, g1.yg, l1m["cnt"], m1._params, r1, l1m["pl"]), 3))
    times["cell_list_build"] = (l1m["t"]["build"][0], cuda_ms(lambda: cell_cuda_packed.build_partner_list2_reference(
        g1.xg, g1.yg, l1m["cnt"], m1._params, r1, m1.list_r2, m1.list_cap, l1m["pl"].stride, l1m["pl"].strip), 3))
    bounds["cell_force_list"], bounds["cell_list_build"] = l1m["bounds"]
    extra["cell_force_list"] = {"counted_ms": l1m["t"]["b3"][0], "k": l1m["k"], "tests": l1m["tests"],
                                "full": l1m["full"], "words": l1m["words"], "n16384_ms": l16["t"]["list"][0],
                                "n16384_counted_ms": l16["t"]["b3"][0], "n16384_bound_ms": l16["bounds"][0][0]}
    extra["cell_list_build"] = {"words": l1m["words"], "n16384_ms": l16["t"]["build"][0],
                                "n16384_bound_ms": l16["bounds"][1][0]}
    for label, (tt, hh, pl_ms, _) in t15m.items():
        bb = bounds["migrate_packed"] if label == "N=1M" else b16
        print(f"{smi}: phase 15 B2 packed {label} (R={packed[label]['md'].rows_per_block}): B2 and its previous "
              f"design bit-equal to the plain version, also at overflow"
              + (f", {crossing} movers across a block seam" if label == "N=1M" else "")
              + f"; time (medians of 7 interleaved repeats of 20 calls, lead): B2 {spread(tt['B2'])}, the previous "
              f"design (stack, fill, scatter) {spread(tt['previous'])}, its stack {spread(tt['stack'])}, fill "
              f"{spread(tt['fill'])}, scatter {spread(tt['scatter'])}; plain {pl_ms:.4f} ms; bound {bb[0]:.5f} ms "
              f"({bb[1]}); host us a call: B2 {hh['B2']:.1f}, previous {hh['previous']:.1f}", flush=True)
    del t15m, scode_p, occ_p, planes_p, occ16, planes16
    t15l, b15l = _leapfrog_checked_times(m1, g1, f"15 N=1M packed (R={r1})")
    for name in ("step", "first", "close"):
        key = f"leapfrog_{name}"
        errors[key] = 0.0  # torch.equal to the eager window
        times[key] = (t15l[name][0], t15l["eager_" + name][0])
        bounds[key] = b15l[name]
        extra[key] = {"dim3_ms": t7l[name][0], "dim3_plain_ms": t7l["eager_" + name][0],
                      "dim3_bound_ms": b7l[name][0]}

    # -- 16. B3 against the dense oracle ----------------------------------------
    m16, g16 = packed["N=16,384"]["md"], packed["N=16,384"]["gs"]
    fx16, fy16 = m16.force_kernel(g16.xg, g16.yg, g16.counts)
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
                  "migrate_packed": migrate_cuda.PACKED_LAUNCHES,
                  "cell_force_list": cell_cuda_packed.LIST_LAUNCHES,
                  "cell_list_build": cell_cuda_packed.LIST_BUILD_LAUNCHES}
        if not mp.partner_list or resp.list_overflows:
            raise AssertionError(f"packed main path N={c.n}: partner list on {mp.partner_list}, "
                                 f"{resp.list_overflows} targets over its capacity")
        unpacked = (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES, migrate_cuda.LAUNCHES, *loop_launches().values())
        print(f"phase 17 N={c.n}: R={mp.rows_per_block}, G={mp.n_blocks}, grid {mp.grid_shape}, "
              f"{kp}-step windows at gate {gp}", flush=True)
        report_run(resp, "17 lj_fluid.run packed", path_p, path_p["migrate_packed"], c)
        check_run(resp, f"packed main path N={c.n}", c)
        for name, count in path_p.items():
            if count <= 0:
                raise AssertionError(f"packed main path N={c.n} never launched kernel {name}")
        if any(unpacked) or noise_cuda.LAUNCHES:
            raise AssertionError(f"packed main path N={c.n} launched B1, its loop, unpacked B2 or the Langevin "
                                 f"noise: {unpacked}, {noise_cuda.LAUNCHES}")
        windows = leapfrog_cuda.CLOSE_LAUNCHES
        if windows <= 0 or leapfrog_cuda.STEP_LAUNCHES < windows:
            raise AssertionError(f"packed main path N={c.n}: {leapfrog_cuda.STEP_LAUNCHES} fused step launches "
                                 f"in {windows} windows")
        print(f"phase 17 N={c.n}: L1 {leapfrog_cuda.STEP_LAUNCHES} step launches (one a step) and {windows} "
              f"closing launches (one a window) over {c.eq_steps + c.prod_steps} steps of the run; B3's list "
              f"form {path_p['cell_force_list']} launches, its build {path_p['cell_list_build']}", flush=True)
        if c is cfg16:
            # the same run with the partner list off: B3's counted loop every step
            off = lj_fluid._make_grid_md(c, dev)
            off.partner_list = False
            reset_counts()
            res_off = lj_fluid.run(c, device="cuda", md=off)
            check_run(res_off, f"packed main path N={c.n}, list off", c)
            if cell_cuda_packed.LIST_LAUNCHES or cell_cuda_packed.LIST_BUILD_LAUNCHES:
                raise AssertionError(f"packed main path N={c.n}, list off: the list form ran")
            report_run(res_off, "17 lj_fluid.run packed, partner list off", {}, migrate_cuda.PACKED_LAUNCHES, c)
        if c is cfg1m:
            launches.update(path_p)
            # a window's first step and its close are one launch each
            launches.update(leapfrog_step=leapfrog_cuda.STEP_LAUNCHES - windows, leapfrog_first=windows,
                            leapfrog_close=windows)

    traced1m = override(cfg1m, prod_steps=2 * cfg1m.sample_every)
    busy_line("phase 17 N=1M", resp, cfg1m,
              profile_device(lambda: lj_fluid.production(traced1m, resp.state),
                             os.path.join("chiprun_out", "chip_smoke_1m_trace.json")),
              ("cell_force_counted_kernel",), "B3")
    del resp

    # -- 18. the packed engine at N=4096 on the card against the CPU -----------
    small18 = override(cfg, n=4096)
    st18 = lj_fluid.init_state(small18, "cpu")
    gf18 = lj_fluid._make_grid_md(small18, "cpu").grid_fn
    k18, gate18 = lj_fluid._grid_inner_steps(small18, GridMD(gf18, device="cpu"))
    for r18 in (1, 4):
        ens = {}
        reset_counts()
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
        if r18 == 1 and (cell_cuda.LAUNCHES <= 0 or any(loop_launches().values())):
            raise AssertionError(f"phase 18 R=1: B1 launches {cell_cuda.LAUNCHES}, its loop's {loop_launches()}")
        print(f"phase 18 N=4096 engine with rows_per_block={r18} (grid {m18.grid_shape}), 200 steps: card and "
              f"CPU energies agree within rtol 1e-4 (max rel diff {rel18:.2e})", flush=True)

    # -- 19. Langevin ------------------------------------------------------------
    for dim in (2, 3):
        cl = override(cfg, dim=dim, thermostat="langevin", gamma=1.0)
        reset_counts()
        resl = lj_fluid.run(cl, device="cuda")
        check_run(resl, f"Langevin dim={dim}", cl, drift=False)
        # every Langevin step of the run draws once, its warm-up's included
        warm_l = min(cl.eq_steps, cl.sample_every) + min(cl.prod_steps, cl.sample_every)
        if resl.state.step != cl.eq_steps + cl.prod_steps or noise_cuda.LAUNCHES != resl.state.step + warm_l:
            raise AssertionError(f"Langevin dim={dim}: {noise_cuda.LAUNCHES} noise launches, global step "
                                 f"{resl.state.step}, over {cl.eq_steps + cl.prod_steps} + {warm_l} warm-up steps")
        if baoab_cuda.STEP_LAUNCHES != noise_cuda.LAUNCHES or leapfrog_cuda.STEP_LAUNCHES:
            raise AssertionError(f"Langevin dim={dim}: {baoab_cuda.STEP_LAUNCHES} BAOAB step launches beside "
                                 f"{noise_cuda.LAUNCHES} noise launches, {leapfrog_cuda.STEP_LAUNCHES} L1 steps")
        kt_prod = 2.0 * resl.ke_history.double() / (cl.n * dim)
        kt_mean = float(kt_prod.mean())
        if not abs(kt_mean - cl.kt) <= 0.05 * cl.kt:
            raise AssertionError(f"Langevin dim={dim}: mean production kT {kt_mean:.4f} not within 5% of {cl.kt}")
        ml = lj_fluid._make_grid_md(cl, dev)
        kl, gl = lj_fluid._grid_inner_steps(cl, ml)
        gsl = ml.init(resl.state.position, resl.state.velocity, seed=lj_fluid._grid_seed(cl), step=resl.state.step)
        reset_counts()
        gsl = ml.make_production_run(100, kl, gate_frac=gl, thermostat=lj_fluid._grid_thermostat(cl))(gsl)
        if noise_cuda.LAUNCHES != 100 or baoab_cuda.STEP_LAUNCHES != 100 or gsl.rng_counter != resl.state.step + 100:
            raise AssertionError(f"Langevin dim={dim}: {noise_cuda.LAUNCHES} noise launches and "
                                 f"{baoab_cuda.STEP_LAUNCHES} BAOAB step launches in 100 steps, global step "
                                 f"{resl.state.step} -> {gsl.rng_counter}")
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
              f"after 100 more steps: empty-slot |v| max {v_empty}, {int(gsl.occ.sum())} particles; noise "
              f"and BAOAB step launches one a step each", flush=True)
        if dim == 3:
            t19b3, b19b3 = _baoab_checked_times(ml, gsl, lj_fluid._grid_thermostat(cl), f"19 3D N={cl.n}")

    # the noise kernel at lj2d-nvt-n1m's grid, on the lattice start's ids
    c1l = override(cfg1m, thermostat="langevin", gamma=1.0)
    m1l = lj_fluid._make_grid_md(c1l, dev)
    k1l, g1l = lj_fluid._grid_inner_steps(c1l, m1l)
    st1l = lj_fluid.init_state(c1l, dev)
    seed1l, start1l = lj_fluid._grid_seed(c1l), 2**32 - 50
    gs1l = m1l.init(st1l.position, st1l.velocity, seed=seed1l, step=start1l)
    reset_counts()
    gs1l = m1l.make_production_run(200, k1l, gate_frac=g1l, thermostat=lj_fluid._grid_thermostat(c1l))(gs1l)
    if (noise_cuda.LAUNCHES != 200 or baoab_cuda.STEP_LAUNCHES != 200 or gs1l.rng_counter != start1l + 200
            or bool(gs1l.overflow)):
        raise AssertionError(f"Langevin N=1M: {noise_cuda.LAUNCHES} noise launches and {baoab_cuda.STEP_LAUNCHES} "
                             f"BAOAB step launches in 200 steps, global step {start1l} -> {gs1l.rng_counter}, "
                             f"overflow {bool(gs1l.overflow)}")
    launches["langevin_noise"] = noise_cuda.LAUNCHES
    launches["baoab_step"] = baoab_cuda.STEP_LAUNCHES
    windows1l = baoab_cuda.CLOSE_LAUNCHES
    t19b, b19b = _baoab_checked_times(m1l, gs1l, lj_fluid._grid_thermostat(c1l), "19 N=1M packed")
    spilled = {k: v for k, v in regs.items() if k.startswith("baoab_kernel") and v[1]}
    if spilled or not any(k.startswith("baoab_kernel") for k in regs):
        raise AssertionError(f"BAOAB kernels: spills {spilled}, registers {regs}")
    errors["baoab_step"] = 0.0  # torch.equal to the eager window
    times["baoab_step"] = (t19b["step"][0], t19b["eager_step"][0])
    bounds["baoab_step"] = b19b
    extra["baoab_step"] = {"dim3_ms": t19b3["step"][0], "dim3_plain_ms": t19b3["eager_step"][0],
                           "dim3_bound_ms": b19b3[0], "windows": windows1l,
                           "bound_share_pct": 100 * b19b[0] / t19b["step"][0]}
    pid1l, step1l = gs1l.pid, gs1l.rng_counter
    got1l = noise_cuda.langevin_noise(seed1l, step1l, pid1l, 2).cpu()
    want1l = noise_cuda.noise_reference(seed1l, step1l, pid1l.cpu(), 2)
    empty1l = pid1l.cpu() < 0
    if tuple(pid1l.shape) != (55, 16, 2695) or int((~empty1l).sum()) != c1l.n:
        raise AssertionError(f"Langevin N=1M: grid {tuple(pid1l.shape)}, {int((~empty1l).sum())} ids")
    if not bool((got1l[:, empty1l] == 0).all()):
        raise AssertionError("noise kernel: a non-zero draw in an empty slot")

    def ordered(x):
        # float32 values as integers in their order: a difference is a distance in ulps
        bits = x.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    ulps1l = int((ordered(got1l) - ordered(want1l)).abs().max())
    if ulps1l > 4:
        raise AssertionError(f"noise kernel: {ulps1l} float32 ulps from the plain version")
    occ1l = (pid1l >= 0).to(torch.float32)
    gen1l = torch.Generator(device=dev).manual_seed(seed1l)
    t19 = interleaved_ms({
        "kernel": lambda: noise_cuda.langevin_noise(seed1l, step1l, pid1l, 2),
        "plain": lambda: noise_cuda.noise_reference(seed1l, step1l, pid1l, 2),
        "randn": lambda: torch.randn((2,) + tuple(pid1l.shape), generator=gen1l, device=dev) * occ1l,
    }, lead=True)
    times["langevin_noise"] = (t19["kernel"][0], t19["plain"][0])
    errors["langevin_noise"] = float((got1l - want1l).abs().max())
    bounds["langevin_noise"] = roofline.bound(0.0, 4 * (1 + 2) * pid1l.numel())
    extra["langevin_noise"] = {"randn_ms": t19["randn"][0], "max_ulps": ulps1l, "grid": list(pid1l.shape),
                               "steps": 200}
    print(f"{smi}: phase 19 noise kernel at N=1M, grid {tuple(pid1l.shape)}: {ulps1l} float32 ulps at most "
          f"from the plain version, exact zeros on {int(empty1l.sum())} empty slots, "
          f"{launches['langevin_noise']} launches in 200 Langevin steps across the global step 2^32; "
          f"kernel {spread(t19['kernel'])}, plain {spread(t19['plain'])}, the per-window randn draw "
          f"{spread(t19['randn'])}; bound {bounds['langevin_noise'][0]:.5f} ms "
          f"({bounds['langevin_noise'][1]})", flush=True)
    del m1l, gs1l, st1l, pid1l, occ1l, got1l, want1l

    # -- 20. B9 through its factory ----------------------------------------------
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.gravity import Gravity

    rng = np.random.default_rng(2020)
    library = {}
    gdesigns = _designs("torch_gravity_designs")
    prev_b9 = gdesigns.build(_build.BUILD_DIR / "designs")
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
        # the previous design, the yardstick, within the same tolerance
        for got, want in zip(gdesigns.previous(prev_b9, pos_g, m_g, 1.0, 0.1, True), (a_r, phi_r)):
            if not float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()):
                raise AssertionError(f"the previous B9 design at N={n}: beyond 1e-5 * max |.| of the plain version")
        errors[names[0]], errors[names[1]] = float((a_k - a_r).abs().max()), max(
            float((a_kp - a_r).abs().max()), float((phi_k - phi_r).abs().max()))
        energy_s = ""
        if n == 16_384:
            e_k = 0.5 * float(torch.sum(m_g.double() * phi_k.double()))
            e_ref = float(Gravity(g=1.0, mode="plummer", softening=0.1).energy(pos_g.double(), m_g.double()))
            if not abs(e_k - e_ref) <= 1e-5 * abs(e_ref):
                raise AssertionError(f"B9 N={n}: 0.5 sum(m phi) {e_k} vs Gravity.energy {e_ref}, beyond rtol 1e-5")
            energy_s = f"; 0.5 sum(m phi) {e_k:.6e} vs Gravity.energy {e_ref:.6e} (rel {abs(e_k - e_ref) / abs(e_ref):.2e})"
        t20 = interleaved_ms({
            "B9": lambda: accel(pos_g, m_g),
            "previous": lambda: gdesigns.previous(prev_b9, pos_g, m_g, 1.0, 0.1),
            "B9 potential": lambda: accel_phi(pos_g, m_g),
            "previous potential": lambda: gdesigns.previous(prev_b9, pos_g, m_g, 1.0, 0.1, True),
        }, reps=20 if n == 16_384 else 3)
        times[names[0]] = (t20["B9"][0],
                           cuda_ms(lambda: pairwise_cuda.gravity_accel_pairwise_reference(pos_g, m_g, 1.0, 0.1), 3))
        times[names[1]] = (t20["B9 potential"][0],
                           cuda_ms(lambda: pairwise_cuda.gravity_accel_pairwise_reference(pos_g, m_g, 1.0, 0.1, True), 3))
        bounds[names[0]], bounds[names[1]] = roofline.gravity_bounds(n, dim)
        sfu_ms = roofline.rsqrt_ms(n)
        for name, key in ((names[0], "previous"), (names[1], "previous potential")):
            extra[name] = {"previous_ms": t20[key][0]}
        print(f"{smi}: phase 20 B9 N={n} {dim}D time (medians of 7 interleaved repeats): "
              + ", ".join(f"{k} {spread(v)}" for k, v in t20.items())
              + f"; one rsqrt a pair on the special-function unit {sfu_ms:.5f} ms", flush=True)
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

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    block = 16 * 1024  # bytes a block of the kernel copies
    for dtype, n_el, name in ((torch.float32, 64 << 20, "copy"), (torch.bfloat16, 128 << 20, "copy_bf16")):
        gen = torch.Generator(device=dev).manual_seed(21)
        src = torch.randn(n_el, generator=gen, device=dev).to(dtype)
        op = bench_ops.make_bandwidth_op(n_el, dtype=dtype, mode="pallas_copy")
        out = op(src)
        if op.n_elems != n_el or not torch.equal(out, src):
            raise AssertionError(f"B10 {dtype}: the copy is not bit-equal to its source")
        errors[name] = float((out.float() - src.float()).abs().max())
        # direct calls of odd sizes: 3 blocks, 1001 vectors and 4 bytes; 3.5
        # blocks an SM and 4 bytes (a short last block, the byte tail)
        odd = [(3 * block + 16 * 1001 + 4) // src.element_size(), (7 * n_sm * block // 2 + 4) // src.element_size()]
        for part in [src[:k] for k in odd]:
            if not torch.equal(copy_cuda.chunked_copy(part), part):
                raise AssertionError(f"B10 {dtype}: {part.numel()} elements not bit-equal")
        dst = torch.empty_like(src)
        t21 = interleaved_ms({"b10": lambda: copy_cuda.chunked_copy(src), "copy_": lambda: dst.copy_(src)})
        times[name] = (t21["b10"][0], cuda_ms(lambda: copy_cuda.copy_reference(src), 20))
        library[name] = t21["copy_"][0]
        bounds[name] = roofline.bound(0.0, op.bytes_per_call)  # each byte read once and written once
        ctx = runners.BenchContext(BenchConfig(warmup=1, repeats=2, steps=20), print, dev)
        reset_counts()
        avg = runners._timed_loop(ctx, op, (src,), 1, chain="direct")
        launches[name] = copy_cuda.COPY_LAUNCHES
        if launches[name] <= 0:
            raise AssertionError(f"B10 {dtype}: the timed loop did not launch the kernel")
        print(f"phase 21 B10 {dtype} {n_el} elements ({op.bytes_per_call // 2 >> 20} MiB): "
              f"bit-equal on it and on {odd} elements; medians of 7 interleaved repeats of 20 calls: "
              f"B10 {spread(t21['b10'])}, dst.copy_ {spread(t21['copy_'])}; "
              f"B10 {t21['b10'][0] / t21['copy_'][0]:.4f}x dst.copy_'s time; plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call; _timed_loop (direct, 20 steps): "
              f"{avg * 1e3:.4f} ms a copy, {op.bytes_per_call / avg / 2**30:.1f} GiB/s, {launches[name]} launches",
              flush=True)
        del src, dst, out
    torch.cuda.empty_cache()

    # -- 22. the op suite ---------------------------------------------------------
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.isolate import run_sweep_isolated

    sweep = dict(warmup=1, repeats=2, steps=20, matrix_size=4096, matrix_depth=6, conv_size=128,
                 batch_size=64, conv_cin=32, conv_cout=64)
    peak_gibs = roofline.PEAK_HBM_BYTES / 2**30
    for precision, peak in (("float32", roofline.PEAK_FP32_FLOPS), ("bfloat16", roofline.PEAK_BF16_FLOPS)):
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

    # -- 24. 2D halo kernels against the whole-grid kernels ----------------------
    # N rounded as mdscale rounds it for devices [1, 2, 4] (120 cells per
    # side, R = 1); a state 20 steps after a rebuild, coordinates unwrapped;
    # P row blocks with the halo rows each rank's exchange attaches
    cfg2s = override(cfg, n=scaling._round_to_divisible_n(cfg.n, cfg, [1, 2, 4]))
    md2s = lj_fluid._make_grid_md(cfg2s, dev)
    if md2s.rows_per_block != 1:
        raise AssertionError(f"2D sharded configuration: R = {md2s.rows_per_block}, expected the unpacked layout")
    k2, gate2 = lj_fluid._grid_inner_steps(cfg2s, md2s)
    st2 = lj_fluid.init_state(cfg2s, dev)
    g2 = md2s.make_production_run(150 * k2, k2, gate_frac=gate2)(md2s.init(st2.position, st2.velocity))
    g2 = md2s._make_window(md2s.force_kernel, 20)(g2)
    occ2 = g2.occ > 0.5
    p2 = cell_cuda.CellForceParams.from_grid(md2s.grid_fn)
    full2 = {False: cell_cuda.grid_force(g2.xg, g2.yg, p2), True: cell_cuda.grid_force(g2.xg, g2.yg, p2, with_energy=True)}
    for energy in (False, True):
        if not all(torch.equal(a, b) for a, b in zip(full2[energy], cell_cuda.grid_force_loop(g2.xg, g2.yg, p2, energy))):
            raise AssertionError(f"B1 at N={cfg2s.n} (energy {energy}): not torch.equal to B1's loop")
    errors["cell_force_halo"] = errors["cell_force_halo_energy"] = errors["migrate_halo"] = 0.0

    for n_blocks in (1, 2, 4):
        xb, yb = halo_blocks(g2.xg, n_blocks, md2s.box), halo_blocks(g2.yg, n_blocks)
        for name, energy in (("cell_force_halo", False), ("cell_force_halo_energy", True)):
            got = [cell_cuda.grid_force_halo(x, y, p2, energy) for x, y in zip(xb, yb)]
            # the edge-row form, the engine's: local rows and four edge rows
            edges = [cell_cuda.grid_force_halo_edges(x[1:-1], y[1:-1], x[0], y[0], x[-1], y[-1], p2, energy)
                     for x, y in zip(xb, yb)]
            loop_h = [cell_cuda.grid_force_halo_loop(x, y, p2, energy) for x, y in zip(xb, yb)]
            plain = [cell_cuda.grid_force_halo_reference(x, y, p2, energy) for x, y in zip(xb, yb)]
            got, edges, loop_h, plain = ([torch.cat(q) for q in zip(*t)] for t in (got, edges, loop_h, plain))
            for form, t in (("(rows + 2) form", got), ("edge-row form", edges), ("loop", loop_h)):
                if not all(torch.equal(a, b) for a, b in zip(t, full2[energy])):
                    raise AssertionError(f"{name} ({form}) over {n_blocks} row blocks is not bit-equal to B1")
            err = _max_diff(got[:2], plain[:2], occ2, f"{name} vs plain", 1e-4)
            if energy:
                err = max(err, _sums_close(got[2:], plain[2:], name, 1e-5))
            errors[name] = max(errors[name], err)
    # B2 halo over 1-4 row blocks (the slices of one stacked tensor of the
    # (rows + 2) planes, as the sharded engine's exchange leaves them), on
    # the rebuild's inputs and at overflow: bit-equal to B2 on the whole
    # grid, to its plain halo version and to the previous design's halo form
    for label24, st24 in (("state", g2), ("overflow state", designs2.overflow_state(md2s, g2))):
        sc24, oc24, pl24, fl24, ovf24 = designs2.rebuild_inputs(md2s, st24)
        stk24 = torch.stack(pl24)
        full_m2 = migrate_cuda.migrate(sc24, pl24, fl24, occ=oc24)
        if not torch.equal(full_m2, migrate_cuda.migrate_reference(sc24, stk24, fl24)):
            raise AssertionError(f"B2 at N={cfg2s.n} ({label24}) is not bit-equal to its plain version")
        for n_blocks in (1, 2, 3, 4):
            cb, fb = halo_blocks(sc24, n_blocks), halo_blocks(stk24, n_blocks, dim=1)
            got_m = torch.cat([migrate_cuda.migrate_halo(c, f, fl24, occ=o)
                               for c, f, o in zip(cb, fb, oc24.chunk(n_blocks))], dim=1)
            plain_m = torch.cat([migrate_cuda.migrate_halo_reference(c, f, fl24) for c, f in zip(cb, fb)], dim=1)
            prev_m = torch.cat([designs2.previous(prev_b2, c, f, fl24, halo=True) for c, f in zip(cb, fb)], dim=1)
            if not (torch.equal(got_m, full_m2) and torch.equal(got_m, plain_m) and torch.equal(prev_m, plain_m)):
                raise AssertionError(f"B2 halo over {n_blocks} row blocks ({label24}) is not bit-equal to B2, to its "
                                     "plain version and to the previous design")
        if bool(ovf24) is not (label24 == "overflow state"):
            raise AssertionError(f"phase 24 {label24}: overflow {bool(ovf24)}")
    # one rank's shapes at world size 1: all 120 rows and the two halo rows
    scode2, occ2n, planes2, fills2, _ = designs2.rebuild_inputs(md2s, g2)
    (xh,), (yh,) = halo_blocks(g2.xg, 1, md2s.box), halo_blocks(g2.yg, 1)
    (ch,), (fh,) = halo_blocks(scode2, 1), halo_blocks(torch.stack(planes2), 1, dim=1)
    t24, tile24 = _tile_times(cell_cuda, (xh, yh, p2), md2s.cps, halo=True)
    times["cell_force_halo"] = (t24["tile"][0], cuda_ms(lambda: cell_cuda.grid_force_halo_reference(xh, yh, p2), 10))
    times["cell_force_halo_energy"] = (
        t24["tile_e"][0], cuda_ms(lambda: cell_cuda.grid_force_halo_reference(xh, yh, p2, True), 10))
    extra["cell_force_halo"] = {"loop_ms": t24["loop"][0], "tile": list(tile24[0])}
    extra["cell_force_halo_energy"] = {"loop_ms": t24["loop_e"][0], "tile": list(tile24[1])}
    fns24 = {
        "B2 halo": lambda: migrate_cuda.migrate_halo(ch, fh, fills2, occ=occ2n),
        "previous": lambda: designs2.previous(prev_b2, ch, fh, fills2, halo=True),
        "fill": lambda: designs2.previous(prev_b2, ch, fh, fills2, halo=True, what=1),
        "scatter": lambda: designs2.previous(prev_b2, ch, fh, fills2, halo=True, what=2),
        "B2": lambda: migrate_cuda.migrate(scode2, planes2, fills2, occ=occ2n),
    }
    t24m = interleaved_ms(fns24, lead=True)
    host24 = {k: host_us(fns24[k]) for k in ("B2 halo", "previous")}
    times["migrate_halo"] = (t24m["B2 halo"][0], cuda_ms(lambda: migrate_cuda.migrate_halo_reference(ch, fh, fills2), 10))
    extra["migrate_halo"] = {"previous_ms": t24m["previous"][0], "previous_fill_ms": t24m["fill"][0],
                             "previous_scatter_ms": t24m["scatter"][0], "host_us": host24["B2 halo"],
                             "previous_host_us": host24["previous"]}
    full_ms2 = (cuda_ms(lambda: cell_cuda.grid_force(g2.xg, g2.yg, p2), 50, lead=True), t24m["B2"][0])
    work2s = _pair_work((g2.xg, g2.yg), g2.occ, md2s.cps, md2s.cap, md2s.box, p2.cutoff2)
    bounds["cell_force_halo"], bounds["cell_force_halo_energy"] = _force_bounds(work2s, 2, g2.xg.numel(), xh.numel())
    # one block: every particle lands in the local rows once; the local
    # occupancy in besides the permutation
    bounds["migrate_halo"] = _migrate_bound(len(planes2), g2.xg.numel(), int(occ2n.sum()), ch.numel())
    print(f"{smi}: phase 24 2D halo kernels, N={cfg2s.n} (grid {tuple(g2.xg.shape)}): B1 (both variants) "
          f"torch.equal to B1's loop; over 1, 2 and 4 row blocks B1 halo (both variants, the (rows + 2) and the "
          f"edge-row forms, and B1 halo's loop), and over 1-4 row blocks B2 halo, also at overflow, bit-equal to B1 "
          f"and B2 on the whole grid; against their plain versions: forces {errors['cell_force_halo']:.3e}, energy "
          f"variant {errors['cell_force_halo_energy']:.3e}, B2 halo bit-equal (the previous design too); at one "
          f"rank's shape B1 halo {times['cell_force_halo'][0]:.4f} ms against B1 {full_ms2[0]:.4f} ms; B2 halo "
          f"(medians of 7 interleaved repeats of 20 calls, lead) {spread(t24m['B2 halo'])} against B2 "
          f"{spread(t24m['B2'])}, the previous design {spread(t24m['previous'])} (its fill {spread(t24m['fill'])}, "
          f"scatter {spread(t24m['scatter'])}); host us a call: B2 halo {host24['B2 halo']:.1f}, previous "
          f"{host24['previous']:.1f}", flush=True)
    for name in ("cell_force_halo", "cell_force_halo_energy", "migrate_halo"):
        print(f"phase 24 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
    _print_tile_times(f"{smi}: phase 24 B1 halo at one rank's shape", t24, tile24, bounds["cell_force_halo"])

    # -- 25. 3D halo kernels against the whole-grid kernels ----------------------
    # N rounded for devices [1, 2] with the skin rounded to 2 devices: 18
    # cells per side; a state 90 steps into the melt from the lattice
    cfg3s = override(cfg3, n=scaling._round_to_divisible_n(cfg3.n, cfg3, [1, 2]))
    cfg3s = override(cfg3s, skin=lj_fluid.resolve_skin(cfg3s, "grid", n_devices=2))
    md3s = lj_fluid._make_grid_md(cfg3s, dev)
    st3 = lj_fluid.init_state(cfg3s, dev)
    g3 = md3s.make_production_run_fixed(90, 9)(md3s.init(st3.position, st3.velocity))
    occ3s = g3.occ > 0.5
    c3s = (g3.xg, g3.yg, g3.zg)
    mo3, cov3 = int(g3.max_occ), md3s.static_cov
    p3s = cell_cuda3.CellForce3Params.from_grid(md3s.grid_fn)
    variants3 = (("cell_force3_halo", dict(max_occ=g3.max_occ), mo3),
                 ("cell_force3_halo_energy", dict(max_occ=g3.max_occ, with_energy=True), mo3),
                 ("cell_force3_counted_halo", dict(static_cov=cov3), cov3),
                 ("cell_force3_counted_halo_energy", dict(static_cov=cov3, with_energy=True), cov3))
    full3 = {name: cell_cuda3.grid_force3(*c3s, p3s, **kw) for name, kw, _ in variants3}
    # B5 halo's yardstick: B5's full loop on the whole grid, which the
    # counted kernel (whole grid and halo form) must give bit for bit
    for name, kw, _ in variants3[2:]:
        loop3 = cell_cuda3.grid_force3_static_loop(*c3s, p3s, cov3, kw.get("with_energy", False))
        if not all(torch.equal(a, b) for a, b in zip(full3[name], loop3)):
            raise AssertionError(f"B5 at {md3s.cps} cells per side ({name}): not torch.equal to B5's full loop")
    scode3s, occ_new3s, planes3s, _ = designs.rebuild_inputs(md3s, g3)
    fields3s = torch.stack(planes3s)
    k_mov3s = md3s.migrate_k_mov
    full_m3, mov_of3 = migrate_cuda3.migrate3(scode3s, planes3s, fills3, k_mov=k_mov3s, occ=occ_new3s)
    for name, *_ in variants3:
        errors[name] = 0.0
    errors["migrate3_halo"] = 0.0
    for n_blocks in (1, 2, 3):
        blocks = list(zip(halo_blocks(g3.xg, n_blocks, md3s.box), halo_blocks(g3.yg, n_blocks),
                          halo_blocks(g3.zg, n_blocks)))
        for name, kw, bound in variants3:
            got = [torch.cat(q) for q in zip(*(cell_cuda3.grid_force3_halo(*b, p3s, **kw) for b in blocks))]
            plain = [torch.cat(q) for q in zip(*(cell_cuda3.grid_force3_halo_reference(
                *b, p3s, bound, kw.get("with_energy", False)) for b in blocks))]
            if not all(torch.equal(a, b) for a, b in zip(got, full3[name])):
                raise AssertionError(f"{name} over {n_blocks} row blocks is not bit-equal to the whole-grid kernel")
            energy = kw.get("with_energy", False)
            if "counted" in name:
                loop_h = [torch.cat(q) for q in zip(*(cell_cuda3.grid_force3_static_loop(
                    *b, p3s, cov3, energy, halo=True) for b in blocks))]
            else:
                loop_h = [torch.cat(q) for q in zip(*(cell_cuda3.grid_force3_loop(
                    *b, p3s, max_occ=g3.max_occ, with_energy=energy, halo=True) for b in blocks))]
            if not all(torch.equal(a, b) for a, b in zip(got, loop_h)):
                raise AssertionError(f"{name} over {n_blocks} row blocks is not bit-equal to its loop's halo form")
            err = _max_diff(got[:3], plain[:3], occ3s, f"{name} vs plain", 1e-4)
            if energy:
                err = max(err, _sums_close(got[3:], plain[3:], name, 1e-5))
            errors[name] = max(errors[name], err)
        rows3 = md3s.cps // n_blocks
        cb, fb = halo_blocks(scode3s, n_blocks), halo_blocks(fields3s, n_blocks, dim=1)
        ob = [occ_new3s[k * rows3:(k + 1) * rows3] for k in range(n_blocks)]
        outs = [migrate_cuda3.migrate3_halo(c, f, fills3, k_mov=k_mov3s, occ=o) for c, f, o in zip(cb, fb, ob)]
        prev = [designs.previous(prev_b6, c, f, fills3, k_mov3s, halo=True) for c, f in zip(cb, fb)]
        plain_m = torch.cat([migrate_cuda3.migrate3_halo_reference(c, f, fills3) for c, f in zip(cb, fb)], dim=1)
        for label, parts in (("B6 halo", outs), ("the previous B6 halo design", prev)):
            got_m = torch.cat([o[0] for o in parts], dim=1)
            if not (torch.equal(got_m, full_m3) and torch.equal(got_m, plain_m)):
                raise AssertionError(f"{label} over {n_blocks} row blocks is not bit-equal to B6 and to the plain "
                                     "version")
            if any(bool(o[1]) for o in parts) != bool(mov_of3):
                raise AssertionError(f"{label}'s mover flag over {n_blocks} row blocks differs from B6's")
    (xh3,), (yh3,), (zh3,) = (halo_blocks(g, 1, s) for g, s in zip(c3s, (md3s.box, 0.0, 0.0)))
    (ch3,), (fh3,) = halo_blocks(scode3s, 1), halo_blocks(fields3s, 1, dim=1)
    mo3t = g3.max_occ
    t25h = interleaved_ms({
        "B4 halo": lambda: cell_cuda3.grid_force3_halo(xh3, yh3, zh3, p3s, max_occ=mo3t),
        "B4 halo's loop": lambda: cell_cuda3.grid_force3_loop(xh3, yh3, zh3, p3s, max_occ=mo3t, halo=True),
        "B4 halo energy": lambda: cell_cuda3.grid_force3_halo(xh3, yh3, zh3, p3s, max_occ=mo3t, with_energy=True),
        "B4 halo's loop energy": lambda: cell_cuda3.grid_force3_loop(xh3, yh3, zh3, p3s, max_occ=mo3t,
                                                                   with_energy=True, halo=True),
        "B4": lambda: cell_cuda3.grid_force3(*c3s, p3s, max_occ=mo3t),
        "B5": lambda: cell_cuda3.grid_force3(*c3s, p3s, static_cov=cov3),
        "B6 halo": lambda: migrate_cuda3.migrate3_halo(ch3, fh3, fills3, k_mov=k_mov3s, occ=occ_new3s),
        "previous B6 halo": lambda: designs.previous(prev_b6, ch3, fh3, fills3, k_mov3s, halo=True),
        "B6": lambda: migrate_cuda3.migrate3(scode3s, planes3s, fills3, k_mov=k_mov3s, occ=occ_new3s),
    }, lead=True)
    plain25 = {name: cuda_ms(lambda b=bound, e=kw.get("with_energy", False): cell_cuda3.grid_force3_halo_reference(
        xh3, yh3, zh3, p3s, b, e), 5) for name, kw, bound in variants3[:3]}
    times["cell_force3_halo"] = (t25h["B4 halo"][0], plain25["cell_force3_halo"])
    times["cell_force3_halo_energy"] = (t25h["B4 halo energy"][0], plain25["cell_force3_halo_energy"])
    times["migrate3_halo"] = (t25h["B6 halo"][0],
                              cuda_ms(lambda: migrate_cuda3.migrate3_halo_reference(ch3, fh3, fills3), 10))
    full_ms3 = (t25h["B4"][0], t25h["B5"][0], t25h["B6"][0])
    t25, strip25 = _counted_times((xh3, yh3, zh3, p3s), cov3, True)
    times["cell_force3_counted_halo"] = (t25["counted"][0], plain25["cell_force3_counted_halo"])
    extra["cell_force3_counted_halo"] = {"loop_ms": t25["loop"][0], "strip": strip25}
    extra["cell_force3_halo"] = {"loop_ms": t25h["B4 halo's loop"][0]}
    extra["cell_force3_halo_energy"] = {"loop_ms": t25h["B4 halo's loop energy"][0]}
    extra["migrate3_halo"] = {"previous_ms": t25h["previous B6 halo"][0]}
    n_out3, n_in3 = g3.xg.numel(), xh3.numel()
    b4h, b4he = _force_bounds(_pair_work(c3s, g3.occ, md3s.cps, mo3, md3s.box, p3s.cutoff2), 3, n_out3, n_in3)
    b5h, _ = _force_bounds(_pair_work(c3s, g3.occ, md3s.cps, cov3, md3s.box, p3s.cutoff2), 3, n_out3, n_in3)
    bounds.update(cell_force3_halo=b4h, cell_force3_halo_energy=b4he, cell_force3_counted_halo=b5h,
                  migrate3_halo=_migrate_bound(fields3s.shape[0], n_out3, int(occ_new3s.sum()), ch3.numel()))
    print(f"phase 25 3D halo kernels, N={cfg3s.n} (grid {tuple(g3.xg.shape)}, skin {md3s.skin:.4f}, max "
          f"occupancy {mo3}, B5 bound {cov3}): B5 (both variants) torch.equal to B5's full loop on the "
          f"whole grid; over 1, 2 and 3 x-row blocks B4 halo (both variants), B5 halo (both variants) and "
          f"B6 halo (and the previous design) bit-equal to the whole-grid kernels, B4 halo and B5 "
          f"halo to their loops' halo forms, the mover flag "
          f"({bool(mov_of3)}) where B6 raises it; against their plain versions: B4 halo "
          f"{errors['cell_force3_halo']:.3e}, energy variant {errors['cell_force3_halo_energy']:.3e}, B5 "
          f"halo {errors['cell_force3_counted_halo']:.3e}, energy variant "
          f"{errors['cell_force3_counted_halo_energy']:.3e}, B6 halo bit-equal; at one rank's shape B4 halo "
          f"{times['cell_force3_halo'][0]:.4f} ms against B4 {full_ms3[0]:.4f} ms, B5 halo "
          f"{times['cell_force3_counted_halo'][0]:.4f} ms against B5 {full_ms3[1]:.4f} ms, B6 halo "
          f"{times['migrate3_halo'][0]:.4f} ms against B6 {full_ms3[2]:.4f} ms", flush=True)
    for name in ("cell_force3_halo", "cell_force3_halo_energy", "cell_force3_counted_halo", "migrate3_halo"):
        print(f"phase 25 time {name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) per call", flush=True)
    print(f"{smi}: phase 25 at one rank's shape (medians of 7 interleaved repeats of 20 calls, lead): "
          + ", ".join(f"{k} {spread(v)}" for k, v in t25h.items()), flush=True)
    _print_counted_times("phase 25 B5 halo at one rank's shape", t25, strip25, b5h, md3s.cps)

    # -- 26. the row-sharded engines on the card, world size 1 ---------------------
    # an NCCL process group of one rank from an in-process store (no
    # address); lj_fluid's phases on ShardedGridMD / ShardedGridMD3, which
    # run the halo kernels (the exchange a local swap, the reductions on
    # the group), then on the one-device engine mdscale compares them with
    # at the same N, and the trajectory parity of scaling._check_parity.
    # The engines are mdscale's (scaling._build_engine), in 3D with
    # lj_fluid's k_mov, 16 (at 18 cells per side the first rebuild of the
    # melt from the lattice has 14 movers in a cell: the JAX package's k_mov
    # 8 raises B6's mover flag there, tests/torch_kmov_witness.py)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_mesh(device=dev)
    full_names = {"2D": ("cell_force", "cell_force_energy", "migrate", "cell_force_packed",
                         "cell_force_packed_energy", "migrate_packed", "cell_force_loop", "cell_force_loop_energy",
                         "cell_force_halo_loop", "cell_force_halo_loop_energy"),
                  "3D": ("cell_force3", "cell_force3_energy", "cell_force3_counted", "cell_force3_static",
                         "migrate3", "migrate3_flat", "cell_force3_loop", "cell_force3_halo_loop")}
    halo_names = {"2D": ("cell_force_halo", "cell_force_halo_energy", "migrate_halo"),
                  "3D": ("cell_force3_halo", "cell_force3_halo_energy", "cell_force3_counted_halo", "migrate3_halo")}
    for label, c, engine, kw in (("2D", cfg2s, ShardedGridMD, {}),
                                 ("3D", cfg3s, ShardedGridMD3, dict(static_cov="auto"))):
        plain_md = scaling._build_engine(c, 1, dev)[0]
        sharded = engine(plain_md.grid_fn, mesh, sigma=c.sigma, epsilon=c.epsilon, dt=c.dt,
                         compensated=c.compensated, **kw)
        reset_counts()
        res_s = lj_fluid.run(c, device=dev, md=sharded)
        counts = launch_counts()
        check_run(res_s, f"{label} sharded engine", c)
        if (any(counts[n] for n in full_names[label]) or counts["cell_force3_static_halo"]
                or counts["cell_force3_halo_loop"] or not all(counts[n] > 0 for n in halo_names[label])):
            raise AssertionError(f"{label} sharded engine: launches {counts}; expected the halo kernels only")
        launches.update({n: counts[n] for n in halo_names[label]})
        if label == "2D":
            loop_main.update({k: counts[k] for k in ("cell_force_halo_loop", "cell_force_halo_loop_energy")})
        else:
            loop_main3_halo = counts["cell_force3_halo_loop"]  # B4 halo's loop on the sharded path: 0
        res_u = lj_fluid.run(c, device=dev, md=plain_md)
        check_run(res_u, f"{label} unsharded engine at N={c.n}", c)
        ok, err = scaling.parity(c, sharded, lj_fluid.init_state(c, dev), 50, dev)
        if not ok:
            raise AssertionError(f"{label} sharded vs unsharded over 50 steps: max abs diff {err:.3e}, "
                                 f"beyond rtol = atol = {scaling.PARITY_TOL}")
        # what the sharded step adds, each on its own (host clock over 200
        # calls ended by a sync): an all-reduce MAX on the group, as each
        # window's dmax2 takes, and one step's exchange of the edge rows
        probe = torch.zeros((), device=dev)
        coords = [torch.zeros(sharded.grid_shape, device=dev) for _ in range(c.dim)]
        us_reduce = host_us(lambda: sharded._all_max(probe))
        us_halo = host_us(lambda: sharded._with_halo(*coords))
        # the 2D force reads the edge rows where the exchange leaves them
        us_edges = host_us(lambda: sharded._edge_rows(*coords)) if label == "2D" else None
        if label == "2D":
            # one rebuild's device ops with B2 halo and with the previous design
            gsh = sharded.init(res_s.state.position, res_s.state.velocity)

            def previous_halo(sc, pl, fl, oc, md=sharded):
                return designs2.previous(prev_b2, *md._halo_planes(sc, torch.stack(pl)), fl, halo=True)

            ops26 = _rebuild_ops_2d(sharded, sharded._window_for(gsh, k2)(gsh), f"{smi}: phase 26 sharded 2D",
                                  previous_halo)
            extra["migrate_halo"].update(rebuild_ops=ops26["ops"], previous_rebuild_ops=ops26["previous_ops"])
        if label == "3D":
            # one rebuild's device ops, and its exchange of the code and field
            # edge rows as B6 halo takes them (a stack of the planes, the
            # exchange, two (rows + 2) copies)
            gsh = sharded.init(res_s.state.position, res_s.state.velocity)
            gsh = sharded._window_for(gsh, res_s.cadence or 9)(gsh)
            _rebuild_ops(sharded, gsh, "phase 26 sharded 3D")
            sc_h, _, pl_h, _ = designs.rebuild_inputs(sharded, gsh)
            us_mig = host_us(lambda: sharded._halo_planes(sc_h, torch.stack(pl_h)))
        steps = c.eq_steps + c.prod_steps
        ms_s = 1e3 * (res_s.time_eq_s + res_s.time_prod_s) / steps
        ms_u = 1e3 * (res_u.time_eq_s + res_u.time_prod_s) / steps
        print(f"phase 26 {label} {type(sharded).__name__} at world size 1 (NCCL), N={c.n}, grid "
              f"{sharded.grid_shape}: {ms_s:.4f} ms/step = {res_s.particle_steps_per_sec:.4e} particle-steps/s "
              f"against the unsharded {type(plain_md).__name__}'s {ms_u:.4f} ms/step = "
              f"{res_u.particle_steps_per_sec:.4e}; drift {res_s.energy_drift:.3e} (unsharded "
              f"{res_u.energy_drift:.3e}); overflow False; P* {res_s.pressure:.4f} ({res_u.pressure:.4f}); "
              f"production cadence {res_s.cadence}; 50-step parity max abs diff {err:.3e} (tolerance "
              f"{scaling.PARITY_TOL}); halo launches {[counts[n] for n in halo_names[label]]}, whole-grid "
              f"launches 0; an all-reduce MAX {us_reduce:.1f} us, one step's edge-row exchange "
              + (f"{us_halo:.1f} us with the (rows + 2) copies, {us_edges:.1f} us without them (the force's)"
                 if us_edges is not None else f"{us_halo:.1f} us; a rebuild's exchange of the code and field edge "
                 f"rows {us_mig:.1f} us (the stack, the exchange and the (rows + 2) copies B6 halo reads)"),
              flush=True)
        if label == "2D":
            traced2s = override(c, prod_steps=2 * c.sample_every)
            busy_line(f"{smi}: phase 26 sharded 2D N={c.n}", res_s, c,
                      profile_device(lambda: lj_fluid.production(traced2s, res_s.state, res_s.cadence, md=sharded),
                                     os.path.join("chiprun_out", "chip_smoke_sharded_2d_trace.json")),
                      ("cell_force_tile_kernel",), "B1 halo")
        else:
            traced3s = override(c, prod_steps=2 * c.sample_every)
            busy_line(f"{smi}: phase 26 sharded 3D N={c.n}", res_s, c,
                      profile_device(lambda: lj_fluid.production(traced3s, res_s.state, res_s.cadence, md=sharded),
                                     os.path.join("chiprun_out", "chip_smoke_sharded_3d_trace.json")),
                      ("cell_force3_counted_kernel",), "B5 halo and B4 halo (the counted kernel)")
    # lj_fluid's 3D engine at 18 cells per side: its mover flag at k_mov 16
    print(f"phase 26 3D ShardedGridMD3 at {sharded.cps} cells per side with lj_fluid's k_mov "
          f"{sharded.migrate_k_mov}: overflow {res_s.overflow}, B6 mover flags {res_s.mover_flags} (rebuilds "
          f"with a cell over k_mov movers, none lost)", flush=True)
    dist.destroy_process_group()

    # -- 27. em3 on the card --------------------------------------------------------
    _em3_phase(smi)

    # -- 28. vmc on the card at full width ---------------------------------------------
    _vmc_phase(smi)

    # -- 29. A1, the allocation's kernels, at both benchmark cells' states -------------
    alloc_designs = _designs("torch_alloc_designs")
    for key, cell_name, seed in (("alloc", "lj2d-n1m", 2900000011), ("alloc3", "lj3d-inlj-2m", 2900000023)):
        r = alloc_designs.cell_report(cell_name, seed, f"{smi}: phase 29")
        times[key] = (r["kernel_ms"][0], r["plain_ms"][0])
        errors[key] = 0.0
        bounds[key] = (r["bound_ms"], r["bound_by"])
        extra[key] = {"cell": cell_name, "kernel_ms_min_max": r["kernel_ms"][1:], "plain_ms_min_max": r["plain_ms"][1:],
                      "bytes": r["bytes"], "ops": r["ops"], "eager_ops": r["eager_ops"],
                      "block_launches": r["block_launches"], "block_rebuilds": r["block_rebuilds"]}

    # -- 30. result --------------------------------------------------------------
    root = "jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc/"
    ref = "jax_tpus_benchmark_physics_simulation_tpu/"
    kref = ref + "ops/kernels/"
    meta = {
        "cell_force": ("cell_force.cu", kref + "cell_pallas.py:82"),
        "cell_force_energy": ("cell_force.cu", kref + "cell_pallas.py:82"),
        "migrate": ("migrate.cu", kref + "migrate_pallas.py:80"),
        "cell_force_packed": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        "cell_force_packed_energy": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        # B3's list form and its build are B3's redesign on the card: they
        # do B3's job, and no TPU kernel builds a list
        "cell_force_list": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        "cell_list_build": ("cell_force.cu", kref + "cell_pallas_packed.py:111"),
        "migrate_packed": ("migrate.cu", kref + "migrate_pallas.py:80"),
        "cell_force3": ("cell_force3.cu", kref + "cell_pallas3.py:99"),
        "cell_force3_energy": ("cell_force3.cu", kref + "cell_pallas3.py:99"),
        "cell_force3_counted": ("cell_force3.cu", kref + "cell_pallas3.py:336"),
        # the list form and its build are B5's and B4's redesign on the card:
        # they do B5's job, and no TPU kernel builds a list
        "cell_force3_list": ("cell_force3.cu", kref + "cell_pallas3.py:336"),
        "cell_list3_build": ("cell_force3.cu", kref + "cell_pallas3.py:336"),
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
        "cell_force_halo": ("cell_force.cu", kref + "cell_pallas.py:346"),
        "cell_force_halo_energy": ("cell_force.cu", kref + "cell_pallas.py:346"),
        "migrate_halo": ("migrate.cu", kref + "migrate_pallas.py:226"),
        "cell_force3_halo": ("cell_force3.cu", kref + "cell_pallas3.py:722"),
        "cell_force3_counted_halo": ("cell_force3.cu", kref + "cell_pallas3.py:722"),
        "cell_force3_halo_energy": ("cell_force3.cu", kref + "cell_pallas3.py:722"),
        "migrate3_halo": ("migrate3.cu", kref + "migrate_pallas3.py:471"),
        # L1 replaces no TPU kernel: XLA fuses the JAX package's window
        "leapfrog_step": ("leapfrog.cu", kref + "grid_md.py:565"),
        "leapfrog_first": ("leapfrog.cu", kref + "grid_md.py:565"),
        "leapfrog_close": ("leapfrog.cu", kref + "grid_md.py:565"),
        # A1 replaces no TPU kernel: XLA fuses the JAX package's allocation
        "alloc": ("alloc.cu", kref + "grid_md.py:253"),
        "alloc3": ("alloc.cu", kref + "grid_md3.py:308"),
        # the noise kernel replaces no TPU kernel: the JAX package draws from jax.random
        "langevin_noise": ("noise.cu", kref + "grid_md.py:633"),
        # the BAOAB pass replaces no TPU kernel: XLA fuses the JAX package's Langevin window
        "baoab_step": ("baoab.cu", kref + "grid_md.py:565"),
    }
    for name in ("cell_force", "cell_force_energy", "cell_force_halo", "cell_force_halo_energy"):
        loop_key = name.replace("cell_force", "cell_force_loop") if "halo" not in name else name.replace(
            "cell_force_halo", "cell_force_halo_loop")
        extra[name]["loop_launches"] = loop_main[loop_key]
    for name, n_loop in (("cell_force3", loop_main3), ("cell_force3_energy", loop_main3),
                         ("cell_force3_halo", loop_main3_halo), ("cell_force3_halo_energy", loop_main3_halo)):
        extra[name]["loop_launches"] = n_loop
    kernels = [
        {"name": name, "route": "cuda", "source": root + src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": library.get(name),
         **extra.get(name, {})}
        for name, (src, tpu) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
