"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the repository root. It builds the CUDA kernels from
``jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the kernel build time;
2. checks each kernel against its plain PyTorch version at the N=100k
   shapes (121 x 16 x 121 grid) on a state whose positions are unwrapped
   near the seams: B1 forces (max abs diff <= 1e-4 over occupied slots),
   B1 energy variant (e and w sums at rtol 1e-5), B2 (bit-equal); and
   times each against its plain version with CUDA events;
3. checks B1 forces on 1024 particles against the dense O(N^2) oracle
   computed from all 100k particles (atol 1e-4);
4. checks that a short run at N=4096 on the card agrees with the same run
   on the CPU (the plain versions), energies at rtol 1e-4;
5. drives the main path, ``lj_fluid.run`` at N=100k (rho 0.8, cutoff 2.5,
   dt 1e-3, lattice init, Kahan on, 2000 + 2000 steps), with every launch
   counter set to 0 just before: overflow False, finite energies, energy
   drift < 1e-4, and every kernel launched;
6. prints a JSON line with each kernel's launches, error and times, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no last line.
Without a CUDA device it stops before doing anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


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
        migrate_cuda,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # -- 2. kernels vs plain versions at the N=100k shapes --------------------
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
    err_f = max(float((a - b)[occ].abs().max()) for a, b in zip(fk, fr))
    fmax = float(torch.hypot(fr[0], fr[1])[occ].max())
    if not err_f <= 1e-4:
        raise AssertionError(f"B1 forces: kernel vs plain max abs diff {err_f:.3e} > 1e-4")

    ek = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=True)
    er = cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=True)
    err_ef = max(float((a - b)[occ].abs().max()) for a, b in zip(ek[:2], er[:2]))
    err_e = 0.0
    for name, a, b in (("e", ek[2], er[2]), ("w", ek[3], er[3])):
        sa, sb = float(a.double().sum()), float(b.double().sum())
        rel = abs(sa - sb) / abs(sb)
        err_e = max(err_e, float((a - b).abs().max()))
        if not rel <= 1e-5:
            raise AssertionError(f"B1 energy variant: sum of {name} {sa} vs {sb}, rel {rel:.3e} > 1e-5")
    if not err_ef <= 1e-4:
        raise AssertionError(f"B1 energy variant forces: max abs diff {err_ef:.3e} > 1e-4")

    _, _, scode, _, _ = md._migration_dest(gs)
    fields = torch.stack([torch.remainder(gs.xg, md.box), torch.remainder(gs.yg, md.box),
                          gs.vxg, gs.vyg, gs.fxg, gs.fyg, gs.pid.float(),
                          gs.crx, gs.cry, gs.cvx, gs.cvy])
    fills = [md.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0]
    movers = int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != 4)).sum())
    mk = migrate_cuda.migrate(scode, fields, fills)
    mr = migrate_cuda.migrate_reference(scode, fields, fills)
    if not torch.equal(mk, mr):
        raise AssertionError("B2: kernel output is not bit-equal to the plain version")

    times = {
        "cell_force": (_cuda_ms(lambda: cell_cuda.grid_force(gs.xg, gs.yg, p), 50),
                       _cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p), 10)),
        "cell_force_energy": (
            _cuda_ms(lambda: cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=True), 50),
            _cuda_ms(lambda: cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=True), 10)),
        "migrate": (_cuda_ms(lambda: migrate_cuda.migrate(scode, fields, fills), 50),
                    _cuda_ms(lambda: migrate_cuda.migrate_reference(scode, fields, fills), 10)),
    }
    errors = {"cell_force": err_f, "cell_force_energy": max(err_ef, err_e), "migrate": 0.0}
    print(f"phase 2 B1 forces: max abs diff {err_f:.3e} (max |f| {fmax:.1f}); "
          f"energy variant: forces {err_ef:.3e}, e/w max abs diff {err_e:.3e}, sums within rtol 1e-5; "
          f"B2: bit-equal, {movers} movers", flush=True)
    for name, (ms, plain_ms) in times.items():
        print(f"phase 2 time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call", flush=True)

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

    # -- 4. a small run on the card against the same run on the CPU -----------
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
    print("phase 4 N=4096, 200 steps: card and CPU energy histories agree within rtol 1e-4",
          flush=True)

    # -- 5. the main path --------------------------------------------------------
    cell_cuda.LAUNCHES = 0
    cell_cuda.ENERGY_LAUNCHES = 0
    migrate_cuda.LAUNCHES = 0
    res = lj_fluid.run(cfg, device="cuda")
    launches = {
        "cell_force": cell_cuda.LAUNCHES,
        "cell_force_energy": cell_cuda.ENERGY_LAUNCHES,
        "migrate": migrate_cuda.LAUNCHES,
    }
    n_samples = cfg.prod_steps // cfg.sample_every
    if res.overflow:
        raise AssertionError("main path: capacity/skin overflow flagged")
    if tuple(res.r_history.shape) != (n_samples, cfg.n, 2):
        raise AssertionError(f"main path: r_history shape {tuple(res.r_history.shape)}")
    for name, t in (("r_history", res.r_history), ("ke", res.ke_history), ("pe", res.pe_history),
                    ("g(r)", res.rdf_g)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path: non-finite {name}")
    drift = res.energy_drift
    if not drift < 1e-4:
        raise AssertionError(f"main path: energy drift {drift:.3e} >= 1e-4")
    if not math.isfinite(res.pressure):
        raise AssertionError("main path: non-finite pressure")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched kernel {name}")
    steps = cfg.eq_steps + cfg.prod_steps
    ms_step = 1e3 * (res.time_eq_s + res.time_prod_s) / steps
    print(f"phase 5 lj_fluid.run N={cfg.n}: {ms_step:.4f} ms/step, "
          f"{res.particle_steps_per_sec:.4e} particle-steps/s "
          f"(eq {res.time_eq_s:.3f} s, prod {res.time_prod_s:.3f} s, build+warm-up "
          f"{res.time_compile_s:.3f} s, g(r) {res.time_rdf_s:.3f} s); energy drift {drift:.3e}; "
          f"P* {res.pressure:.4f}; kT_eq {res.kt_eq:.4f}; rebuilds (migrate launches) "
          f"{launches['migrate']}; launches {launches}", flush=True)

    # -- 6. result -------------------------------------------------------------
    root = "jax_tpus_benchmark_physics_simulation_tpu_torch/ops/kernels/csrc/"
    ref = "jax_tpus_benchmark_physics_simulation_tpu/ops/kernels/"
    meta = {
        "cell_force": ("cell_force.cu", "cell_pallas.py:82"),
        "cell_force_energy": ("cell_force.cu", "cell_pallas.py:82"),
        "migrate": ("migrate.cu", "migrate_pallas.py:80"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": root + src, "replaces": ref + tpu,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
