"""Command line of the PyTorch port: the ``md`` subcommand.

    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \\
        --N 16384 --init lattice                          # all pairs, B8
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \\
        --N 100000 --cutoff 2.5 --init lattice            # 2D grid engine
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \\
        --N 1000000 --cutoff 2.5 --init lattice           # packed layout, B3
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \\
        --N 100000 --cutoff 2.5 --init lattice --thermostat langevin --gamma 1.0
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \\
        --N 100000 --dim 3 --cutoff 2.5 --init lattice    # 3D grid engine

Flag names follow the JAX package's ``jtps md`` (its ``cli.py``), plus
``--device``. Output is plain text lines; there is no plot, manifest or
checkpoint yet.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

# what each force path launches, for the kernels line
_PATH_KERNELS = {
    "dense_pallas": "B8 (csrc/pairwise_lj.cu): forces every step, its energy variant every sample",
    "dense_xla": "none: the dense LennardJones formula in plain PyTorch",
    "neighbor": "none: the Verlet neighbor list in plain PyTorch (one rebuild-check read a step)",
    "cell": "none: the cell-dense force in plain PyTorch (one rebuild-check read a step)",
}


def _add_md(sub):
    p = sub.add_parser("md", help="Lennard-Jones fluid MD (dense, list and grid force paths)")
    p.add_argument("--N", type=int, default=400)
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="2 (reference) or 3; on the grid engine 2 runs B1 (B3 on the packed "
                        "layout), B2 and 3 runs B5 windows with the B4 fallback, B6 rebuilds, "
                        "fixed-cadence NVE production")
    p.add_argument("--rho", type=float, default=0.8)
    p.add_argument("--kT", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--eq_steps", type=int, default=10000)
    p.add_argument("--prod_steps", type=int, default=10000)
    p.add_argument("--sample_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cutoff", type=float, default=None)
    p.add_argument("--force-impl", type=str, default="auto",
                   choices=["auto", "dense_xla", "dense_pallas", "neighbor", "cell", "grid"],
                   help="'auto' picks grid for N >= 4096 with a cutoff, neighbor for N >= 4096 "
                        "with a box too small for grid, dense_pallas (kernel B8) for N >= 1024 "
                        "on the card, else dense_xla")
    p.add_argument("--init", type=str, default="uniform", choices=["uniform", "lattice"])
    p.add_argument("--thermostat", type=str, default="none", choices=["none", "langevin"],
                   help="none = NVE; langevin = NVT via BAOAB Langevin windows at kT "
                        "(grid engine only)")
    p.add_argument("--gamma", type=float, default=1.0,
                   help="Langevin friction coefficient (1/time)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="after the run, trace two production sample blocks with "
                        "torch.profiler: prints the card's busy and idle share, writes "
                        "DIR/trace.json; on the grid engine also times the host reads of "
                        "the drivers (the per-window dmax2 read; in 3D also the "
                        "per-rebuild max_occ read) (needs --device cuda)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")


def cmd_md(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    cfg = override(
        MDConfig(),
        n=args.N, dim=args.dim, rho=args.rho, kt=args.kT, dt=args.dt,
        eq_steps=args.eq_steps, prod_steps=args.prod_steps,
        sample_every=args.sample_every, seed=args.seed, cutoff=args.cutoff,
        force_impl=args.force_impl, init=args.init,
        thermostat=args.thermostat, gamma=args.gamma,
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.profile and device.type != "cuda":
        print("error: --profile measures the card: use --device cuda", file=sys.stderr)
        return 2
    try:
        impl = lj_fluid.resolve_impl(cfg, device)
        res = lj_fluid.run(cfg, device=device)
    except (NotImplementedError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ensemble = "NVE" if cfg.thermostat == "none" else f"NVT (langevin, gamma={cfg.gamma})"
    print(f"Molecular Dynamics (PyTorch port) on {name}")
    print(f"N={cfg.n}  dim={cfg.dim}  rho={cfg.rho}  kT={cfg.kt}  box={cfg.box_size:.2f}  "
          f"steps: {cfg.eq_steps:,} eq / {cfg.prod_steps:,} prod  dt={cfg.dt}  "
          f"force: {impl}  cutoff={cfg.cutoff}  ensemble: {ensemble}")
    if impl == "grid":
        md = lj_fluid._make_grid_md(cfg, device)
        k, gate = lj_fluid._grid_inner_steps(cfg, md)
        if res.cadence is None:
            driver = f"gated, {k}-step windows at gate {gate}"
        else:
            driver = f"fixed rebuild cadence {res.cadence}"
        if cfg.dim == 3:
            kernels = f"B5 (cov {md.static_cov}) / B4 fallback, B6"
        elif md.rows_per_block > 1:
            kernels = f"B3 (packed, R={md.rows_per_block}, grid {md.grid_shape}), B2 packed"
        else:
            kernels = "B1, B2"
        print(f"grid: {md.cps} cells per side, capacity {md.cap}, skin {md.skin:.4f}; kernels {kernels}; "
              f"equilibration gated, {k}-step windows at gate {gate}; production {driver}")
    else:
        print(f"kernels: {_PATH_KERNELS[impl]}")
    n_snap = int(res.r_history.shape[0])
    print(f"phase times: build+warm-up {res.time_compile_s:.3f} s; "
          f"equilibration {res.time_eq_s:.3f} s; production {res.time_prod_s:.3f} s; "
          f"g(r) {res.time_rdf_s:.3f} s ({n_snap} snapshots)")
    steps = cfg.eq_steps + cfg.prod_steps
    ms_step = 1e3 * (res.time_eq_s + res.time_prod_s) / max(steps, 1)
    prod_psps = cfg.n * cfg.prod_steps / max(res.time_prod_s, 1e-12)
    print(f"throughput: {res.particle_steps_per_sec / 1e6:.2f}M particle-steps/s "
          f"({ms_step:.4f} ms/step; production phase, equilibrated: {prod_psps / 1e6:.2f}M)")
    drift = res.energy_drift
    if cfg.thermostat != "none":
        drift_s = "n/a (NVT: thermostat exchanges energy with the bath)"
    elif math.isfinite(drift):
        drift_s = f"{drift:.2e}"
    else:
        drift_s = "n/a (singular start: uniform init allows particle overlaps; use --init lattice)"
    p_s = f"; P* = {res.pressure:.4f}" if math.isfinite(res.pressure) else ""
    _, d_coef, d_resid = res.transport()
    d_s = f"; D* = {d_coef:.4e} (fit rms {d_resid:.1e})" if math.isfinite(d_coef) else ""
    print(f"energy drift: {drift_s}{p_s}{d_s}; kT after equilibration = {res.kt_eq:.4f}")
    if res.overflow:
        print("[WARNING] spatial-structure capacity/skin OVERFLOW was flagged: "
              "pair interactions may have been missed; results are suspect "
              "(increase --cutoff skin margin or reduce --dt).")
    if res.rdf_subset:
        print(f"note: g(r) estimated from a {res.rdf_subset}-particle random "
              f"subset of the {cfg.n:,} particles (unbiased, higher variance).")
    if args.profile:
        from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import (
            profile_device,
            rebuild_read_cost,
            window_sync_cost,
        )

        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        # two sample blocks keep the trace small; per step, they do the
        # production phase's work
        traced = override(cfg, prod_steps=min(cfg.prod_steps, 2 * cfg.sample_every))
        dev_s, table = profile_device(lambda: lj_fluid.production(traced, res.state, res.cadence), trace)
        dev_ms = 1e3 * dev_s / max(traced.prod_steps, 1)
        wall_ms = 1e3 * res.time_prod_s / max(cfg.prod_steps, 1)
        print(table)
        print(f"profile (production, {traced.prod_steps} traced steps): device busy "
              f"{dev_ms:.4f} ms/step of {wall_ms:.4f} ms/step untraced wall; "
              f"busy share {dev_ms / wall_ms:.3f}, idle share {1 - dev_ms / wall_ms:.3f}; "
              f"trace: {trace}")
        if impl == "grid":
            gs = md.init(res.state.position, res.state.velocity)
            synced, unsynced = window_sync_cost(md, gs, k)
            print(f"per-window host sync ({k}-step windows): {synced:.4f} ms/step with a dmax2 "
                  f"read after each window, {unsynced:.4f} ms/step without; the sync costs "
                  f"{(synced - unsynced) / synced:.3f} of the step")
            if res.cadence is not None:
                read, unread = rebuild_read_cost(md, gs, res.cadence)
                print(f"per-rebuild max_occ read (fixed cadence {res.cadence}): {read:.4f} ms/step "
                      f"with the read that picks B5 or B4 after each rebuild, {unread:.4f} ms/step "
                      f"without; the read costs {(read - unread) / read:.3f} of the step")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jtps-torch", description="PyTorch + CUDA port of the particle-simulation engine"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_md(sub)
    args = parser.parse_args(argv)
    return {"md": cmd_md}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
