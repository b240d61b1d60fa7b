"""Command line of the PyTorch port: ``md``, ``mdscale``, ``nbody``,
``em3``, ``vmc``, ``bench`` and ``devices``.

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
    torchrun --nproc_per_node 4 -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli md \
        --N 97044 --cutoff 2.5 --init lattice             # row-sharded over 4 cards
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli mdscale --N 100000
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli mdscale --device cpu --virtual 4 \
        --N 20000                                         # 4 gloo processes on the CPU
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli nbody   # RK4 + GW + Lyapunov
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli em3     # 3 charges, Boris push
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli vmc     # VMC -> DMC oscillator
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli bench   # the op suite
    python -m jax_tpus_benchmark_physics_simulation_tpu_torch.cli devices

Flag names follow the JAX package's ``jtps`` subcommands (its ``cli.py``),
plus ``--device`` (``cuda`` by default, ``cpu`` for the plain versions).
Output is plain text lines. Not ported yet: plots, media (GIF, WAV, JSON),
run manifests and checkpoints (``--plot``, ``--no-plot``, ``--no-gif``,
``--show``, ``--no-media``, ``--manifest``, ``--ckpt-dir``, md's
``--output`` and ``--msd-output``), ``nbody --interactive`` (it needs
``rich``), and the ``check-deps`` subcommand. ``vmc`` takes walker
snapshots every 25 epochs and DMC steps, as JAX's does without
``--no-gif``, though the GIF that would show them waits.

Under a launcher (``torchrun``: ``WORLD_SIZE`` set) ``md`` joins the
process group, NCCL between cards, and the grid engine runs row-sharded
over it; a group whose size does not divide the cells per side, or a
force path other than the grid engine, is refused (each rank would run
the whole job). The primary rank reports.
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
                   help="after the run, trace two production sample blocks with the "
                        "program's spans on (utils/trace.py): once without the profiler, "
                        "for each span's host time and host reads a step, then under "
                        "torch.profiler, for the card's busy and idle share and its busy "
                        "and idle time by span; writes DIR/trace.json (needs --device cuda)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")


def cmd_md(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import RowSharded
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import is_primary, world_size

    cfg = override(
        MDConfig(),
        n=args.N, dim=args.dim, rho=args.rho, kt=args.kT, dt=args.dt,
        eq_steps=args.eq_steps, prod_steps=args.prod_steps,
        sample_every=args.sample_every, seed=args.seed, cutoff=args.cutoff,
        force_impl=args.force_impl, init=args.init,
        thermostat=args.thermostat, gamma=args.gamma,
    )
    device = _launched_device(args.device)
    if not _check_device(device):
        return 2
    if args.profile and device.type != "cuda":
        print("error: --profile measures the card: use --device cuda", file=sys.stderr)
        return 2
    try:
        impl = lj_fluid.resolve_impl(cfg, device)
        if world_size() > 1 and impl != "grid":
            raise ValueError(f"force_impl {impl!r} runs on one device: only the grid engine shards over ranks")
        res = lj_fluid.run(cfg, device=device)
    except (NotImplementedError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not is_primary():
        return 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ensemble = "NVE" if cfg.thermostat == "none" else f"NVT (langevin, gamma={cfg.gamma})"
    ranks = f" x {world_size()} ranks" if world_size() > 1 else ""
    print(f"Molecular Dynamics (PyTorch port) on {name}{ranks}")
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
        if isinstance(md, RowSharded):
            halo = f"B5 halo (cov {md.static_cov}) / B4 halo, B6 halo" if cfg.dim == 3 else "B1 halo, B2 halo"
            kernels = f"{halo}, row-sharded over {md.n_shards} ranks ({md.rows_local} rows each)"
        elif cfg.dim == 3:
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
        from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace as spans
        from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import profile_device

        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        # two sample blocks keep the trace small; per step, they do the
        # production phase's work
        traced = override(cfg, prod_steps=min(cfg.prod_steps, 2 * cfg.sample_every))
        steps = max(traced.prod_steps, 1)

        def block():
            lj_fluid.production(traced, res.state, res.cadence)

        spans.reset()
        spans.enable()
        try:
            torch.cuda.synchronize()
            reads = spans.SYNCS
            block()  # host times without the profiler's inflation
            torch.cuda.synchronize()
            reads = spans.SYNCS - reads
            host = spans.table(steps)
            spans.reset()
            dev_s, table, _ = profile_device(block, trace)  # the spans land in the trace
        finally:
            spans.disable()
            spans.reset()
        dev_ms = 1e3 * dev_s / steps
        wall_ms = 1e3 * res.time_prod_s / max(cfg.prod_steps, 1)
        print(table)
        print(f"profile (production, {traced.prod_steps} traced steps): device busy "
              f"{dev_ms:.4f} ms/step of {wall_ms:.4f} ms/step untraced wall; "
              f"busy share {dev_ms / wall_ms:.3f}, idle share {1 - dev_ms / wall_ms:.3f}; "
              f"trace: {trace}")
        print(f"host spans (spans on, no profiler; {reads / steps:.4f} host reads a step):")
        print(host)
        busy, idle = spans.by_span(trace)
        print("device by span (profiled; busy: the span open at each op's launch, "
              "idle: the span open when each gap began), ms/step:")
        for name in sorted(set(busy) | set(idle), key=lambda n: -idle.get(n, 0.0)):
            print(f"  {name:<20} busy {1e3 * busy.get(name, 0.0) / steps:.4f}  "
                  f"idle {1e3 * idle.get(name, 0.0) / steps:.4f}")
        print(f"  {'all':<20} busy {1e3 * sum(busy.values()) / steps:.4f}  "
              f"idle {1e3 * sum(idle.values()) / steps:.4f}")
    return 0


def _launched_device(device: str):
    """The device of this process: ``device``, or under a launcher
    (``WORLD_SIZE`` set) this rank's card after joining the process group
    (gloo and the CPU with ``--device cpu``)."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import init_multihost

    device = torch.device(device)
    if "WORLD_SIZE" in os.environ:
        init_multihost(backend="gloo" if device.type == "cpu" else "nccl")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _add_mdscale(sub):
    p = sub.add_parser(
        "mdscale",
        help="multi-device MD scaling sweep (strong/weak) of the row-sharded grid engines, "
             "with one-device trajectory parity checks",
    )
    p.add_argument("--N", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="2D (ShardedGridMD: B1 halo, B2 halo) or 3D (ShardedGridMD3: B5/B4 halo, B6 halo)")
    p.add_argument("--rho", type=float, default=0.8)
    p.add_argument("--kT", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--cutoff", type=float, default=2.5)
    p.add_argument("--mode", type=str, default="strong", choices=["strong", "weak"])
    p.add_argument("--steps", type=int, default=200, help="timed steps per sweep point")
    p.add_argument("--parity-steps", type=int, default=50,
                   help="steps for the sharded-vs-one-device parity check (0 = skip)")
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="mesh sizes to sweep (default: 1, powers of 2, the card count, or D with --virtual)")
    p.add_argument("--virtual", type=int, default=0, metavar="D",
                   help="run on D gloo processes on the CPU (the JAX package's D virtual CPU "
                        "devices): the sharded code path with real collectives; needs --device cpu")
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--manifest", type=str, default=None,
                   help="not supported yet: run manifests wait for the port's report module")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (one process a card) or cpu (with --virtual)")


def cmd_mdscale(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import is_primary, world_size
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
    from jax_tpus_benchmark_physics_simulation_tpu_torch.report.export import write_csv

    if args.manifest:
        print("error: --manifest is not supported yet (run manifests wait for the report module)",
              file=sys.stderr)
        return 2
    if args.virtual and args.device != "cpu":
        print("error: --virtual D runs D gloo processes on the CPU: pass --device cpu", file=sys.stderr)
        return 2
    device = _launched_device(args.device)
    if not args.virtual and not _check_device(device):
        return 2
    # sane start: uniform init's overlaps eject particles at skin-violating speeds
    cfg = override(MDConfig(), n=args.N, dim=args.dim, rho=args.rho, kt=args.kT, dt=args.dt,
                   cutoff=args.cutoff, init="lattice")
    if args.virtual:
        ranks = args.virtual
    elif world_size() > 1:
        ranks = 0  # a launcher started the ranks
    else:  # one process a card, spawned here
        ranks = max(args.devices) if args.devices else (torch.cuda.device_count() if device.type == "cuda" else 1)
    backend = "gloo" if device.type == "cpu" else "nccl"
    devices = args.devices or scaling.default_devices(ranks or world_size())
    if is_primary():
        where = (f"{args.virtual} gloo processes on the CPU" if args.virtual
                 else f"{device.type}, {ranks or world_size()} rank(s)")
        print(f"MD scaling sweep (row-sharded grid engine): N={cfg.n:,} dim={cfg.dim} mode={args.mode} "
              f"steps={args.steps} devices={devices} on {where}", flush=True)
    sweep = (cfg, devices, args.mode, args.steps, args.parity_steps)
    try:
        if ranks > 1:
            rows = run_ranks(scaling.sweep_on_rank, ranks, *sweep, device.type, backend=backend)[0]
        else:
            rows = scaling.md_scaling_sweep(*sweep, log=lambda msg: print(msg, flush=True), device=device)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not is_primary():
        return 0
    if not rows:
        print("no sweep points ran")
        return 1
    _print_rows("MD scaling", rows, ("devices", "n", "ms_per_step", "psps", "efficiency_pct", "parity_ok"))
    if args.csv:
        write_csv(rows, args.csv)
        print(f"CSV written: {args.csv}")
    if any(r["parity_ok"] is False for r in rows):
        print("[WARNING] sharded trajectory parity FAILED on some points")
        return 1
    return 0


def _add_device(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the card) or cpu")


def _check_device(device) -> bool:
    """False (after a message) when the card is asked for and absent."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return False
    return True


def _add_nbody(sub):
    p = sub.add_parser("nbody", help="N-body BH merger + GW + Lyapunov")
    p.add_argument("--n_bodies", type=int, default=3)
    p.add_argument("--masses", type=float, nargs="+", default=None,
                   help="per-body masses in Msun (default 30 each)")
    p.add_argument("--initial_distance", type=float, default=100.0)
    p.add_argument("--initial_velocity", type=float, default=0.1)
    p.add_argument("--sim_time", type=float, default=200.0)
    p.add_argument("--d_gw", type=float, default=410.0)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--no-chaos", action="store_true")
    p.add_argument("--lyapunov", type=str, default="tangent", choices=["tangent", "two_trajectory"])
    _add_device(p)


def cmd_nbody(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import NBodyConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import nbody_merger

    if not _check_device(args.device):
        return 2
    masses = tuple(args.masses) if args.masses else tuple([30.0] * args.n_bodies)
    cfg = override(
        NBodyConfig(), n_bodies=args.n_bodies, masses=masses,
        initial_distance=args.initial_distance, initial_velocity=args.initial_velocity,
        sim_time=args.sim_time, d_gw_mpc=args.d_gw, num_steps=args.num_steps,
        compute_chaos=not args.no_chaos, lyapunov_method=args.lyapunov,
    )
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"N-Body BH merger (PyTorch port) on {name}")
    print(f"bodies={cfg.n_bodies} masses={masses} sep={cfg.initial_distance} "
          f"v/c={cfg.initial_velocity} T={cfg.sim_time} steps={cfg.num_steps} "
          f"D_gw={cfg.d_gw_mpc} Mpc integrator={cfg.integrator}")
    print(f"kernels: none: plain PyTorch on {cfg.n_bodies} bodies")
    try:
        res = nbody_merger.run(cfg, device=device)
    except ValueError as exc:  # the two-trajectory start that rounds away
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"simulation: {res.sim_wall_s * 1e3:.2f} ms "
          f"({res.sim_wall_s * 1e3 / max(cfg.num_steps, 1):.4f} ms per RK4 step, GW strain included)")
    h = res.h_plus
    print(f"GW strain h_+: {h.numel()} samples, max |h_+| {float(h.abs().max()):.4e}")
    if res.lyapunov is not None:
        print(f"Lyapunov exponent ({cfg.lyapunov_method}): {res.lyapunov:.4f} (positive = chaotic orbit)")
    return 0


def _add_em3(sub):
    p = sub.add_parser("em3", help="three charged particles, gravity + EM field")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--G", type=float, default=1.0)
    p.add_argument("--Bz", type=float, default=1.0)
    p.add_argument("--Bk", type=float, default=0.0)
    p.add_argument("--Ex", type=float, default=0.0)
    p.add_argument("--Ey", type=float, default=0.0)
    p.add_argument("--integrator", type=str, default="boris", choices=["boris", "reference"])
    _add_device(p)


def cmd_em3(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import EM3Config, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import em_three_particles as em3

    if not _check_device(args.device):
        return 2
    cfg = override(EM3Config(), dt=args.dt, n_steps=args.n_steps, g=args.G, bz=args.Bz, bk=args.Bk,
                   ex=args.Ex, ey=args.Ey, integrator=args.integrator)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"EM three-particle (PyTorch port) on {name}")
    print(f"dt={cfg.dt} steps={cfg.n_steps} G={cfg.g} Bz={cfg.bz} Bk={cfg.bk} E=({cfg.ex}, {cfg.ey}) "
          f"integrator={cfg.integrator}")
    print("kernels: none: plain PyTorch on 3 particles")
    res = em3.run(cfg, device=device)
    traj = res.trajectory
    print(f"em3: {cfg.n_steps} steps in {res.wall_time_s * 1e3:.2f} ms "
          f"({res.wall_time_s * 1e3 / max(cfg.n_steps, 1):.4f} ms per step, eager host loop)")
    print(f"trajectory {tuple(traj.shape)}, finite {bool(torch.isfinite(traj).all())}, "
          f"max |r| {float(traj.abs().max()):.4f}")
    return 0


def _add_vmc(sub):
    p = sub.add_parser("vmc", help="VMC + DMC quantum harmonic oscillator")
    p.add_argument("--n_walkers", type=int, default=10000)
    p.add_argument("--n_epochs", type=int, default=3000)
    p.add_argument("--n_equil", type=int, default=100)
    p.add_argument("--step_size", type=float, default=2.0)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--n_dmc", type=int, default=500)
    p.add_argument("--dmc_dt", type=float, default=0.01)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--resampler", type=str, default="systematic", choices=["systematic", "multinomial"])
    p.add_argument("--potential", type=str, default="harmonic", choices=["harmonic", "anharmonic"],
                   help="anharmonic: V += lam*sum(x^4), generic autodiff local energy + "
                        "{alpha, beta} trial wavefunction")
    p.add_argument("--lam", type=float, default=0.2, help="quartic coupling (potential=anharmonic)")
    _add_device(p)


def cmd_vmc(args) -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import quantum_oscillator

    if not _check_device(args.device):
        return 2
    cfg = override(
        VMCDMCConfig(), n_walkers=args.n_walkers, n_epochs=args.n_epochs, n_equil=args.n_equil,
        step_size=args.step_size, lr=args.lr, n_dmc=args.n_dmc, dmc_dt=args.dmc_dt, dim=args.dim,
        resampler=args.resampler, potential=args.potential, lam=args.lam, snapshot_every=25,
    )
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    pot = cfg.potential + (f" (lam={cfg.lam})" if cfg.potential == "anharmonic" else "")
    print(f"VMC + DMC (PyTorch port) on {name}")
    print(f"walkers={cfg.n_walkers:,} dim={cfg.dim} epochs={cfg.n_epochs:,} equil/epoch={cfg.n_equil} "
          f"lr={cfg.lr} dmc_steps={cfg.n_dmc} dmc_dt={cfg.dmc_dt} resampler={cfg.resampler} potential={pot}")
    print("kernels: none: plain PyTorch ops on the walkers")

    def progress(epoch, energy, alpha):
        print(f"VMC epoch {epoch:,}  E={energy:9.6f}  alpha={alpha:.6f}", flush=True)

    res = quantum_oscillator.run(cfg, progress_cb=progress, device=device)
    alpha_note = f"(exact {res.exact_alpha})" if res.exact_alpha is not None else "(no closed form)"
    print(f"VMC  : E = {res.vmc_energy:.6f} (exact {res.exact_energy:.6f}), alpha = {res.vmc_alpha:.6f} "
          f"{alpha_note}  [{res.vmc_wall_s:.3f} s]")
    mean, err = res.dmc.mean_energy()
    print(f"DMC  : E = {float(mean):.6f} +- {float(err):.6f} (exact {res.exact_energy:.6f})  "
          f"[{res.dmc_wall_s:.3f} s]")
    return 0


def _add_bench(sub):
    p = sub.add_parser("bench", help="op benchmark suite (matmul/FFT/conv/bandwidth)")
    p.add_argument("-w", "--warmup", type=int, default=1,
                   help="untimed executions of the timing loop (each = STEPS op iterations)")
    p.add_argument("-r", "--repeats", type=int, default=3, help="timed executions per op (best-of)")
    p.add_argument("-m", "--steps", type=int, default=2500)
    p.add_argument("-mxs", "--matrix_size", type=int, default=4096)
    p.add_argument("-md", "--matrix_depth", type=int, default=6)
    p.add_argument("-c", "--conv_size", type=int, default=128,
                   help="conv input H=W (the compute-bound sizing; --reference-conv for the "
                        "reference's -c 64 -b 8 --conv_cin 3)")
    p.add_argument("-b", "--batch_size", type=int, default=64)
    p.add_argument("--conv_cin", type=int, default=32)
    p.add_argument("--conv_cout", type=int, default=64)
    p.add_argument("--reference-conv", action="store_true",
                   help="use the reference's conv sizing (-c 64 -b 8 --conv_cin 3 --conv_cout 64)")
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--max_cores", type=int, default=0,
                   help="0 = auto; the port runs one device (more waits for the multi-device slice)")
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--csv-append", action="store_true",
                   help="append to --csv (no header rewrite), for split sweeps")
    p.add_argument("--ops", type=str, default=None,
                   help="comma list of ops to run (2D,3D,Conv,2D_FFT,3D_FFT,Bandwidth); default all")
    p.add_argument("--no-isolate", action="store_true",
                   help="run the sweep in this process instead of the default crash-isolated "
                        "worker subprocess")
    _add_device(p)


_BENCH_COLUMNS = ("test", "cores", "tflops", "bandwidth_gbs", "avg_ms", "error")


def _print_rows(title: str, rows, columns=None) -> None:
    print(f"{title}:")
    for row in rows:
        keys = columns or tuple(row)
        cells = []
        for k in keys:
            if k in row:
                v = row[k]
                cells.append(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
        print("  " + "  ".join(cells))


def cmd_bench(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import BenchConfig
    from jax_tpus_benchmark_physics_simulation_tpu_torch.report.export import write_csv

    if args.reference_conv:
        args.conv_size, args.batch_size = 64, 8
        args.conv_cin, args.conv_cout = 3, 64
    cfg = BenchConfig(
        warmup=max(0, args.warmup), repeats=max(1, args.repeats), steps=max(1, args.steps),
        matrix_size=max(1, args.matrix_size), matrix_depth=max(1, args.matrix_depth),
        conv_size=max(1, args.conv_size), batch_size=max(1, args.batch_size),
        conv_cin=max(1, args.conv_cin), conv_cout=max(1, args.conv_cout),
        precision=args.precision, max_cores=args.max_cores,
        ops=tuple(s.strip() for s in args.ops.split(",") if s.strip()) if args.ops else None,
    )
    if cfg.max_cores > 1:
        print(f"error: --max_cores {cfg.max_cores}: a sweep over several devices waits for "
              "the port's multi-device slice", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    if args.no_isolate:
        from jax_tpus_benchmark_physics_simulation_tpu_torch.bench import device_rows, run_sweep, system_info

        if not _check_device(args.device):
            return 2
        _print_rows("System information", [system_info(args.device)])
        _print_rows("Devices", device_rows(args.device))
        results = run_sweep(cfg, log=log, device=args.device)
    else:
        # the sweep runs in a worker subprocess; this process never
        # initializes CUDA, and a worker crash costs one loud row
        from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.isolate import run_sweep_isolated

        results, sysinfo, devrows = run_sweep_isolated(cfg, log=log, device=args.device)
        if sysinfo:
            _print_rows("System information", [sysinfo])
        if devrows:
            _print_rows("Devices", devrows)
    if not results:
        print("No benchmark results collected.")
        return 1
    _print_rows("Benchmark results", results, _BENCH_COLUMNS)
    if args.csv:
        write_csv(results, args.csv, append=args.csv_append)
        print(f"CSV written: {args.csv}")
    return 0


def _add_devices(sub):
    p = sub.add_parser("devices", help="list the devices")
    _add_device(p)


def cmd_devices(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sysinfo import device_rows

    if not _check_device(args.device):
        return 2
    _print_rows("Devices", device_rows(args.device))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jtps-torch", description="PyTorch + CUDA port of the particle-simulation engine"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_bench(sub)
    _add_md(sub)
    _add_mdscale(sub)
    _add_nbody(sub)
    _add_em3(sub)
    _add_vmc(sub)
    _add_devices(sub)
    args = parser.parse_args(argv)
    commands = {"bench": cmd_bench, "md": cmd_md, "mdscale": cmd_mdscale, "nbody": cmd_nbody,
                "em3": cmd_em3, "vmc": cmd_vmc, "devices": cmd_devices}
    return commands[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
