"""Workload: Lennard-Jones fluid MD (NVE, velocity-Verlet, PBC).

Port of the JAX package's ``models/lj_fluid.py`` for its grid engines
(``force_impl="grid"``, which ``"auto"`` picks for N >= 4096 with a cutoff):
2D ``GridMD`` and 3D ``GridMD3`` (hybrid B5/B4 forces, fixed-cadence NVE
production). The other force paths and the Langevin thermostat raise
``NotImplementedError`` naming their ROADMAP.md item.

Phases: :func:`equilibrate` (NVE) -> :func:`production` (sampled NVE) ->
:func:`rdf`; :func:`run` times them. Random draws come from a
``torch.Generator`` seeded with ``cfg.seed``: the same seed gives other
numbers than the JAX package's ``jax.random``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.rdf import (
    _DEFAULT_MAX_PARTICLES as _RDF_MAX_PARTICLES,
    radial_distribution,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature

SKIN_DEFAULT = 0.4  # the skin everywhere but the 3D grid engine


def init_state(
    cfg: MDConfig, device="cuda", generator: Optional[torch.Generator] = None
) -> ParticleState:
    """``uniform``: R ~ U(0, box), V ~ N(0,1) sqrt(kT), as the reference
    (overlaps allowed). ``lattice``: square lattice placement (no
    overlaps). Draws are made on the CPU, then moved to ``device`` (the
    card unless the caller asks for the CPU), so a seed gives the same state
    on every device."""
    dtype = getattr(torch, cfg.dtype)
    gen = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    if cfg.init == "uniform":
        r = torch.rand((cfg.n, cfg.dim), generator=gen, dtype=dtype) * cfg.box_size
    elif cfg.init == "lattice":
        per_side = int(math.ceil(cfg.n ** (1.0 / cfg.dim)))
        spacing = cfg.box_size / per_side
        grid = torch.arange(per_side, dtype=dtype) * spacing + 0.5 * spacing
        mesh = torch.stack(torch.meshgrid(*([grid] * cfg.dim), indexing="ij"), dim=-1)
        r = mesh.reshape(-1, cfg.dim)[: cfg.n]
    else:
        raise ValueError(f"unknown init: {cfg.init}")
    v = torch.randn((cfg.n, cfg.dim), generator=gen, dtype=dtype) * math.sqrt(cfg.kt)
    if cfg.remove_com_drift:
        v = v - torch.mean(v, dim=0, keepdim=True)
    return ParticleState.create(r.to(device), v.to(device))


def _auto_picks_grid(cfg: MDConfig) -> bool:
    """Whether ``force_impl="auto"`` resolves to the grid engine."""
    skin0 = SKIN_DEFAULT if cfg.skin is None else cfg.skin
    cps = 0 if cfg.cutoff is None else int(cfg.box_size / (cfg.cutoff + skin0))
    return cfg.cutoff is not None and cfg.n >= 4096 and cps >= 3


def resolve_skin(cfg: MDConfig) -> float:
    """Concrete Verlet skin for ``cfg`` (``cfg.skin`` unless it is None), by
    the JAX package's policy on one device: 0.4, except on the 3D grid
    engine, where the densest cell geometry wins. There it takes the
    largest cells-per-side with skin >= max(0.1, 80*sqrt(kT)*dt), never
    coarser than the 0.4-skin geometry. (The JAX package also rounds the
    cells per side to a multiple of the device count, for its sharded
    engine, which the port does not have yet.)"""
    if cfg.skin is not None:
        return cfg.skin
    grid = cfg.force_impl == "grid" or (cfg.force_impl == "auto" and _auto_picks_grid(cfg))
    if not grid or cfg.dim != 3 or cfg.cutoff is None:
        return SKIN_DEFAULT
    box = cfg.box_size
    floor = max(0.1, 80.0 * cfg.kt**0.5 * cfg.dt)
    cps = max(int(box / (cfg.cutoff + floor)), int(box / (cfg.cutoff + SKIN_DEFAULT)))
    if cps < 3:
        return SKIN_DEFAULT
    return box / cps - cfg.cutoff


def resolve_impl(cfg: MDConfig) -> str:
    """The force implementation for ``cfg``; the port has only ``"grid"``."""
    impl = cfg.force_impl
    if impl == "auto":
        if _auto_picks_grid(cfg):
            impl = "grid"
        else:
            raise NotImplementedError(
                f"force_impl='auto' picks a dense or neighbor-list path for n={cfg.n}, "
                f"cutoff={cfg.cutoff}; the port has only the grid engine so far "
                "(ROADMAP.md section 1, still to port: 'The other force paths'). Pass "
                "force_impl='grid' with a cutoff."
            )
    if impl != "grid":
        raise NotImplementedError(
            f"force_impl={impl!r} is not ported yet (ROADMAP.md section 1, still to "
            "port: 'The other force paths'); the port runs force_impl='grid'"
        )
    if cfg.cutoff is None:
        raise ValueError("force_impl='grid' requires a cutoff")
    if cfg.dim not in (2, 3):
        raise ValueError("force_impl='grid' supports dim 2 and 3")
    return impl


def _make_grid_md(cfg: MDConfig, device):
    resolve_impl(cfg)
    if cfg.thermostat == "langevin":
        raise NotImplementedError(
            "the Langevin window is not ported yet (ROADMAP.md section 1, still to "
            "port: 'The rest of 2D GridMD' and 'The rest of 3D GridMD3'); "
            "the port runs NVE (thermostat='none')"
        )
    if cfg.thermostat not in ("none", None):
        raise ValueError(f"unknown thermostat {cfg.thermostat!r} (none | langevin)")
    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=resolve_skin(cfg), rho=cfg.rho
    )
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated, device=device)
    if cfg.dim == 3:
        # the JAX package's 3D default: B5 windows at the estimated
        # occupancy bound with the exact B4 fallback, and k_mov=8 with its
        # loud mover flag
        return GridMD3(gf, static_cov="auto", migrate_k_mov=8, **kw)
    return GridMD(gf, **kw)


def _grid_inner_steps(cfg: MDConfig, md) -> Tuple[int, float]:
    """Rebuild cadence ``(n_inner, gate_frac)`` from the engine's coupled
    sizing, with the window clipped to the largest divisor of sample_every
    (so production sampling aligns with windows; a shorter window at the
    same gate is always safe)."""
    auto, gate = md.auto_chunk_params(kt=cfg.kt)
    k = min(auto, cfg.sample_every)
    while cfg.sample_every % k:
        k -= 1
    return max(1, k), gate


def equilibrate(cfg: MDConfig, state: ParticleState):
    """NVE equilibration on the grid engine. Returns ``(state, overflow)``:
    the capacity/skin overflow flag (0-d bool tensor) is carried out, never
    dropped."""
    md = _make_grid_md(cfg, state.position.device)
    k, gate = _grid_inner_steps(cfg, md)
    gs = md.init(state.position, state.velocity)
    n_chunks, rem = divmod(cfg.eq_steps, k)
    if n_chunks:
        gs = md.make_production_run(n_chunks * k, k, gate_frac=gate)(gs)
    if rem:
        gs = md.make_chunk_step(rem, gate_frac=gate)(gs)
    final = state.replace(
        position=md.positions(gs), velocity=md.velocities(gs), time=state.time + gs.time
    )
    return final, gs.overflow


def production(cfg: MDConfig, state: ParticleState, cadence: Optional[int] = None):
    """Sampled NVE production: every ``sample_every`` steps, the positions,
    kinetic and potential energy. ``cadence``: the fixed rebuild cadence of
    the 3D engine's fixed driver (see :func:`production_cadence`); None
    keeps the displacement-gated driver. Returns
    ``(final_state, (r_history, ke_history, pe_history), overflow)``."""
    if cfg.prod_steps and cfg.sample_every > cfg.prod_steps:
        raise ValueError(
            f"sample_every ({cfg.sample_every}) > prod_steps ({cfg.prod_steps}): "
            "production would emit zero samples (empty histories, NaN drift). "
            "Lower sample_every or raise prod_steps."
        )
    md = _make_grid_md(cfg, state.position.device)
    k, gate = _grid_inner_steps(cfg, md)
    gs = md.init(state.position, state.velocity)
    use_fixed = cadence is not None and hasattr(md, "make_production_run_fixed")
    if use_fixed:
        prod_block = md.make_production_run_fixed(cfg.sample_every, cadence)
    else:
        prod_block = md.make_production_run(cfg.sample_every, k, gate_frac=gate)
    r_hist, ke_hist, pe_hist = [], [], []
    n_samples = cfg.prod_steps // cfg.sample_every
    for _ in range(n_samples):
        gs = prod_block(gs)
        r_hist.append(md.positions(gs))
        ke_hist.append(md.kinetic_energy(gs))
        pe_hist.append(md.potential_energy(gs))
    rem = cfg.prod_steps - n_samples * cfg.sample_every
    if rem and use_fixed:
        gs = md.make_production_run_fixed(rem, cadence)(gs)
    elif rem:
        # the tail runs in k-step windows: a longer window would erode the
        # skin margin
        n2, r2 = divmod(rem, k)
        if n2:
            gs = md.make_production_run(n2 * k, k, gate_frac=gate)(gs)
        if r2:
            gs = md.make_chunk_step(r2, gate_frac=gate)(gs)
    final = state.replace(
        position=md.positions(gs), velocity=md.velocities(gs), time=state.time + gs.time
    )
    dev, dtype = state.position.device, state.position.dtype
    if n_samples:
        hist = (torch.stack(r_hist), torch.stack(ke_hist), torch.stack(pe_hist))
    else:
        hist = (
            torch.zeros((0, cfg.n, cfg.dim), dtype=dtype, device=dev),
            torch.zeros(0, dtype=dtype, device=dev),
            torch.zeros(0, dtype=dtype, device=dev),
        )
    return final, hist, gs.overflow


def production_cadence(cfg: MDConfig, kt_eq: float) -> Optional[int]:
    """Fixed rebuild cadence for the 3D NVE production, from the MEASURED
    equilibrated temperature, as the JAX package's ``run`` computes it:
    ``max(1, min(auto_cadence(kt_eq, prod_steps), sample_every))``. None
    (the gated driver) in 2D, and where ``kt_eq`` is not finite and
    positive: a diverged or frozen state has no drift horizon."""
    if cfg.dim != 3 or not (math.isfinite(kt_eq) and kt_eq > 0):
        return None
    md = _make_grid_md(cfg, "cpu")  # only its geometry is read
    return max(1, min(md.auto_cadence(kt_eq, cfg.prod_steps), cfg.sample_every))


def rdf(cfg: MDConfig, r_history: torch.Tensor):
    """g(r) with the reference's binning defaults (molecular_dynamics...:156-162)."""
    r_max = cfg.box_size / 2.0
    nbins = int(r_max / cfg.rdf_dr)
    return radial_distribution(r_history, cfg.box_size, nbins, r_max, dim=cfg.dim, seed=cfg.seed)


@dataclass
class MDResult:
    state: ParticleState
    r_history: torch.Tensor
    ke_history: torch.Tensor
    pe_history: torch.Tensor
    rdf_r: torch.Tensor
    rdf_g: torch.Tensor
    time_eq_s: float
    time_prod_s: float
    time_rdf_s: float
    # kernel build (first call in the process) and a short warm-up run of
    # both phases, paid before the phase timers start
    time_compile_s: float = 0.0
    particle_steps_per_sec: float = 0.0
    # Capacity/skin overflow: True means some structural invariant was
    # violated mid-run and the physics after that point is suspect.
    overflow: bool = False
    rdf_subset: int = 0  # >0: g(r) was estimated from this many particles
    pressure: float = float("nan")  # virial pressure of the final state
    kt_eq: float = float("nan")  # temperature of the equilibrated state
    cadence: Optional[int] = None  # fixed production rebuild cadence (None: gated)
    box: float = 0.0
    dt_sample: float = 0.0

    @property
    def energy_drift(self) -> float:
        """Max relative drift of total energy over production samples."""
        e = (self.ke_history + self.pe_history).double()
        if e.shape[0] == 0:
            return float("nan")
        return float(torch.max(torch.abs(e - e[0]) / torch.abs(e[0])))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg: Optional[MDConfig] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> MDResult:
    """Full timed pipeline: equilibrate -> production -> g(r), matching the
    reference's three-phase timing (molecular_dynamics...:138-165).

    Before the timers start, a short run of the same phase functions
    (``sample_every`` steps of each) builds the kernels and warms the
    allocator; that cost is reported as ``time_compile_s``.

    In 3D the production phase runs the fixed-cadence driver at
    :func:`production_cadence` of the measured equilibrated kT. If that kT
    is NaN or not positive, the overflow flag is raised and production runs
    the gated driver."""
    cfg = cfg or MDConfig()
    device = torch.device(device)
    state = init_state(cfg, device, generator)

    t0 = time.perf_counter()
    warm = override(
        cfg,
        eq_steps=min(cfg.eq_steps, cfg.sample_every),
        prod_steps=min(cfg.prod_steps, cfg.sample_every),
    )
    warm_eq, _ = equilibrate(warm, state)
    production(warm, warm_eq, production_cadence(warm, float(temperature(warm_eq))))
    _sync(device)
    time_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    state_eq, overflow_eq = equilibrate(cfg, state)
    overflow_eq = bool(overflow_eq)
    _sync(device)
    time_eq = time.perf_counter() - t0

    # a NaN (diverged) or zero (frozen) equilibrated temperature means the
    # state the production phase starts from is unusable: flag it loudly
    kt_eq = float(temperature(state_eq))
    if not (math.isfinite(kt_eq) and kt_eq > 0):
        overflow_eq = True
    cadence = production_cadence(cfg, kt_eq)

    t0 = time.perf_counter()
    final, (r_hist, ke_hist, pe_hist), overflow_prod = production(cfg, state_eq, cadence)
    overflow_prod = bool(overflow_prod)
    _sync(device)
    time_prod = time.perf_counter() - t0
    overflow = overflow_eq or overflow_prod
    if overflow:
        import warnings

        warnings.warn(
            "MD spatial structure reported a capacity/skin overflow: some "
            "pair interactions may have been missed. Results are suspect — "
            "increase skin/capacity or reduce dt.",
            stacklevel=2,
        )

    t0 = time.perf_counter()
    rdf_r, rdf_g = rdf(cfg, r_hist)
    _sync(device)
    time_rdf = time.perf_counter() - t0

    md = _make_grid_md(cfg, device)
    pressure = float(md.pressure(md.init(final.position, final.velocity)))

    return MDResult(
        state=final,
        r_history=r_hist,
        ke_history=ke_hist,
        pe_history=pe_hist,
        rdf_r=rdf_r,
        rdf_g=rdf_g,
        time_eq_s=time_eq,
        time_prod_s=time_prod,
        time_rdf_s=time_rdf,
        time_compile_s=time_compile,
        particle_steps_per_sec=cfg.n
        * (cfg.eq_steps + cfg.prod_steps)
        / max(time_eq + time_prod, 1e-12),
        overflow=overflow,
        rdf_subset=_RDF_MAX_PARTICLES if cfg.n > _RDF_MAX_PARTICLES else 0,
        pressure=pressure,
        kt_eq=kt_eq,
        cadence=cadence,
        box=cfg.box_size,
        dt_sample=cfg.dt * cfg.sample_every,
    )
