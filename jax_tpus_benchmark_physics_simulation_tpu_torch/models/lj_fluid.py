"""Workload: Lennard-Jones fluid MD (NVE, velocity-Verlet, PBC).

Port of the JAX package's ``models/lj_fluid.py``. One interface dispatches
the force to five implementations, as in the JAX package:

- ``dense_xla``    the dense O(N^2) ``LennardJones`` formula (the oracle);
- ``dense_pallas`` kernel B8, the tiled all-pairs kernel
                   (``ops/kernels/pairwise_cuda.py``), never (N, N);
- ``neighbor``     the O(N*K) Verlet list (``ops/kernels/neighbor_list.py``);
- ``cell``         the roll-based cell-dense force (``ops/kernels/cell_dense.py``);
- ``grid``         the grid-resident engines: 2D ``GridMD`` (B1 or, on the
                   packed layout, B3; B2) and 3D ``GridMD3`` (hybrid B5/B4
                   forces, B6 rebuilds, fixed-cadence NVE production). In a
                   process group of P > 1 ranks whose size divides the cells
                   per side, the row-sharded ``ShardedGridMD`` /
                   ``ShardedGridMD3`` (``parallel/``) on their halo kernels:
                   every rank runs the same phases on its own rows, and
                   :func:`run` warns from the primary rank only.

``thermostat="langevin"`` (grid engine only) makes every window BAOAB
Langevin at ``kt`` with friction ``gamma`` (NVT), on the gated drivers.

Phases: :func:`equilibrate` -> :func:`production` (sampled) -> :func:`rdf`;
:func:`run` times them. Random draws come from a ``torch.Generator`` seeded
with ``cfg.seed``; the same seed gives other numbers than the JAX
package's ``jax.random``. The Langevin noise is keyed by the stream seed
``cfg.seed + 0x5EED``, the global step and the particle id
(``noise_cuda``): each phase starts the grid state at the ``step`` of the
``ParticleState`` it is given and hands the advanced step on, so
consecutive phases and blocks draw fresh noise.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.runner import run_steps, run_trajectory
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.lennard_jones import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.pbc import wrap
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.integrators import velocity_verlet
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import (
    make_cell_grid_fn,
    make_lj_force_cell_dense,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.neighbor_list import (
    make_lj_force_neighbor,
    make_neighbor_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.pairwise_cuda import make_lj_force_pairwise
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.msd import (
    diffusion_coefficient,
    mean_squared_displacement,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.rdf import (
    _DEFAULT_MAX_PARTICLES as _RDF_MAX_PARTICLES,
    radial_distribution,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import (
    kinetic_energy,
    temperature,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import is_primary, world_size
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace

SKIN_DEFAULT = 0.4  # the skin everywhere but the 3D grid engine
IMPLS = ("dense_xla", "dense_pallas", "neighbor", "cell", "grid")


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


def make_potential(cfg: MDConfig) -> LennardJones:
    return LennardJones(sigma=cfg.sigma, epsilon=cfg.epsilon, box=cfg.box_size, cutoff=cfg.cutoff)


def _auto_picks_grid(cfg: MDConfig) -> bool:
    """Whether ``force_impl="auto"`` resolves to the grid engine."""
    skin0 = SKIN_DEFAULT if cfg.skin is None else cfg.skin
    cps = 0 if cfg.cutoff is None else int(cfg.box_size / (cfg.cutoff + skin0))
    return cfg.cutoff is not None and cfg.n >= 4096 and cps >= 3


def resolve_skin(cfg: MDConfig, impl: Optional[str] = None, n_devices: Optional[int] = None) -> float:
    """Concrete Verlet skin for ``cfg`` (``cfg.skin`` unless it is None), by
    the JAX package's policy: 0.4, except on the 3D grid engine (``impl``,
    default the one ``cfg`` resolves to), where the densest cell geometry
    wins. There it takes the largest cells-per-side with skin >=
    max(0.1, 80*sqrt(kT)*dt), rounded down to a multiple of ``n_devices``
    (default: the process group's size) so that the row-sharded engine
    stays available, and never coarser than the 0.4-skin geometry the same
    rounding gives."""
    if cfg.skin is not None:
        return cfg.skin
    if impl is None:
        impl = "grid" if cfg.force_impl == "grid" or (cfg.force_impl == "auto" and _auto_picks_grid(cfg)) else None
    if impl != "grid" or cfg.dim != 3 or cfg.cutoff is None:
        return SKIN_DEFAULT
    if n_devices is None:
        n_devices = world_size()
    box = cfg.box_size
    floor = max(0.1, 80.0 * cfg.kt**0.5 * cfg.dt)

    def cells(skin: float) -> int:
        c = int(box / (cfg.cutoff + skin))
        if n_devices > 1 and c >= n_devices:
            c -= c % n_devices
        return c

    cps = max(cells(floor), cells(SKIN_DEFAULT))
    if cps < 3:
        return SKIN_DEFAULT
    return box / cps - cfg.cutoff


def resolve_impl(cfg: MDConfig, device="cuda") -> str:
    """The force implementation for ``cfg`` on ``device``, by the JAX
    package's rule: ``auto`` takes the grid engine for N >= 4096 with a
    cutoff that gives >= 3 cells per side, the neighbor list for N >= 4096
    with a smaller box, B8 (``dense_pallas``) for N >= 1024 on the card
    (where the JAX package asks for a TPU), else ``dense_xla``."""
    impl = cfg.force_impl
    if impl == "auto":
        if _auto_picks_grid(cfg):
            impl = "grid" if cfg.dim in (2, 3) else "cell"
        elif cfg.cutoff is not None and cfg.n >= 4096:
            impl = "neighbor"
        elif cfg.n >= 1024 and torch.device(device).type == "cuda":
            impl = "dense_pallas"
        else:
            impl = "dense_xla"
    if impl not in IMPLS:
        raise ValueError(f"unknown force_impl: {impl!r} (auto | {' | '.join(IMPLS)})")
    if impl in ("neighbor", "cell", "grid") and cfg.cutoff is None:
        raise ValueError(f"force_impl={impl!r} requires a cutoff")
    if impl == "grid" and cfg.dim not in (2, 3):
        raise ValueError("force_impl='grid' supports dim 2 and 3")
    return impl


def _grid_thermostat(cfg: MDConfig) -> Optional[Tuple[float, float]]:
    """``(gamma, kT)`` for BAOAB Langevin windows, or None for NVE."""
    if cfg.thermostat == "langevin":
        return (cfg.gamma, cfg.kt)
    if cfg.thermostat not in ("none", None):
        raise ValueError(f"unknown thermostat {cfg.thermostat!r} (none | langevin)")
    return None


def _grid_seed(cfg: MDConfig) -> Optional[int]:
    """Seed of the Langevin noise stream, offset from the init-velocity
    seed as in the JAX package; None (no stream) for NVE."""
    return cfg.seed + 0x5EED if cfg.thermostat == "langevin" else None


def _make_grid_md(cfg: MDConfig, device):
    """The grid engine for ``cfg``. In 2D it takes the JAX package's default
    packing (``rows_per_block`` from ``choose_rows_per_block``). In a
    process group of P > 1 ranks, the row-sharded engine over the group,
    with this rank's rows on ``device`` (the JAX package's auto-shard over
    all devices). Where P does not divide the cells per side, ValueError:
    the JAX package then runs the one-device engine in its one process,
    but here each rank would run the whole grid."""
    if resolve_impl(cfg, device) != "grid":
        raise ValueError(f"force_impl={cfg.force_impl!r} does not resolve to the grid engine")
    _grid_thermostat(cfg)
    n_dev = world_size()
    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=resolve_skin(cfg, "grid", n_dev), rho=cfg.rho
    )
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated)
    sharded = n_dev > 1
    if sharded and gf.cells_per_side % n_dev:
        from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.scaling import _round_to_divisible_n

        raise ValueError(
            f"{n_dev} ranks do not divide the {gf.cells_per_side} cells per side at N={cfg.n}; "
            f"N={_round_to_divisible_n(cfg.n, cfg, [n_dev])} divides (mdscale's rounding)"
        )
    if cfg.dim == 3:
        # the JAX package's 3D default: B5 windows at the estimated
        # occupancy bound with the exact B4 fallback. k_mov is the engines'
        # default 16, not the JAX package's 8: there 8 halves the TPU's
        # mover-compaction planes, a speed choice; the port's B6 compacts
        # nothing and drops no particle, so k_mov only sets the level of
        # the loud mover flag, which 8 raised on a correct melt at 18 cells
        # per side (14 movers in a cell, none lost)
        kw.update(static_cov="auto")
        if sharded:
            return ShardedGridMD3(gf, make_mesh(device=device), **kw)
        return GridMD3(gf, device=device, **kw)
    if sharded:
        return ShardedGridMD(gf, make_mesh(device=device), **kw)
    return GridMD(gf, device=device, **kw)


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


def _pairwise(cfg: MDConfig, with_energy: bool = False):
    """B8's force function (``(F, E)`` with ``with_energy``) for ``cfg``."""
    return make_lj_force_pairwise(
        n=cfg.n, sigma=cfg.sigma, epsilon=cfg.epsilon, box=cfg.box_size, cutoff=cfg.cutoff,
        with_energy=with_energy,
    )


def make_force_fn(cfg: MDConfig, device="cuda"):
    """Dense force dispatch (``R -> F``). The list paths carry a structure
    and are built in :func:`build_step`."""
    impl = resolve_impl(cfg, device)
    if impl == "dense_xla":
        return make_potential(cfg).force
    if impl == "dense_pallas":
        return _pairwise(cfg)
    raise ValueError(f"make_force_fn builds the dense paths, not force_impl={impl!r}")


def _make_list_force(cfg: MDConfig, impl: str):
    """The (spatial-structure fn, force fn) pair of a list path."""
    if impl == "neighbor":
        nf = make_neighbor_fn(
            cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=resolve_skin(cfg), rho=cfg.rho
        )
        return nf, make_lj_force_neighbor(nf, sigma=cfg.sigma, epsilon=cfg.epsilon)
    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=resolve_skin(cfg), rho=cfg.rho
    )
    return gf, make_lj_force_cell_dense(gf, sigma=cfg.sigma, epsilon=cfg.epsilon)


def build_step(cfg: MDConfig, device="cuda"):
    """Returns ``(init_fn, step_fn, get_state)`` over an opaque carry.

    Dense paths: the carry is the ParticleState. List paths: ``(state,
    structure)``, with the skin-gated rebuild in the step (one
    kick-drift-kick, one ``maybe_rebuild`` and its host read a step)."""
    box = cfg.box_size
    impl = resolve_impl(cfg, device)

    if impl not in ("neighbor", "cell"):
        init_fn, step_fn = velocity_verlet(make_force_fn(cfg, device), cfg.dt, wrap_fn=lambda r: wrap(r, box))
        return init_fn, step_fn, lambda carry: carry

    structure_fn, force_fn = _make_list_force(cfg, impl)
    dt = cfg.dt

    def init_fn(state: ParticleState):
        aux = structure_fn.build(state.position)
        return state.replace(force=force_fn(state.position, aux)), aux

    def step_fn(carry):
        state, aux = carry
        inv_m = 1.0 / state.mass[:, None]
        v_half = state.velocity + 0.5 * dt * state.force * inv_m
        r_new = wrap(state.position + dt * v_half, box)
        aux = structure_fn.maybe_rebuild(r_new, aux)
        f_new = force_fn(r_new, aux)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        return state.replace(position=r_new, velocity=v_new, force=f_new, time=state.time + dt), aux

    return init_fn, step_fn, lambda carry: carry[0]


def make_energy_fn(cfg: MDConfig, device="cuda"):
    """Potential-energy observable of a build_step carry, matched to the
    force path. ``dense_pallas`` takes it from B8's energy variant (the same
    function as ``LennardJones.energy``, which would hold several (N, N)
    temporaries a sample at N=16,384); ``dense_xla`` from
    ``LennardJones.energy``; the list paths reuse their carried structure."""
    impl = resolve_impl(cfg, device)
    if impl == "dense_pallas":
        fe = _pairwise(cfg, with_energy=True)
        return lambda carry: fe(carry.position)[1]
    if impl not in ("neighbor", "cell"):
        lj = make_potential(cfg)
        return lambda carry: lj.energy(carry.position)
    _, list_force = _make_list_force(cfg, impl)
    return lambda carry: list_force.energy(carry[0].position, carry[1])


def _carry_overflow(carry) -> torch.Tensor:
    """Spatial-structure overflow flag of a build_step carry (False for the
    dense paths, which have no capacity/skin structure to overflow)."""
    if isinstance(carry, tuple):
        return carry[1].overflow
    return torch.zeros((), dtype=torch.bool, device=carry.position.device)


def _counters(gs):
    """``(mover_flags, list_overflows)`` of a grid state, 0-d int32
    tensors: the rebuilds in which B6 found a cell with more than ``k_mov``
    movers (3D), and the targets whose partners overflowed a partner list;
    0 for the states that count neither."""
    lists = getattr(gs, "list_overflows", None)
    return getattr(gs, "mover_flags", 0), 0 if lists is None else lists


def equilibrate(cfg: MDConfig, state: ParticleState, md=None):
    """Equilibration (NVE, or Langevin NVT on the grid engine). Returns
    ``(state, overflow)``: the capacity/skin overflow flag (0-d bool
    tensor) is carried out, never dropped. ``md``: the grid engine to run
    (default :func:`_make_grid_md`'s), for example a row-sharded one."""
    final, overflow, _ = _equilibrate(cfg, state, md)
    return final, overflow


def _equilibrate(cfg: MDConfig, state: ParticleState, md):
    """:func:`equilibrate`, with the run's :func:`_counters` last."""
    device = state.position.device
    if resolve_impl(cfg, device) != "grid":
        init_fn, step_fn, get_state = build_step(cfg, device)
        carry = run_steps(step_fn, init_fn(state), cfg.eq_steps)
        return get_state(carry).replace(step=state.step + cfg.eq_steps), _carry_overflow(carry), (0, 0)
    md = md if md is not None else _make_grid_md(cfg, device)
    k, gate = _grid_inner_steps(cfg, md)
    thermo = _grid_thermostat(cfg)
    gs = md.init(state.position, state.velocity, seed=_grid_seed(cfg), step=state.step)
    n_chunks, rem = divmod(cfg.eq_steps, k)
    if n_chunks:
        gs = md.make_production_run(n_chunks * k, k, gate_frac=gate, thermostat=thermo)(gs)
    if rem:
        gs = md.make_chunk_step(rem, gate_frac=gate, thermostat=thermo)(gs)
    final = state.replace(
        position=md.positions(gs), velocity=md.velocities(gs), time=state.time + gs.time, step=gs.rng_counter
    )
    return final, gs.overflow, _counters(gs)


def production(cfg: MDConfig, state: ParticleState, cadence: Optional[int] = None, md=None):
    """Sampled production: every ``sample_every`` steps, the positions,
    kinetic and potential energy. ``cadence``: the fixed rebuild cadence of
    the 3D grid engine's fixed NVE driver (see :func:`production_cadence`);
    None keeps the displacement-gated driver, and the other paths ignore it.
    ``md``: the grid engine to run, as in :func:`equilibrate`.
    Returns ``(final_state, (r_history, ke_history, pe_history), overflow)``."""
    final, hist, overflow, _ = _production(cfg, state, cadence, md)
    return final, hist, overflow


def _production(cfg: MDConfig, state: ParticleState, cadence: Optional[int], md):
    """:func:`production`, with the run's :func:`_counters` last."""
    if cfg.prod_steps and cfg.sample_every > cfg.prod_steps:
        raise ValueError(
            f"sample_every ({cfg.sample_every}) > prod_steps ({cfg.prod_steps}): "
            "production would emit zero samples (empty histories, NaN drift). "
            "Lower sample_every or raise prod_steps."
        )
    device = state.position.device
    with trace.span("md.block", new_block=True):
        if resolve_impl(cfg, device) != "grid":
            return _stepped_production(cfg, state, device)
        return _grid_production(cfg, state, cadence, md)


def _stepped_production(cfg: MDConfig, state: ParticleState, device):
    """:func:`production` on the dense and list paths, inside its
    ``md.block`` span: each run of ``sample_every`` steps (and the unsampled
    tail) an ``md.window`` span, each sample an ``md.sample`` span."""
    init_fn, step_fn, get_state = build_step(cfg, device)
    energy_fn = make_energy_fn(cfg, device)

    def window(carry, steps=cfg.sample_every):
        with trace.span("md.window"):
            return run_steps(step_fn, carry, steps)

    def observe(carry):
        with trace.span("md.sample"):
            s = get_state(carry)
            return s.position, kinetic_energy(s), energy_fn(carry)

    n_samples, rem = divmod(cfg.prod_steps, cfg.sample_every)
    final, hist = run_trajectory(window, init_fn(state), n_samples, observe_fn=observe)
    if rem:
        final = window(final, rem)
    return get_state(final).replace(step=state.step + cfg.prod_steps), hist, _carry_overflow(final), (0, 0)


def _grid_production(cfg: MDConfig, state: ParticleState, cadence: Optional[int], md):
    """:func:`production` on the grid engine, inside its ``md.block`` span:
    the block's binning is the ``md.block.init`` span, each sample an
    ``md.sample`` span (``utils/trace.py``)."""
    device = state.position.device
    md = md if md is not None else _make_grid_md(cfg, device)
    k, gate = _grid_inner_steps(cfg, md)
    thermo = _grid_thermostat(cfg)
    with trace.span("md.block.init"):
        gs = md.init(state.position, state.velocity, seed=_grid_seed(cfg), step=state.step)
    use_fixed = cadence is not None
    if use_fixed:
        prod_block = md.make_production_run_fixed(cfg.sample_every, cadence, thermostat=thermo)
    else:
        prod_block = md.make_production_run(cfg.sample_every, k, gate_frac=gate, thermostat=thermo)
    r_hist, ke_hist, pe_hist = [], [], []
    n_samples = cfg.prod_steps // cfg.sample_every
    for _ in range(n_samples):
        gs = prod_block(gs)
        with trace.span("md.sample"):
            r_hist.append(md.positions(gs))
            ke_hist.append(md.kinetic_energy(gs))
            pe_hist.append(md.potential_energy(gs))
    rem = cfg.prod_steps - n_samples * cfg.sample_every
    if rem and use_fixed:
        gs = md.make_production_run_fixed(rem, cadence, thermostat=thermo)(gs)
    elif rem:
        # the tail runs in k-step windows: a longer window would erode the
        # skin margin
        n2, r2 = divmod(rem, k)
        if n2:
            gs = md.make_production_run(n2 * k, k, gate_frac=gate, thermostat=thermo)(gs)
        if r2:
            gs = md.make_chunk_step(r2, gate_frac=gate, thermostat=thermo)(gs)
    final = state.replace(
        position=md.positions(gs), velocity=md.velocities(gs), time=state.time + gs.time, step=gs.rng_counter
    )
    dtype = state.position.dtype
    if n_samples:
        hist = (torch.stack(r_hist), torch.stack(ke_hist), torch.stack(pe_hist))
    else:
        hist = (
            torch.zeros((0, cfg.n, cfg.dim), dtype=dtype, device=device),
            torch.zeros(0, dtype=dtype, device=device),
            torch.zeros(0, dtype=dtype, device=device),
        )
    return final, hist, gs.overflow, _counters(gs)


def production_cadence(cfg: MDConfig, kt_eq: float, md=None) -> Optional[int]:
    """Fixed rebuild cadence for the 3D grid engine's NVE production, from
    the MEASURED equilibrated temperature, as the JAX package's ``run``
    computes it: ``max(1, min(auto_cadence(kt_eq, prod_steps),
    sample_every))``. None (the gated driver, or no engine) in 2D, under a
    thermostat, off the grid engine, and where ``kt_eq`` is not finite and
    positive: a diverged or frozen state has no drift horizon."""
    if cfg.dim != 3 or cfg.thermostat not in ("none", None) or not (math.isfinite(kt_eq) and kt_eq > 0):
        return None
    if resolve_impl(cfg, "cpu") != "grid":  # the grid rule reads no device
        return None
    md = md if md is not None else _make_grid_md(cfg, "cpu")  # only its geometry is read
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
    # rebuilds in which B6 found a cell with more than k_mov movers (3D grid
    # engine; B6 moves them all, so nothing is lost and overflow stays down)
    mover_flags: int = 0
    # targets whose partners overflowed a partner list (grid engines; they
    # ran the counted loop, so nothing is lost)
    list_overflows: int = 0
    rdf_subset: int = 0  # >0: g(r) was estimated from this many particles
    # virial pressure of the final state (grid engine only; NaN elsewhere)
    pressure: float = float("nan")
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

    def transport(self):
        """``(msd_curve, D, fit_residual_rms)`` from the production samples:
        the sliding-origin MSD and the Einstein-relation self-diffusion
        coefficient (``ops/observables/msd.py``). Needs >= 4 samples."""
        if self.r_history.shape[0] < 4 or not self.box:
            return None, float("nan"), float("nan")
        msd = mean_squared_displacement(self.r_history, self.box)
        d_coef, resid = diffusion_coefficient(msd, self.dt_sample, self.r_history.shape[-1])
        return msd, float(d_coef), float(resid)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg: Optional[MDConfig] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    md=None,
) -> MDResult:
    """Full timed pipeline: equilibrate -> production -> g(r), matching the
    reference's three-phase timing (molecular_dynamics...:138-165).

    Before the timers start, a short run of the same phase functions
    (``sample_every`` steps of each) builds the kernels and warms the
    allocator; that cost is reported as ``time_compile_s``.

    A thermostat needs the grid engine (ValueError elsewhere, as in the JAX
    package). On the 3D grid engine the NVE production phase runs the
    fixed-cadence driver at :func:`production_cadence` of the measured
    equilibrated kT (under a thermostat, the gated driver). If that kT is NaN or not positive, the overflow flag
    is raised (and in 3D production runs the gated driver). The pressure
    is measured on the grid engine only. ``md`` overrides the grid engine,
    as in :func:`equilibrate`: a caller drives the row-sharded engine on
    one rank with it."""
    cfg = cfg or MDConfig()
    device = torch.device(device)
    impl = resolve_impl(cfg, device)
    if cfg.thermostat not in ("none", None) and impl != "grid":
        raise ValueError(
            f"thermostat={cfg.thermostat!r} is implemented for the grid engine only "
            f"(resolved force_impl: {impl!r}); use --force-impl grid / a cutoff so "
            "the grid path dispatches"
        )
    state = init_state(cfg, device, generator)

    t0 = time.perf_counter()
    warm = override(
        cfg,
        eq_steps=min(cfg.eq_steps, cfg.sample_every),
        prod_steps=min(cfg.prod_steps, cfg.sample_every),
    )
    warm_eq, _ = equilibrate(warm, state, md)
    production(warm, warm_eq, production_cadence(warm, float(temperature(warm_eq)), md), md)
    _sync(device)
    time_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    state_eq, overflow_eq, counters_eq = _equilibrate(cfg, state, md)
    overflow_eq = bool(overflow_eq)
    _sync(device)
    time_eq = time.perf_counter() - t0

    # a NaN (diverged) or zero (frozen) equilibrated temperature means the
    # state the production phase starts from is unusable: flag it loudly
    kt_eq = float(temperature(state_eq))
    if not (math.isfinite(kt_eq) and kt_eq > 0):
        overflow_eq = True
    cadence = production_cadence(cfg, kt_eq, md)

    t0 = time.perf_counter()
    final, (r_hist, ke_hist, pe_hist), overflow_prod, counters_prod = _production(cfg, state_eq, cadence, md)
    overflow_prod = bool(overflow_prod)
    _sync(device)
    time_prod = time.perf_counter() - t0
    mover_flags, list_overflows = (int(a) + int(b) for a, b in zip(counters_eq, counters_prod))
    overflow = overflow_eq or overflow_prod
    if overflow and is_primary():
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

    pressure = float("nan")
    if impl == "grid":
        md = md if md is not None else _make_grid_md(cfg, device)
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
        mover_flags=mover_flags,
        list_overflows=list_overflows,
        rdf_subset=_RDF_MAX_PARTICLES if cfg.n > _RDF_MAX_PARTICLES else 0,
        pressure=pressure,
        kt_eq=kt_eq,
        cadence=cadence,
        box=cfg.box_size,
        dt_sample=cfg.dt * cfg.sample_every,
    )
