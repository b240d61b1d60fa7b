"""The port's grid Lennard-Jones engines as users run them, block by block.

Set-up builds the start state on the device from the seed, the engine
(``lj_fluid._make_grid_md``), equilibrates it (``lj_fluid.equilibrate``)
and works out the production driver as ``lj_fluid.run`` does: the gated
driver in 2D, the fixed-cadence driver at ``lj_fluid.production_cadence``
of the equilibrated kT in 3D, sized for the traffic's
``production_steps``. A block is one call of
``lj_fluid.production`` over ``block_steps`` steps, sampling positions,
kinetic and potential energy every ``sample_every`` steps.

The answers are checked against ``reference/lj_nve.py``: from the state a
block started at, the reference runs to the block's first sample, and the
positions, kinetic and potential energy there are compared.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature
from port_bench.counts import lattice, roofline
from port_bench.reference import lj_nve

# float32 resolves a coordinate near the box edge to about box * 2^-24:
# position gaps are given in this unit
F32_EPS = 2.0**-24


def _relative_gap(got: float, want: float) -> float:
    """``|got - want| / |want|``; infinite where the reference reads 0 and
    the program does not (a state that blew up reads NaN or 0)."""
    if want == 0.0:
        return 0.0 if got == 0.0 else math.inf
    return abs(got - want) / abs(want)


@dataclass
class Block:
    energy: torch.Tensor  # total energy at each sample
    sample: torch.Tensor  # positions at the first sample
    ke: torch.Tensor  # kinetic and potential energy at the first sample
    pe: torch.Tensor
    overflow: torch.Tensor  # 0-d bool


class System:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, overrides: Dict = None):
        t = [time.perf_counter()]
        md_kw = {**config["md"], **traffic.get("md", {}), **(overrides or {})}
        cfg = MDConfig(**md_kw)
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if config["start"] == "square_lattice":
            pos, vel = lattice.square_lattice(cfg.n, cfg.box_size, cfg.kt, gen)
        elif config["start"] == "fcc":
            pos, vel, _ = lattice.fcc_lattice(cfg.n, cfg.rho, cfg.kt, gen)
        else:
            raise ValueError(f"unknown start {config['start']!r}")
        self.n = cfg.n
        self.steps_per_block = traffic["block_steps"]
        self.cfg = override(cfg, eq_steps=traffic["eq_steps"], prod_steps=self.steps_per_block)
        self.md = lj_fluid._make_grid_md(self.cfg, self.device)
        t.append(time.perf_counter())
        eq, eq_overflow = lj_fluid.equilibrate(self.cfg, ParticleState.create(pos, vel), self.md)
        self.kt_eq = float(temperature(eq))  # a host read: equilibration has ended
        t.append(time.perf_counter())
        # lj_fluid.run sizes the fixed cadence for its whole production run:
        # here the traffic's ``production_steps``, more than any window runs
        run_cfg = override(self.cfg, prod_steps=traffic.get("production_steps", self.steps_per_block))
        self.cadence = lj_fluid.production_cadence(run_cfg, self.kt_eq, self.md)
        self.start, warm = self.block(eq)  # the warm-up block: every shape the window uses
        # host reads: the warm-up block has ended
        self.setup_overflow = [bool(eq_overflow), bool(warm.overflow)]
        t.append(time.perf_counter())
        names = ("start_and_engine_s", "equilibrate_s", "warm_up_s")
        self.phases = {k: b - a for k, a, b in zip(names, t, t[1:])}

    def block(self, state: ParticleState):
        final, (r_hist, ke_hist, pe_hist), overflow = lj_fluid.production(self.cfg, state, self.cadence, self.md)
        return final, Block(ke_hist + pe_hist, r_hist[0], ke_hist[0], pe_hist[0], overflow)

    def geometry(self) -> Dict:
        md, cfg = self.md, self.cfg
        geo = dict(dim=cfg.dim, n=cfg.n, box=md.box, cells_per_side=md.cps, capacity=md.cap,
                   skin=md.skin, grid_slots=math.prod(md.grid_shape), compensated=cfg.compensated,
                   kt_eq=self.kt_eq, setup_overflow=self.setup_overflow)
        if cfg.dim == 2:
            geo["rows_per_block"] = md.rows_per_block
            geo["gate"] = lj_fluid._grid_inner_steps(cfg, md)
        else:
            geo["cadence"] = self.cadence
            geo["static_cov"] = md.static_cov
        return geo

    def census(self, state: ParticleState):
        return roofline.pair_census(state.position, self.md.box, self.md.cps, self.cfg.cutoff)

    def checks(self, blocks: List[Block], kept: List, limits: Dict[str, float]):
        """``(values, failed)``: each compared number over the window, and
        the window blocks that broke a limit. ``kept``: ``(index, start
        state, Block)`` of the blocks whose first sample the reference
        recomputes from the state the block started at."""
        cfg = self.cfg
        p = lj_nve.LJ(box=cfg.box_size, cutoff=cfg.cutoff, sigma=cfg.sigma, epsilon=cfg.epsilon)
        unit = cfg.box_size * F32_EPS
        raised = [bool(b.overflow) for b in blocks]
        bad = {i for i, r in enumerate(raised) if r}
        values = {"overflow": float(sum(raised) + sum(self.setup_overflow))}
        for index, start, b in kept:
            r, _, ke, pe = lj_nve.run(start.position, start.velocity, p, cfg.dt, cfg.sample_every)
            d = lj_nve._min_image(b.sample.double() - r, p.box).abs().flatten()
            got = {
                "pos_gap": float(d.max()) / unit,
                "pos_rms": float(d.pow(2).mean().sqrt()) / unit,
                "pos_median": float(d.kthvalue((d.numel() + 1) // 2).values) / unit,
                "ke_gap": _relative_gap(float(b.ke), float(ke)),
                "pe_gap": _relative_gap(float(b.pe), float(pe)),
            }
            for name, v in got.items():
                values[name] = max(values.get(name, 0.0), v)
                if name in limits and not v <= limits[name]:
                    bad.add(index)
        e = torch.cat([b.energy for b in blocks]).double()
        values["energy_drift"] = float(((e - e[0]).abs() / e[0].abs()).max())
        return values, len(bad)
