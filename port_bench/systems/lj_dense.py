"""The port's all-pairs Lennard-Jones paths as users run them, block by block.

Set-up builds the start state on the device from the seed, equilibrates it
(``lj_fluid.equilibrate``) and runs one warm-up block. A block is one call
of ``lj_fluid.production`` over ``block_steps`` steps on the configuration's
dense force path (``dense_pallas``: kernel B8, a force call a step and its
energy variant at each sample), sampling positions, kinetic and potential
energy every ``sample_every`` steps.

The answers are checked against ``reference/lj_allpairs.py``, built from
the configuration as it is stated (overrides, such as a control's cutoff,
change the program and never the reference): from the state a block
started at, the reference runs to the block's first sample, and the
positions, kinetic and potential energy there are compared, as
``systems/lj_grid.py`` compares them.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.observables.thermo import temperature
from port_bench.counts import lattice
from port_bench.reference import lj_allpairs
from port_bench.systems.lj_grid import F32_EPS, Block, _relative_gap


def _worst(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is NaN: ``max`` keeps its
    first argument when the other is NaN, and a state gone NaN would then
    read as sound."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


class System:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, overrides: Dict = None):
        t = [time.perf_counter()]
        stated = MDConfig(**{**config["md"], **traffic.get("md", {})})
        cfg = override(stated, **(overrides or {}))
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if config["start"] != "square_lattice":
            raise ValueError(f"unknown start {config['start']!r}")
        pos, vel = lattice.square_lattice(cfg.n, cfg.box_size, cfg.kt, gen)
        self.n = cfg.n
        self.steps_per_block = traffic["block_steps"]
        self.cfg = override(cfg, eq_steps=traffic["eq_steps"], prod_steps=self.steps_per_block)
        self.ref = lj_allpairs.LJ(box=stated.box_size, sigma=stated.sigma, epsilon=stated.epsilon)
        self.impl = lj_fluid.resolve_impl(self.cfg, self.device)
        t.append(time.perf_counter())
        eq, eq_overflow = lj_fluid.equilibrate(self.cfg, ParticleState.create(pos, vel))
        self.kt_eq = float(temperature(eq))  # a host read: equilibration has ended
        t.append(time.perf_counter())
        self.start, warm = self.block(eq)  # the warm-up block: every shape the window uses
        # host reads: the warm-up block has ended
        self.setup_overflow = [bool(eq_overflow), bool(warm.overflow)]
        t.append(time.perf_counter())
        names = ("start_s", "equilibrate_s", "warm_up_s")
        self.phases = {k: b - a for k, a, b in zip(names, t, t[1:])}

    def block(self, state: ParticleState):
        final, (r_hist, ke_hist, pe_hist), overflow = lj_fluid.production(self.cfg, state)
        return final, Block(ke_hist + pe_hist, r_hist[0], ke_hist[0], pe_hist[0], overflow)

    def geometry(self) -> Dict:
        cfg = self.cfg
        geo = dict(dim=cfg.dim, n=cfg.n, box=cfg.box_size, force_impl=self.impl, cutoff=cfg.cutoff,
                   kt_eq=self.kt_eq, setup_overflow=self.setup_overflow)
        if self.impl == "dense_pallas":
            geo["row_blocks"], geo["slices"], geo["slice_len"] = pairwise_cuda._geometry(cfg.n)
        return geo

    def census(self, state: ParticleState):
        return None  # every pair, every step: the work is N and d alone

    def checks(self, blocks: List[Block], kept: List, limits: Dict[str, float]):
        """``(values, failed)``: each compared number over the window, and
        the window blocks that broke a limit. ``kept``: ``(index, start
        state, Block)`` of the blocks whose first sample the reference
        recomputes from the state the block started at."""
        cfg, p = self.cfg, self.ref
        unit = p.box * F32_EPS
        raised = [bool(b.overflow) for b in blocks]
        bad = {i for i, r in enumerate(raised) if r}
        values = {"overflow": float(sum(raised) + sum(self.setup_overflow))}
        for index, start, b in kept:
            r, _, ke, pe = lj_allpairs.run(start.position, start.velocity, p, cfg.dt, cfg.sample_every)
            d = lj_allpairs._min_image(b.sample.double() - r, p.box).abs().flatten()
            got = {
                "pos_gap": float(d.max()) / unit,
                "pos_rms": float(d.pow(2).mean().sqrt()) / unit,
                "pos_median": float(d.kthvalue((d.numel() + 1) // 2).values) / unit,
                "ke_gap": _relative_gap(float(b.ke), float(ke)),
                "pe_gap": _relative_gap(float(b.pe), float(pe)),
            }
            for name, v in got.items():
                values[name] = _worst(values.get(name, 0.0), v)
                if name in limits and not v <= limits[name]:
                    bad.add(index)
        e = torch.cat([b.energy for b in blocks]).double()
        values["energy_drift"] = float(((e - e[0]).abs() / e[0].abs()).max())
        return values, len(bad)
