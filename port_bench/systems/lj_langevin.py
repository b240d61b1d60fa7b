"""The port's grid Lennard-Jones engines under BAOAB Langevin (NVT), block by
block, as ``systems/lj_grid.py`` drives them under NVE: the same set-up,
blocks (one ``lj_fluid.production`` call each, now on the Langevin
windows), ``geometry`` and ``census``. The program's noise stream is armed
from ``cfg.seed``, which is the run's seed unless an override says
otherwise; its stream seed is ``seed + noise.stream_seed_offset`` of the
configuration.

The answers are checked against ``reference/lj_baoab.py``, built from the
configuration as it is stated (overrides, such as a control's noise seed
or thermostat, change the program and never the reference): from the
state a block started at and its global step, the reference replays the
noise and runs to the block's first sample, and the positions, kinetic
and potential energy there are compared as ``lj_grid.py`` compares them.
Besides, ``kt_gap`` holds each window block's kinetic temperature, the mean
over its samples of ``2 KE / (d N)``, to the bath's kT. A NaN reading stays
NaN in the window's worst.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from port_bench.reference import lj_baoab, lj_nve
from port_bench.systems import lj_grid
from port_bench.systems.lj_dense import _worst
from port_bench.systems.lj_grid import F32_EPS, _relative_gap


@dataclass
class Block(lj_grid.Block):
    ke_hist: torch.Tensor  # kinetic energy at every sample


class System(lj_grid.System):
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, overrides: Dict = None):
        if "step" not in {f.name for f in dataclasses.fields(ParticleState)}:
            # the noise of a block is keyed by its global step: without it the
            # reference cannot replay the program's noise
            raise SystemExit("lj_langevin: the program's ParticleState carries no global step, "
                             "so its Langevin noise cannot be replayed")
        super().__init__(config, traffic, seed, device, {"seed": seed, **(overrides or {})})
        stated = MDConfig(**{**config["md"], **traffic.get("md", {})})
        self.stated = stated
        self.stream_seed = seed + config["noise"]["stream_seed_offset"]
        self.ref = lj_nve.LJ(box=stated.box_size, cutoff=stated.cutoff, sigma=stated.sigma, epsilon=stated.epsilon)

    def block(self, state: ParticleState):
        final, (r_hist, ke_hist, pe_hist), overflow = lj_fluid.production(self.cfg, state, self.cadence, self.md)
        return final, Block(ke_hist + pe_hist, r_hist[0], ke_hist[0], pe_hist[0], overflow, ke_hist)

    def checks(self, blocks: List[Block], kept: List, limits: Dict[str, float]):
        """``(values, failed)``: each compared number over the window, and
        the window blocks that broke a limit. ``kept``: ``(index, start
        state, Block)`` of the blocks whose first sample the reference
        recomputes from the state the block started at."""
        cfg, p = self.stated, self.ref
        unit = p.box * F32_EPS
        raised = [bool(b.overflow) for b in blocks]
        bad = {i for i, r in enumerate(raised) if r}
        values = {"overflow": float(sum(raised) + sum(self.setup_overflow))}
        for index, start, b in kept:
            r, _, ke, pe = lj_baoab.run(start.position, start.velocity, p, cfg.dt, cfg.sample_every, cfg.gamma,
                                        cfg.kt, self.stream_seed, start.step)
            d = lj_nve._min_image(b.sample.double() - r, p.box).abs().flatten()
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
        kt = torch.stack([b.ke_hist.double().mean() for b in blocks]) * (2.0 / (cfg.dim * cfg.n))
        gaps = ((kt - cfg.kt).abs() / cfg.kt).tolist()
        values["kt_gap"] = 0.0
        for index, gap in enumerate(gaps):
            values["kt_gap"] = _worst(values["kt_gap"], gap)
            if "kt_gap" in limits and not gap <= limits["kt_gap"]:
                bad.add(index)
        return values, len(bad)
