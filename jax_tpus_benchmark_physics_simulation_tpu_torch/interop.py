"""Carries state exported from the JAX package into the port.

The JAX package's arrays cross as numpy arrays (``np.asarray`` on the JAX
side), so this module never imports jax. With these, one state can be run
through both packages and compared.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD, GridMDState

_GRID_FIELDS = (
    "xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "dispx", "dispy",
    "crx", "cry", "cvx", "cvy",
)


def grid_state_from_jax(arrays: Mapping[str, np.ndarray], md: GridMD) -> GridMDState:
    """A :class:`GridMDState` from the leaves of a JAX ``GridMDState``
    (unpacked layout, ``rows_per_block=1``) given as numpy arrays by field
    name. The TPU's padding lanes (``>= cps``) are dropped and ``pid`` is
    cast to int32; the PRNG key of a Langevin state is ignored."""
    cps = md.cps
    expected = (md.cps, md.cap)

    def grid(name, dtype):
        a = np.asarray(arrays[name])
        if a.shape[:2] != expected or a.shape[2] < cps:
            raise ValueError(
                f"{name}: shape {a.shape} is not a (cps={cps}, cap={md.cap}, >=cps) grid"
            )
        return torch.from_numpy(np.ascontiguousarray(a[:, :, :cps], dtype=dtype)).to(md.device)

    def scalar(name, dtype):
        return torch.tensor(np.asarray(arrays[name]).item(), dtype=dtype, device=md.device)

    out = {
        name: grid(name, np.float32)
        for name in _GRID_FIELDS
        if arrays.get(name) is not None
    }
    return GridMDState(
        pid=grid("pid", np.int32),
        dmax2=scalar("dmax2", torch.float32),
        overflow=scalar("overflow", torch.bool),
        time=scalar("time", torch.float32),
        **out,
    )


def particle_state_from_numpy(position: np.ndarray, velocity: np.ndarray, device="cpu") -> ParticleState:
    """A float32 :class:`ParticleState` on ``device`` (unit masses, zero
    charges) from (N, D) numpy positions and velocities."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return ParticleState.create(t(position), t(velocity))
