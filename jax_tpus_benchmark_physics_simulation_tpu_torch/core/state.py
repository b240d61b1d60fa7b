"""Particle state container (port of the JAX package's ``core/state.py``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ParticleState:
    """Classical particle system state.

    Attributes:
      position: ``(N, D)`` positions.
      velocity: ``(N, D)`` velocities.
      mass: ``(N,)`` masses.
      charge: ``(N,)`` charges (zeros when not electromagnetic).
      force: ``(N, D)`` cached forces at ``position``.
      time: 0-d tensor, simulation time.
      step: the global step index, an exact integer (the float32 ``time``
        rounds after ~1e5 steps); it keys the grid engines' Langevin noise.
    """

    position: torch.Tensor
    velocity: torch.Tensor
    mass: torch.Tensor
    charge: torch.Tensor
    force: torch.Tensor
    time: torch.Tensor
    step: int = 0

    @property
    def n(self) -> int:
        return self.position.shape[0]

    @property
    def dim(self) -> int:
        return self.position.shape[1]

    def replace(self, **changes) -> "ParticleState":
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(
        cls,
        position: torch.Tensor,
        velocity: torch.Tensor,
        mass: Optional[torch.Tensor] = None,
        charge: Optional[torch.Tensor] = None,
        time: float = 0.0,
    ) -> "ParticleState":
        n = position.shape[0]
        kw = dict(dtype=position.dtype, device=position.device)
        mass = torch.ones(n, **kw) if mass is None else torch.as_tensor(mass, **kw)
        charge = torch.zeros(n, **kw) if charge is None else torch.as_tensor(charge, **kw)
        return cls(
            position=position,
            velocity=velocity.to(**kw),
            mass=mass,
            charge=charge,
            force=torch.zeros_like(position),
            time=torch.tensor(time, **kw),
        )
