"""Electromagnetic (Lorentz) acceleration in 2D with non-uniform B_z(x).

Port of the JAX package's ``ops/forces/em.py``, op for op. Reference
physics (three_particles...:39-51):
  B_z(x) = Bz + Bk * x  (gradient along x),
  a_mag = (q/m) (v x B) = (q/m) (v_y B_z, -v_x B_z)   [2D],
  a_elec = (q/m) (E_x, E_y).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Lorentz2D:
    bz: float = 1.0
    bk: float = 0.0
    ex: float = 0.0
    ey: float = 0.0

    def b_field(self, position: torch.Tensor) -> torch.Tensor:
        """Out-of-plane B_z at each particle, shape (N,)."""
        return self.bz + self.bk * position[:, 0]

    def e_field(self, position: torch.Tensor) -> torch.Tensor:
        """In-plane E at each particle, shape (N, 2)."""
        e = torch.tensor([self.ex, self.ey], dtype=position.dtype, device=position.device)
        return e.expand(position.shape)

    def acceleration(
        self,
        position: torch.Tensor,
        velocity: torch.Tensor,
        mass: torch.Tensor,
        charge: torch.Tensor,
    ) -> torch.Tensor:
        qm = charge / mass
        bz = self.b_field(position)
        acc_mag = torch.stack([qm * velocity[:, 1] * bz, -qm * velocity[:, 0] * bz], dim=1)
        acc_elec = qm[:, None] * self.e_field(position)
        return acc_mag + acc_elec
