"""Newtonian pairwise gravity, dense O(N^2).

Port of the JAX package's ``ops/forces/gravity.py``, op for op, with its
three regularizations:

- ``min_distance``: the acceleration term is zeroed when r < min_distance
  (the n-body workload's ODE);
- ``r2_floor``: r^2 += eye, then floored at ``r2_floor``;
- ``plummer``: r^2 -> r^2 + eps^2 (kernel B9's formula, in another form).

``r2 ** (-1.5)`` is ``torch.pow(r2, -1.5)``; the energy divides tensor by
tensor, so it is one IEEE division as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Gravity:
    g: float = 1.0
    mode: str = "plummer"  # min_distance | r2_floor | plummer
    min_distance: float = 1e-6
    r2_floor: float = 1e-12
    softening: float = 0.0

    def acceleration(self, position: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        """a_i = sum_{j != i} G m_j (R_j - R_i) / r^3 (regularized)."""
        n = position.shape[0]
        dr = position[None, :, :] - position[:, None, :]  # dr[i, j] = R_j - R_i
        r2 = torch.sum(dr * dr, dim=-1)

        if self.mode == "min_distance":
            r2_safe = torch.where(r2 < self.min_distance**2, 1.0, r2)
            inv_r3 = torch.pow(r2_safe, -1.5)
            inv_r3 = torch.where(r2 >= self.min_distance**2, inv_r3, 0.0)
        elif self.mode == "r2_floor":
            eye = torch.eye(n, dtype=position.dtype, device=position.device)
            r2 = r2 + eye
            r2 = torch.where(r2 < self.r2_floor, self.r2_floor, r2)
            inv_r3 = torch.pow(r2, -1.5)
            inv_r3 = inv_r3 * (1.0 - eye)
        elif self.mode == "plummer":
            eye = torch.eye(n, dtype=position.dtype, device=position.device)
            r2 = r2 + self.softening**2 + eye  # eye keeps the diagonal finite
            inv_r3 = torch.pow(r2, -1.5) * (1.0 - eye)
        else:
            raise ValueError(f"unknown gravity mode: {self.mode}")

        acc_pairs = self.g * mass[None, :, None] * dr * inv_r3[..., None]
        return torch.sum(acc_pairs, dim=1)

    def force(self, position: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        return self.acceleration(position, mass) * mass[:, None]

    def energy(self, position: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        """Total potential energy -G sum_{i<j} m_i m_j / r (plummer-softened)."""
        n = position.shape[0]
        dr = position[None, :, :] - position[:, None, :]
        r2 = torch.sum(dr * dr, dim=-1)
        eye = torch.eye(n, dtype=position.dtype, device=position.device)
        r = torch.sqrt(r2 + self.softening**2 + eye)
        pot = -self.g * mass[:, None] * mass[None, :] / r * (1.0 - eye)
        return 0.5 * torch.sum(pot)
