"""Lennard-Jones 6-12 potential with optional PBC and cutoff, dense O(N^2).

Port of the JAX package's ``ops/forces/lennard_jones.py``. It is the oracle
that the grid engine's forces and energies are held against, and the force
and energy of the ``dense_xla`` path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.pbc import pair_displacements


@dataclass(frozen=True)
class LennardJones:
    sigma: float = 1.0
    epsilon: float = 1.0
    box: Optional[float] = None
    cutoff: Optional[float] = None

    def _pair_terms(self, position: torch.Tensor, rows: Optional[torch.Tensor] = None):
        n = position.shape[0]
        dr = pair_displacements(position, self.box, rows)
        r2 = torch.sum(dr * dr, dim=-1)
        idx = torch.arange(n, device=position.device) if rows is None else rows
        mask = idx[:, None] != torch.arange(n, device=position.device)[None, :]
        if self.cutoff is not None:
            mask = mask & (r2 < self.cutoff**2)
        r2_safe = torch.where(mask, r2, torch.ones_like(r2))
        s2 = (self.sigma**2) / r2_safe
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        return dr, r2_safe, mask, s6, s12

    def _shift(self) -> float:
        """Energy shift so U(r_c) = 0 when a cutoff is used."""
        if self.cutoff is None:
            return 0.0
        sc2 = (self.sigma / self.cutoff) ** 2
        sc6 = sc2**3
        return 4.0 * self.epsilon * (sc6 * sc6 - sc6)

    def energy(self, position: torch.Tensor) -> torch.Tensor:
        """Total potential energy (scalar), dense O(N^2)."""
        _, _, mask, s6, s12 = self._pair_terms(position)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        return 0.5 * torch.sum(torch.where(mask, pair, torch.zeros_like(pair)))

    def force(self, position: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Analytic forces ``-dE/dR``, dense O(N^2): ``(N, D)``, or the
        ``(len(rows), D)`` forces on the particles ``rows`` from all N (an
        O(len(rows) * N) oracle for systems too large for the full matrix)."""
        dr, r2_safe, mask, s6, s12 = self._pair_terms(position, rows)
        fmag_over_r = 24.0 * self.epsilon * (2.0 * s12 - s6) / r2_safe
        fmag_over_r = torch.where(mask, fmag_over_r, torch.zeros_like(fmag_over_r))
        return torch.sum(fmag_over_r[..., None] * dr, dim=1)

    def energy_per_particle(self, position: torch.Tensor) -> torch.Tensor:
        """Per-particle energy ``e_i`` (sum e_i / 2 = total)."""
        _, _, mask, s6, s12 = self._pair_terms(position)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        return torch.sum(torch.where(mask, pair, torch.zeros_like(pair)), dim=1)

    def force_and_energy(self, position: torch.Tensor):
        """``(forces, total energy)`` from one pair-term pass."""
        dr, r2_safe, mask, s6, s12 = self._pair_terms(position)
        zero = torch.zeros_like(r2_safe)
        fmag_over_r = torch.where(mask, 24.0 * self.epsilon * (2.0 * s12 - s6) / r2_safe, zero)
        f = torch.sum(fmag_over_r[..., None] * dr, dim=1)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        return f, 0.5 * torch.sum(torch.where(mask, pair, zero))
