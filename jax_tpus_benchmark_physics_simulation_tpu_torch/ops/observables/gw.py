"""Gravitational-wave quadrupole strain.

Port of the JAX package's ``ops/observables/gw.py`` (the reference's
``multi_gw_strain``, nbody...:147-171). The ``vmap`` over pairs becomes a
leading pair dimension; ``torch.triu_indices`` gives ``jnp.triu_indices``'s
pair order. Everything stays in the input's dtype: the strain (~1e-23 at
the default 410 Mpc) sits well inside float32's range, so nothing is
rescaled.

Physics (per pair i<j, G=c=1 units with D in meters):
  chirp mass  M_c = mu^(3/5) (m_i + m_j)^(2/5)
  Keplerian   omega = sqrt(G (m_i + m_j) / r^3)
  phase       phi(t) = int omega dt      (cumulative, matching :163-165)
  amplitude   A = 4 (G M_c)^(5/3) / (c^4 D) * omega^(2/3)
  strain      h_+ = mean over pairs of A cos(2 phi)
"""

from __future__ import annotations

import torch

MPC_TO_M = 3.086e22  # nbody...:150


def gw_strain(
    t: torch.Tensor,  # (T,)
    positions_t: torch.Tensor,  # (T, n, 2)
    masses: torch.Tensor,  # (n,)
    d_gw_mpc: float,
    g: float = 1.0,
    c: float = 1.0,
) -> torch.Tensor:
    """Plus-polarization strain h_+(t), shape (T,)."""
    n = positions_t.shape[1]
    d_meters = d_gw_mpc * MPC_TO_M
    ii, jj = torch.triu_indices(n, n, 1, device=positions_t.device)
    n_pairs = ii.shape[0]

    dt = torch.diff(t, prepend=t[:1])
    sep = (positions_t[:, ii] - positions_t[:, jj]).transpose(0, 1)  # (n_pairs, T, 2)
    r = torch.sqrt(torch.sum(sep * sep, dim=-1))
    r = torch.clamp(r, min=1e-6)  # floor, nbody...:156
    m_sum = masses[ii] + masses[jj]
    mu = masses[ii] * masses[jj] / m_sum
    chirp = mu ** (3.0 / 5.0) * m_sum ** (2.0 / 5.0)
    omega = torch.sqrt(g * m_sum[:, None] / r**3)
    # phi[0] = 0; phi[k] = sum_{1..k} omega[k] dt[k]  (matches :163-165)
    phi = torch.cumsum(omega * dt, dim=1) - omega[:, :1] * dt[0]
    amp = (4.0 * (g * chirp) ** (5.0 / 3.0) / (c**4 * d_meters))[:, None] * omega ** (2.0 / 3.0)
    h = amp * torch.cos(2.0 * phi)  # (n_pairs, T)
    return torch.sum(h, dim=0) / max(n_pairs, 1)
