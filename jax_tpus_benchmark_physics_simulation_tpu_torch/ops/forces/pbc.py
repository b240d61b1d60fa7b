"""Periodic boundary condition helpers (minimum-image convention).

Reference: ``periodic_displacement`` at molecular_dynamics...:46-48 and the
position wrap ``jnp.mod(R, box)`` at :72. ``torch.remainder`` takes the
sign of the divisor like ``jnp.mod`` (``torch.fmod`` would not).
"""

from __future__ import annotations

import torch


def minimum_image(dr: torch.Tensor, box: float) -> torch.Tensor:
    """Minimum-image displacement: ``dr - box * round(dr / box)``."""
    return dr - box * torch.round(dr / box)


def wrap(position: torch.Tensor, box: float) -> torch.Tensor:
    """Wrap positions into ``[0, box)``."""
    return torch.remainder(position, box)


def pair_displacements(position: torch.Tensor, box=None, rows=None) -> torch.Tensor:
    """Displacement tensor ``dr[i, j] = R_i - R_j``, shape (N, N, D), or
    (len(rows), N, D) for the particles ``rows`` only. With ``box`` set,
    applies minimum image."""
    targets = position if rows is None else position[rows]
    dr = targets[:, None, :] - position[None, :, :]
    if box is not None:
        dr = minimum_image(dr, box)
    return dr
