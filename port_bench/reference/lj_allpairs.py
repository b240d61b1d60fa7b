"""Plain reference of the all-pairs Lennard-Jones MD: velocity Verlet in
float64 over every pair, in eager PyTorch.

It imports nothing of the program and takes nothing the program made but
the start state it is handed. The physics is the reference script's
(``molecular_dynamics_jax_single-host_workload.py``): unit masses, the
minimum image ``dr - box * round(dr / box)`` over every pair, the pair
energy ``4 eps ((s/r)^12 - (s/r)^6)`` with no cutoff and no shift, the
total energy the half-sum over the full pair matrix, velocity Verlet
(half kick, drift, positions wrapped with ``remainder``, new force, half
kick).

Departures from the script, none of which changes its equations:

- the force is the energy's gradient written out, ``24 eps (2 (s/r)^12 -
  (s/r)^6) / r^2 dr``, in place of ``grad(-E)`` (the tests hold it to the
  autograd gradient);
- the pair matrix is summed in row chunks of :data:`ROW_CHUNK` rows, so
  that N=16,384 fits on the card;
- float64 throughout, and TF32 is off in case any operation reaches a
  matrix unit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

F64 = torch.float64
ROW_CHUNK = 1024  # rows of the pair matrix a pass holds: 1024 x 16,384 pairs, 128 MiB a float64 plane


@dataclass(frozen=True)
class LJ:
    box: float
    sigma: float = 1.0
    epsilon: float = 1.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def forces(r: torch.Tensor, p: LJ, with_energy: bool = False):
    """Total force on each particle from every other particle (and the
    total potential energy, differentiable in ``r``), by the minimum
    image."""
    n = r.shape[0]
    idx = torch.arange(n, device=r.device)
    f = torch.empty_like(r)
    pe = torch.zeros((), dtype=r.dtype, device=r.device)
    s2 = p.sigma**2
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        d = _min_image(r[lo:hi, None, :] - r[None, :, :], p.box)  # (rows, n, dim)
        r2 = (d * d).sum(-1)
        other = idx[lo:hi, None] != idx[None, :]
        r2 = torch.where(other, r2, torch.ones_like(r2))  # the diagonal, as the script masks it
        s6 = (s2 / r2) ** 3
        fmag = torch.where(other, 24.0 * p.epsilon * (2.0 * s6 * s6 - s6) / r2, torch.zeros_like(r2))
        f[lo:hi] = (fmag[..., None] * d).sum(1)
        if with_energy:
            pe = pe + torch.where(other, 4.0 * p.epsilon * (s6 * s6 - s6), torch.zeros_like(r2)).sum()
    return (f, 0.5 * pe) if with_energy else f


def run(r0: torch.Tensor, v0: torch.Tensor, p: LJ, dt: float, steps: int):
    """``steps`` velocity-Verlet steps in float64 from ``(r0, v0)``.
    Returns ``(r, v, ke, pe)``: positions wrapped into [0, box), velocities,
    kinetic and potential energy at the last step."""
    _no_tf32()
    r = r0.to(F64)
    v = v0.to(F64)
    f = forces(r, p)
    for _ in range(steps):
        v = v + 0.5 * dt * f
        r = torch.remainder(r + dt * v, p.box)
        f = forces(r, p)
        v = v + 0.5 * dt * f
    _, pe = forces(r, p, with_energy=True)
    ke = 0.5 * (v * v).sum()
    return r, v, ke, pe
