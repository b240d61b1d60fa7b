"""Plain reference of the Lennard-Jones NVE engines: velocity Verlet in
float64 over a Verlet pair list, in eager PyTorch.

It imports nothing of the program and takes nothing the program made but
the start state it is handed. The physics is the program's by definition
of the model: unit masses, the pair force of ``4 eps ((s/r)^12 - (s/r)^6)``
truncated at the cutoff (``r^2 < rc^2``), the potential energy shifted by
its value at the cutoff, periodic boundaries by the minimum image.

The pair list holds every pair closer than ``rc + skin`` and is built anew
whenever a particle has moved more than ``skin / 2`` since the last build,
so no pair inside the cutoff is ever missed. Candidates come from a cell
binning of side at least ``rc + skin``; their distances are taken in
float32 with a margin, which can only add pairs, and each step's forces
test the cutoff in float64.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple

import torch

F64 = torch.float64
SKIN = 0.6
# float32 distance margin of the candidate test: a superset, never fewer
MARGIN = 1e-3
PAIR_CHUNK = 1 << 25  # pairs a force pass handles at once
ROW_CHUNK = 1 << 19  # particles a candidate pass handles at once


@dataclass(frozen=True)
class LJ:
    box: float
    cutoff: float
    sigma: float = 1.0
    epsilon: float = 1.0

    @property
    def shift(self) -> float:
        sc6 = (self.sigma / self.cutoff) ** 6
        return 4.0 * self.epsilon * (sc6 * sc6 - sc6)


def _min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def pair_list(r: torch.Tensor, box: float, rlist: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(i, j)`` with ``i < j`` of every pair closer than ``rlist`` (and
    some slightly farther), by the minimum image."""
    n, dim = r.shape
    dev = r.device
    cps = int(box // rlist)
    if cps < 3:
        raise ValueError(f"box {box} holds fewer than 3 list cells of {rlist}")
    cell = box / cps
    rw = torch.remainder(r, box)
    c = torch.div(rw, cell, rounding_mode="floor").long().clamp_(0, cps - 1)
    strides = torch.tensor([cps ** (dim - 1 - k) for k in range(dim)], device=dev)
    cid = (c * strides).sum(1)
    order = torch.argsort(cid)
    sorted_cid = cid[order]
    counts = torch.bincount(cid, minlength=cps**dim)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - start[sorted_cid]
    width = int(counts.max())
    table = torch.full((cps**dim, width), -1, dtype=torch.long, device=dev)
    table[sorted_cid, rank] = order
    r32 = rw.float()
    lim2 = (rlist + MARGIN) ** 2
    out_i, out_j = [], []
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        ii = torch.arange(lo, hi, device=dev)
        for off in itertools.product((-1, 0, 1), repeat=dim):
            nc = ((c[lo:hi] + torch.tensor(off, device=dev)) % cps * strides).sum(1)
            cand = table[nc]  # (rows, width), -1 where empty
            keep = cand > ii[:, None]
            d = r32[cand.clamp(min=0)] - r32[lo:hi, None, :]
            d = d - box * torch.round(d / box)
            keep &= (d * d).sum(-1) < lim2
            rows, cols = keep.nonzero(as_tuple=True)
            out_i.append(ii[rows])
            out_j.append(cand[rows, cols])
    return torch.cat(out_i), torch.cat(out_j)


def forces(r: torch.Tensor, i: torch.Tensor, j: torch.Tensor, p: LJ, with_energy: bool = False):
    """Total force on each particle (and the shifted potential energy)."""
    f = torch.zeros_like(r)
    pe = torch.zeros((), dtype=r.dtype, device=r.device)
    rc2 = p.cutoff**2
    s2 = p.sigma**2
    for lo in range(0, i.numel(), PAIR_CHUNK):
        a, b = i[lo : lo + PAIR_CHUNK], j[lo : lo + PAIR_CHUNK]
        d = _min_image(r[a] - r[b], p.box)
        r2 = (d * d).sum(1)
        inside = r2 < rc2
        r2 = torch.where(inside, r2, torch.ones_like(r2))
        s6 = (s2 / r2) ** 3
        fmag = torch.where(inside, 24.0 * p.epsilon * (2.0 * s6 * s6 - s6) / r2, torch.zeros_like(r2))
        fij = fmag[:, None] * d
        f.index_add_(0, a, fij)
        f.index_add_(0, b, -fij)
        if with_energy:
            pe = pe + torch.where(inside, 4.0 * p.epsilon * (s6 * s6 - s6) - p.shift, torch.zeros_like(r2)).sum()
    return (f, pe) if with_energy else f


def run(r0: torch.Tensor, v0: torch.Tensor, p: LJ, dt: float, steps: int):
    """``steps`` velocity-Verlet steps in float64 from ``(r0, v0)``.
    Returns ``(r, v, ke, pe)``: positions wrapped into [0, box), velocities,
    kinetic and potential energy at the last step."""
    r = r0.to(F64)
    v = v0.to(F64)
    rlist = p.cutoff + SKIN
    i, j = pair_list(r, p.box, rlist)
    r_built = r.clone()
    f = forces(r, i, j, p)
    for _ in range(steps):
        v = v + 0.5 * dt * f
        r = r + dt * v
        moved = _min_image(r - r_built, p.box)
        if float((moved * moved).sum(1).max()) > (0.5 * SKIN) ** 2:
            i, j = pair_list(r, p.box, rlist)
            r_built = r.clone()
        f = forces(r, i, j, p)
        v = v + 0.5 * dt * f
    _, pe = forces(r, i, j, p, with_energy=True)
    ke = 0.5 * (v * v).sum()
    return torch.remainder(r, p.box), v, ke, pe
