"""Start states, made on the device from a ``torch.Generator``.

- :func:`square_lattice`: the grid-MD benchmark's start (the JAX package's
  ``bench.py`` ``lattice``): a ``ceil(sqrt(N))``-per-side square lattice,
  filled row by row, each site jittered by 0.05 sigma of Gaussian noise and
  wrapped into the box; velocities ``sqrt(kT)`` times a standard normal.
  The noise is clipped at ``clip`` of its sigmas (3: 0.15 sigma), so that
  no seed draws a pair closer than ``spacing - 0.3`` (0.818 sigma at
  rho 0.8): unclipped, the closest of N=1M sites' pairs lies anywhere from
  0.72 to 0.80 sigma with the seed, an overlap of 30 to 190 epsilon whose
  kick can outrun the engine's windows, sized for the thermal tail.
- :func:`fcc_lattice`: LAMMPS's ``lattice fcc rho`` filled over
  ``cells^3`` unit cells (four sites a cell at (0,0,0), (1/2,1/2,0),
  (1/2,0,1/2), (0,1/2,1/2)), with ``velocity all create kT``'s defaults:
  uniform components, zero total momentum, scaled so that the temperature
  over ``3N - 3`` degrees of freedom is ``kT`` exactly.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def square_lattice(n: int, box: float, kt: float, gen: torch.Generator,
                   clip: float = 3.0) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = gen.device
    per = int(math.ceil(math.sqrt(n)))
    sp = box / per
    g = torch.arange(per, dtype=torch.float32, device=dev) * sp + 0.5 * sp
    mesh = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)[:n]
    jitter = torch.randn(mesh.shape, generator=gen, device=dev).clamp_(-clip, clip)
    pos = torch.remainder(mesh + 0.05 * jitter, box)
    vel = math.sqrt(kt) * torch.randn((n, 2), generator=gen, device=dev)
    return pos, vel


def fcc_cells(n: int) -> int:
    """Unit cells per side of an fcc lattice of ``n`` sites."""
    cells = round((n / 4) ** (1.0 / 3.0))
    if 4 * cells**3 != n:
        raise ValueError(f"{n} is not 4 c^3 sites of an fcc lattice")
    return cells


def fcc_lattice(n: int, rho: float, kt: float, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """``(positions, velocities, box)``."""
    dev = gen.device
    cells = fcc_cells(n)
    a = (4.0 / rho) ** (1.0 / 3.0)
    basis = torch.tensor([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], dtype=torch.float64, device=dev)
    c = torch.arange(cells, dtype=torch.float64, device=dev)
    corners = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 1, 3)
    pos = ((corners + basis) * a).reshape(-1, 3)
    v = torch.rand((n, 3), generator=gen, dtype=torch.float64, device=dev) - 0.5
    v = v - v.mean(0)
    v = v * math.sqrt(kt * (3 * n - 3) / float((v * v).sum()))
    return pos.float(), v.float(), cells * a
