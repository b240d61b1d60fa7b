"""Cell-grid geometry: cells per side, slot capacity and skin.

Port of ``CellGridFn`` and ``make_cell_grid_fn`` from the JAX package's
``ops/kernels/cell_dense.py``; the numbers are the same so both packages
lay particles out on the same grid. The roll-based cell force of that
module is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class CellGridFn:
    box: float
    cutoff: float
    skin: float
    n: int
    dim: int
    cells_per_side: int
    capacity: int

    @property
    def n_cells(self) -> int:
        return self.cells_per_side**self.dim


def make_cell_grid_fn(
    box: float,
    cutoff: float,
    n: int,
    dim: int = 2,
    skin: float = 0.4,
    rho: Optional[float] = None,
    capacity: Optional[int] = None,
    safety: Optional[float] = None,
) -> CellGridFn:
    cells_per_side = max(1, int(box / (cutoff + skin)))
    if cells_per_side < 3:
        raise ValueError(
            f"cell-dense path needs >= 3 cells per side (box={box}, "
            f"cutoff+skin={cutoff + skin}); use the dense or neighbor path"
        )
    cell_size = box / cells_per_side
    if rho is None:
        rho = n / (box**dim)
    if capacity is None:
        mean = rho * cell_size**dim
        if safety is not None:
            capacity = max(4, int(math.ceil(mean * safety + 2)))
        else:
            # mean + 3*sqrt(mean) + 1. The JAX package measured max
            # occupancy 12 against this cap of 16 at 2D N=100k.
            capacity = max(4, int(math.ceil(mean + 3.0 * math.sqrt(mean) + 1)))
        if dim == 3 and capacity > 16:
            capacity = ((capacity + 15) // 16) * 16
    # multiple of 8: the TPU needed it; kept so both packages share one
    # geometry and the parity tests compare like with like
    capacity = ((capacity + 7) // 8) * 8
    return CellGridFn(
        box=float(box),
        cutoff=float(cutoff),
        skin=float(skin),
        n=n,
        dim=dim,
        cells_per_side=cells_per_side,
        capacity=capacity,
    )
