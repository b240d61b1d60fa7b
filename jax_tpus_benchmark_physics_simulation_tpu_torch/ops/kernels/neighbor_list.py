"""Cell-list + Verlet neighbor list with fixed capacities, in plain PyTorch.

Port of the JAX package's ``ops/kernels/neighbor_list.py``, same algorithm
and same integers:

1. bin particles into cells of side >= cutoff + skin;
2. stable argsort by cell id; rank within the cell = position - segment
   start (``searchsorted`` over the sorted ids);
3. scatter the sorted particle indices into a (n_cells, cell_capacity)
   table (sentinel N; overflow is flagged, never dropped silently);
4. per particle, gather the occupants of the 3^dim neighbouring cells as
   candidates (offsets deduplicated modulo the grid, so small boxes hold no
   pair twice);
5. compact the candidates to an (N, K) list by a stable argsort of the
   validity mask.

Every sort is stable (``torch.argsort`` is not by default), so ``build``
gives the same ``idx`` as the JAX package on a state without overflow. The
list is valid until some particle moves more than skin/2 from its
build-time position. Index tensors are int64, PyTorch's index type.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.pbc import minimum_image


@dataclass(frozen=True)
class NeighborList:
    idx: torch.Tensor  # (N, K) int64 neighbor indices, sentinel = N
    ref_position: torch.Tensor  # (N, D) positions at build time
    overflow: torch.Tensor  # 0-d bool: any capacity exceeded at any build so far

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]


@dataclass(frozen=True)
class NeighborFn:
    """Build parameters and the build/update functions."""

    box: float
    cutoff: float
    skin: float
    n: int
    dim: int
    cells_per_side: int
    cell_capacity: int
    k_max: int

    def _cell_coords(self, position: torch.Tensor) -> torch.Tensor:
        cps = self.cells_per_side
        return torch.clamp((position // (self.box / cps)).to(torch.int64), 0, cps - 1)

    def _flat(self, coords: torch.Tensor) -> torch.Tensor:
        flat = coords[..., 0]
        for d in range(1, self.dim):
            flat = flat * self.cells_per_side + coords[..., d]
        return flat

    def _neighbor_cell_offsets(self, device) -> torch.Tensor:
        """Deduplicated wrap-around-safe offsets of the 3^dim neighbourhood."""
        base = torch.tensor(sorted({o % self.cells_per_side for o in (-1, 0, 1)}), device=device)
        grids = torch.meshgrid(*([base] * self.dim), indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=1)  # (n_off, dim)

    def build(self, position: torch.Tensor, prev_overflow: Optional[torch.Tensor] = None) -> NeighborList:
        n, dim, cps = self.n, self.dim, self.cells_per_side
        cap, dev = self.cell_capacity, position.device

        coords = self._cell_coords(position)  # (N, dim)
        ids = self._flat(coords)
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg_start = torch.searchsorted(sorted_ids, sorted_ids)
        rank = torch.arange(n, device=dev) - seg_start
        cell_overflow = torch.any(rank >= cap)
        rank = torch.clamp(rank, max=cap - 1)

        slots = torch.full((cps**dim, cap), n, dtype=torch.int64, device=dev)
        slots[sorted_ids, rank] = order

        # candidate gather: the occupants of the neighbour cells
        offsets = self._neighbor_cell_offsets(dev)
        nbr_flat = self._flat((coords[:, None, :] + offsets[None, :, :]) % cps)  # (N, n_off)
        cand = slots[nbr_flat].reshape(n, -1)  # (N, n_off * cap)

        # validity: a real particle, not itself, within cutoff + skin
        pos_pad = torch.cat([position, position.new_zeros((1, dim))])
        dr = minimum_image(position[:, None, :] - pos_pad[cand], self.box)
        r2 = torch.sum(dr * dr, dim=-1)
        rc2 = (self.cutoff + self.skin) ** 2
        i_ids = torch.arange(n, device=dev)[:, None]
        valid = (cand != n) & (cand != i_ids) & (r2 < rc2)

        # compact to K: a stable sort brings the valid candidates to the front
        perm = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, : self.k_max]
        idx = torch.where(torch.gather(valid, 1, perm), torch.gather(cand, 1, perm), n)

        overflow = cell_overflow | torch.any(torch.sum(valid, dim=1) > self.k_max)
        if prev_overflow is not None:
            overflow = overflow | prev_overflow
        return NeighborList(idx=idx, ref_position=position, overflow=overflow)

    def needs_rebuild(self, position: torch.Tensor, nbrs: NeighborList) -> torch.Tensor:
        """0-d bool tensor: some particle moved more than skin/2."""
        dr = minimum_image(position - nbrs.ref_position, self.box)
        return torch.max(torch.sum(dr * dr, dim=-1)) > (0.5 * self.skin) ** 2

    def maybe_rebuild(self, position: torch.Tensor, nbrs: NeighborList) -> NeighborList:
        """The list rebuilt at ``position`` if it needs it, else ``nbrs``.
        JAX's ``lax.cond`` becomes one host read of :meth:`needs_rebuild`
        a call (a step), the same kind of read as the grid engine's
        per-window ``dmax2``."""
        if bool(self.needs_rebuild(position, nbrs)):
            return self.build(position, prev_overflow=nbrs.overflow)
        return nbrs


def make_neighbor_fn(
    box: float,
    cutoff: float,
    n: int,
    dim: int = 2,
    skin: float = 0.4,
    rho: Optional[float] = None,
    cell_capacity: Optional[int] = None,
    k_max: Optional[int] = None,
    safety: float = 1.75,
) -> NeighborFn:
    """Sizes the capacities from the density (overridable), as the JAX
    package does. Overflow is flagged on the NeighborList, so undersized
    capacities fail loudly."""
    cells_per_side = max(1, int(box / (cutoff + skin)))
    cell_size = box / cells_per_side
    if rho is None:
        rho = n / (box**dim)
    if cell_capacity is None:
        cell_capacity = max(4, int(math.ceil(rho * cell_size**dim * safety + 4)))
    if k_max is None:
        if dim == 2:
            ball = math.pi * (cutoff + skin) ** 2
        else:
            ball = 4.0 / 3.0 * math.pi * (cutoff + skin) ** 3
        k_max = max(8, int(math.ceil(rho * ball * safety + 8)))
    # K rounded up to a multiple of 8, as in the JAX package (same lists)
    k_max = ((k_max + 7) // 8) * 8
    return NeighborFn(
        box=float(box), cutoff=float(cutoff), skin=float(skin), n=n, dim=dim,
        cells_per_side=cells_per_side, cell_capacity=cell_capacity, k_max=k_max,
    )


def make_lj_force_neighbor(neighbor_fn: NeighborFn, sigma: float = 1.0, epsilon: float = 1.0):
    """Returns ``force_fn(R, nbrs) -> F`` and ``force_fn.energy(R, nbrs)``:
    O(N*K) gather-based LJ with the energy shift at the cutoff, the physics
    of ``LennardJones(box=..., cutoff=...)``."""
    n, dim, box, cutoff = neighbor_fn.n, neighbor_fn.dim, neighbor_fn.box, neighbor_fn.cutoff
    sc6 = (sigma / cutoff) ** 6
    shift = 4.0 * epsilon * (sc6 * sc6 - sc6)

    def _pair_terms(position: torch.Tensor, nbrs: NeighborList):
        pos_pad = torch.cat([position, position.new_zeros((1, dim))])
        dr = minimum_image(position[:, None, :] - pos_pad[nbrs.idx], box)  # (N, K, D)
        r2 = torch.sum(dr * dr, dim=-1)
        mask = (nbrs.idx < n) & (r2 < cutoff**2)
        r2_safe = torch.where(mask, r2, torch.ones_like(r2))
        inv_r2 = r2_safe.new_full((), sigma * sigma) / r2_safe
        s6 = inv_r2 * inv_r2 * inv_r2
        return dr, r2_safe, mask, s6

    def force_fn(position: torch.Tensor, nbrs: NeighborList) -> torch.Tensor:
        dr, r2_safe, mask, s6 = _pair_terms(position, nbrs)
        s12 = s6 * s6
        fmag = torch.where(mask, 24.0 * epsilon * (2.0 * s12 - s6) / r2_safe, torch.zeros_like(s6))
        return torch.sum(fmag[..., None] * dr, dim=1)

    def energy_fn(position: torch.Tensor, nbrs: NeighborList) -> torch.Tensor:
        _, _, mask, s6 = _pair_terms(position, nbrs)
        pair = torch.where(mask, 4.0 * epsilon * (s6 * s6 - s6) - shift, torch.zeros_like(s6))
        return 0.5 * torch.sum(pair)

    force_fn.energy = energy_fn
    return force_fn
