"""Rank-side checks of the port's row mesh (``parallel/mesh.py``), run by
``tests/test_torch_mesh.py`` on gloo ranks. Imports neither jax nor the
JAX package."""

from __future__ import annotations

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh, replicated, shard_along
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import init_multihost, is_primary, world_size


def mesh_collectives() -> dict:
    """Each collective of the mesh on this rank: the exchanged rows (rank r
    sends first row ``10 r + 1`` and last row ``10 r + 2``, two of each
    shape so that a row crossed with the other would show), the
    reductions, the gather, this rank's block and a broadcast."""
    mesh = make_mesh()
    r = mesh.rank
    first = torch.full((2, 3), 10.0 * r + 1)
    last = torch.full((2, 3), 10.0 * r + 2)
    prev, nxt = mesh.exchange(first, last)
    full = torch.arange(4.0 * mesh.size).view(2 * mesh.size, 2)
    return dict(
        rank=r, size=mesh.size, device=str(mesh.device), primary=is_primary(), world=world_size(),
        again=init_multihost(),  # already initialised: a no-op that reports > 1 process
        prev=prev.tolist(), next=nxt.tolist(),
        max=int(mesh.all_max(torch.tensor(r))), sum=float(mesh.all_sum(torch.tensor(r + 1.0))),
        any=bool(mesh.all_max(torch.tensor(r == mesh.size - 1))),
        gathered=mesh.all_gather_rows(torch.full((1, 2), float(r))).tolist(),
        block=shard_along(mesh, full).tolist(),
        bcast=replicated(mesh, torch.tensor([float(r), 7.0])).tolist(),
    )


def fail_on_rank_one() -> int:
    """Raises on rank 1 while rank 0 waits in a collective."""
    mesh = make_mesh()
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    mesh.all_sum(torch.ones(1))
    return mesh.rank
