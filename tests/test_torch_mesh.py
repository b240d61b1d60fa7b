"""The port's row mesh and process-group set-up (``parallel/mesh.py``,
``parallel/multihost.py``, ``parallel/spawn.py``): the exchange at P = 1
(a local swap, no process group), P = 2 (one peer on both sides, where the
two messages each way must not cross) and P = 4, the reductions, gather,
block and broadcast on gloo ranks, and the initialisation rules."""

import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import make_mesh
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import RowMesh, pad_to_multiple, shard_along
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.multihost import init_multihost, is_primary, world_size
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
from tests import torch_mesh_ranks


def test_one_rank_mesh_without_group():
    """No process group: one rank, a local swap (the halos are the rows
    given), and reductions that return their input."""
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    first, last = torch.ones(1, 3), torch.full((1, 3), 2.0)
    prev, nxt = mesh.exchange(first, last)
    assert prev is last and nxt is first
    t = torch.tensor(3.0)
    assert mesh.all_max(t) is t and mesh.all_sum(t) is t and mesh.all_gather_rows(t) is t
    assert torch.equal(shard_along(mesh, torch.arange(6)), torch.arange(6))
    assert is_primary() and world_size() == 1
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(2)
    assert pad_to_multiple(10, 4) == 12


@pytest.mark.parametrize("p", [2, 4])
def test_collectives_on_gloo_ranks(p):
    out = run_ranks(torch_mesh_ranks.mesh_collectives, p)
    for r, o in enumerate(out):
        assert (o["rank"], o["size"], o["world"], o["device"]) == (r, p, p, "cpu")
        assert o["primary"] is (r == 0) and o["again"] is True
        assert o["prev"] == [[10.0 * ((r - 1) % p) + 2] * 3] * 2  # the previous rank's last row
        assert o["next"] == [[10.0 * ((r + 1) % p) + 1] * 3] * 2  # the next rank's first row
        assert o["max"] == p - 1 and o["sum"] == p * (p + 1) / 2 and o["any"] is True
        assert o["gathered"] == [[float(k)] * 2 for k in range(p)]
        assert o["block"] == [[4.0 * r, 4.0 * r + 1], [4.0 * r + 2, 4.0 * r + 3]]
        assert o["bcast"] == [0.0, 7.0]


def test_failed_rank_raises_and_stops_the_others():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_ranks(torch_mesh_ranks.fail_on_rank_one, 2, timeout=120)


def test_init_multihost_plain_host_and_bad_configuration(monkeypatch):
    """No launcher environment: no cluster, False, nothing initialised. A
    rank outside the world, or a world of 0, raises before any
    rendezvous."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_multihost() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="outside a world"):
        init_multihost(init_method="file:///nonexistent/store", world_size=2, rank=2, backend="gloo")
    with pytest.raises(ValueError, match="positive"):
        init_multihost(world_size=0, rank=0, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_mesh_of_ranks_must_be_consistent():
    """A RowMesh of 3 ranks cannot split 16 rows evenly."""
    mesh = RowMesh(rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        shard_along(mesh, torch.zeros(16, 2))
