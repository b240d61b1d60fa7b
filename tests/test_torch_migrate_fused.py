"""The invariants B2's one-launch design rests on (``csrc/migrate.cu``), on
the CPU: the slots the valid codes name are exactly the slots the
allocation fills (``_migration_dest``'s ``occ_new``: slots ``0 .. tot - 1``
of each target cell), each named once, so the kernel's fill (where
``occ_new`` is 0) and its scatter write disjoint slots that cover the grid;
and a plain emulation of the launch (``torch_migrate_designs.emulate``:
scatter and fill in its order, every write counted) gives
``migrate_reference``'s bits, on the unpacked layout (R = 1), on a packed
one whose movers cross the block seams (R = 4, two blocks of 4 cell rows),
as the halo form over 1, 2 and 3 row blocks, and on the sharded engine's
own allocation over 2 and 3 gloo ranks (``torch_sharded.halo_allocation``).
The plain versions, which the kernel is held to on the card and which fill
every unnamed slot without ``occ``, are checked against the JAX package's
``make_migrate_kernel`` in interpret mode on the same states, as
``test_torch_migrate.py`` does.

The states: a jittered lattice at N=512 (rho 0.8: 8 cells per side,
capacity 24) with every particle moved by up to 0.35 (mild) or 1.2 (hot)
on each axis, and an overflow state
(``torch_migrate_designs.overflow_state``: moves of up to 0.45 of a cell,
then 32 particles of the cells around cell (1, 1) crowded into it, past its
24 slots, so the allocation raises ``overflow`` and drops the last
arrivals). The last test checks that the unsharded rebuild stacks no field
planes: the kernel reads them where they lie."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.migrate_pallas import (
    make_migrate_kernel as jax_make_migrate_kernel,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import unpack
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
from tests import torch_sharded as ts
from tests.torch_migrate_designs import emulate, overflow_state, rebuild_inputs
from tests.torch_parity import lattice_positions, velocities

N, RHO = 512, 0.8  # cps 8, cap 24
STATES = ("mild", "hot", "overflow")
LAYOUTS = (1, 4)  # rows_per_block: unpacked, and two blocks of 4 cell rows
BLOCKS = {1: (8,), 2: (4, 4), 3: (4, 2, 2)}


def _moved(s, step: float, seed: int):
    """``s`` with every particle displaced by up to ``step`` on each axis,
    unwrapped."""
    rng = np.random.default_rng(seed)
    occ = s.occ.numpy()
    return s.replace(**{k: getattr(s, k) + torch.from_numpy(rng.uniform(-step, step, occ.shape).astype(np.float32)
                                                           * occ) for k in ("xg", "yg")})


@pytest.fixture(scope="module")
def states():
    """``{R: (md, {name: state})}`` on the layouts of ``LAYOUTS``, from one
    start: the packed states are the unpacked ones packed."""
    box = float(np.sqrt(N / RHO))
    pos = torch.from_numpy(np.mod(lattice_positions(N, box, seed=6), box))
    vel = torch.from_numpy(velocities(N, kt=1.0, seed=7))
    out = {}
    for r in LAYOUTS:
        md = GridMD(make_cell_grid_fn(box, 2.5, N, dim=2), compensated=True, rows_per_block=r, device="cpu")
        s0 = md.init(pos, vel)
        out[r] = (md, {"mild": _moved(s0, 0.35, seed=4), "hot": _moved(s0, 1.2, seed=3),
                       "overflow": overflow_state(md, s0)})
    return out


def test_states_cover_the_cases(states):
    """Only the overflow state overflows; on the packed layout, the hot
    state has movers across both kinds of block seam."""
    for r, (md, st) in states.items():
        assert {k: bool(rebuild_inputs(md, s)[4]) for k, s in st.items()} == {
            "mild": False, "hot": False, "overflow": True}
    md, st = states[4]
    scode = rebuild_inputs(md, st["hot"])[0]
    sub = torch.div(torch.arange(md.lanes), md.cps, rounding_mode="floor")
    dx = torch.div(scode, 3 * md.cap, rounding_mode="floor") - 1
    assert int(((scode >= 0) & (dx == -1) & (sub == 0)).sum()) > 0
    assert int(((scode >= 0) & (dx == 1) & (sub == 3)).sum()) > 0


@pytest.mark.parametrize("which", STATES)
@pytest.mark.parametrize("r", LAYOUTS)
def test_codes_name_exactly_the_allocated_slots(states, r, which):
    """The valid codes name distinct slots (as many named slots as valid
    codes), and the named slots are the allocation's ``occ_new``, slots
    ``0 .. tot - 1`` of each target cell."""
    md, st = states[r]
    scode, occ, _, _, _ = rebuild_inputs(md, st[which])
    named = migrate_cuda.migrate_reference(scode, torch.ones((1,) + tuple(scode.shape)), [0.0], r)[0]
    assert int(named.sum()) == int(((scode >= 0) & (scode < 9 * md.cap)).sum())
    assert torch.equal(named, occ)
    occ_u = unpack(occ, r)
    tot = occ_u.sum(1, keepdim=True)
    assert torch.equal(occ_u > 0.5, torch.arange(md.cap).view(1, -1, 1) < tot)
    if which == "overflow":
        assert int(tot.max()) == md.cap and int(named.sum()) < N


@pytest.mark.parametrize("which", STATES)
@pytest.mark.parametrize("r", LAYOUTS)
def test_one_launch_emulation_gives_the_plain_version(states, r, which):
    """Every output element written once, the output ``migrate_reference``'s
    bits, and the wrapper's on the CPU (the planes passed as a list)."""
    md, st = states[r]
    scode, occ, planes, fills, _ = rebuild_inputs(md, st[which])
    want = migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, r)
    got, writes = emulate(scode, planes, occ, fills, r)
    assert (writes == 1).all()
    assert torch.equal(got, want)
    before = (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES)
    assert torch.equal(migrate_cuda.migrate(scode, planes, fills, r, occ=occ), want)
    assert (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES) == before


def _row_blocks(t: torch.Tensor, sizes, dim: int = 0):
    """Each block of ``sizes`` rows of a whole grid along ``dim`` with its
    periodic neighbour rows attached, ``(rows + 2)`` long."""
    n, r0, out = t.shape[dim], 0, []
    for k in sizes:
        out.append(torch.cat([t.narrow(dim, (r0 - 1) % n, 1), t.narrow(dim, r0, k), t.narrow(dim, (r0 + k) % n, 1)],
                             dim))
        r0 += k
    return out


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("which", STATES)
def test_one_launch_emulation_over_halo_blocks(states, which, n_blocks):
    """The halo form over row blocks of the unpacked grid: each block's
    output written once and ``migrate_halo_reference``'s and the wrapper's
    bits; joined, ``migrate_reference``'s."""
    md, st = states[1]
    scode, occ, planes, fills, _ = rebuild_inputs(md, st[which])
    sizes = BLOCKS[n_blocks]
    code_b, occ_b = _row_blocks(scode, sizes), occ.split(sizes)
    plane_b = list(zip(*(_row_blocks(f, sizes) for f in planes)))
    parts = []
    for c, pl, o in zip(code_b, plane_b, occ_b):
        got, writes = emulate(c, pl, o, fills, halo=True)
        assert (writes == 1).all()
        assert torch.equal(got, migrate_cuda.migrate_halo_reference(c, torch.stack(pl), fills))
        assert torch.equal(migrate_cuda.migrate_halo(c, pl, fills, occ=o), got)
        parts.append(got)
    assert torch.equal(torch.cat(parts, 1), migrate_cuda.migrate_reference(scode, torch.stack(planes), fills))


@pytest.mark.parametrize("which", STATES)
@pytest.mark.parametrize("r", LAYOUTS)
def test_plain_version_matches_jax_kernel(states, r, which):
    """``migrate_reference`` bit-equal to the JAX package's B2 in interpret
    mode on the same codes and planes (lanes padded to 128 with empty
    slots, as the JAX layout has them)."""
    md, st = states[r]
    scode, _, planes, fills, _ = rebuild_inputs(md, st[which])
    pad = ((0, 0), (0, 0), (0, 128 - md.lanes))
    out_j = jax_make_migrate_kernel(md.cps, md.cap, r, len(planes), fills, interpret=True)(
        jnp.asarray(np.pad(scode.numpy(), pad, constant_values=-1)),
        *(jnp.asarray(np.pad(f.numpy(), pad)) for f in planes))
    got = migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, r)
    for f in range(len(planes)):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(out_j[f])[:, :, : md.lanes])


@pytest.fixture(scope="module")
def sharded():
    """``torch_sharded.halo_allocation`` on every rank of 2 and of 3 gloo
    processes (12 cells per side: 6 and 4 rows a rank)."""
    return {p: run_ranks(ts.halo_allocation, p) for p in (2, 3)}


@pytest.mark.parametrize("p", [2, 3])
def test_sharded_allocation_names_exactly_the_local_slots(sharded, p):
    """On each rank of the sharded engine: the local occupancy is exactly
    the slots the extended rows' valid codes name, each named once; one
    emulated B2 halo launch writes every local element once and gives the
    plain version's bits; the overflow state overflows on the rank that
    holds the crowded cell; the gathered codes and occupancy are the
    unsharded engine's."""
    ranks = sharded[p]
    assert len(ranks) == p and all(r["cps"] == 12 for r in ranks)
    for r in ranks:
        assert r["named_is_occ"] and r["landing"] == r["named"]
        assert r["written_once"] and r["emulation_is_plain"] and r["gathered_is_unsharded"]
    assert any(r["overflow"] for r in ranks)


def test_unsharded_rebuild_passes_the_planes_where_they_lie(states, monkeypatch):
    """``GridMD._rebuild_migrate`` hands B2 its 11 field planes as a list of
    the state's own tensors (the wrapper's argument on the card), and
    stacks nothing of the grid's shape itself (the allocation's gather
    index, built afresh here, stacks its cell coordinates, of other
    shapes)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import alloc_cuda, grid_md

    md, st = states[4]
    s = st["mild"]
    seen, shapes = [], []
    stack = torch.stack

    def spy_migrate(scode, planes, fills, r, *, occ):
        seen.append(planes)
        return torch.zeros((len(planes),) + tuple(scode.shape))

    def spy_stack(tensors, *args, **kwargs):
        shapes.append({tuple(t.shape) for t in tensors})
        return stack(tensors, *args, **kwargs)

    monkeypatch.setattr(grid_md, "migrate", spy_migrate)
    monkeypatch.setattr(torch, "stack", spy_stack)
    alloc_cuda.roll_cells_index.cache_clear()
    md._rebuild_migrate(s)
    (planes,) = seen
    assert isinstance(planes, list) and len(planes) == 11
    assert all(p is getattr(s, k) for p, k in zip(planes[2:], ("vxg", "vyg", "fxg", "fyg")))
    assert all(p is getattr(s, k) for p, k in zip(planes[7:], ("crx", "cry", "cvx", "cvy")))
    assert shapes and all(tuple(md.grid_shape) not in sh for sh in shapes)
