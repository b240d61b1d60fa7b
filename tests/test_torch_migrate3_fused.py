"""The invariants B6's one-launch design rests on (``csrc/migrate3.cu``),
on the CPU: the slots the codes name are exactly the slots the allocation
fills (``a < tot`` of each target cell, ``_migration_dest``'s
``occ_new``), so the kernel's fill (where ``occ_new`` is 0) and its
scatter write disjoint slots that cover the grid; and a plain emulation of
the launch -- fill, scatter, per-cell mover counts, in its order, every
write counted -- gives ``migrate3_reference``'s bits and
``mover_overflow``'s flag, whole-grid and as the halo form over 1, 2 and
3 x-row blocks of the 4 (4, 2 + 2, 2 + 1 + 1).

The states are ``test_torch_migrate3.py``'s recipe built in the port alone
(a lattice at N=1000 in a box of 12, 4 cells per side, capacity 32, every
particle moved up to 0.35 (mild) or 1.2 (hot: some cell has more than
k_mov = 8 movers) on each axis; the draws land on the port's unpadded grid,
so the moves differ from that file's), plus a capacity-overflow state made
here: the mild state with 40 particles of the 27 cells around cell (1, 1,
1) moved into it, more than its 32 slots, so the allocation drops the
last arrivals (``overflow``) and fills all 32. The wrapper's checks of its
arguments close the file."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import lattice_positions, velocities

N, BOX, K_MOV = 1000, 12.0, 8  # rho 0.58: cps 4, cap 32
STATES = ("mild", "hot", "capacity")
BLOCKS = {1: (4,), 2: (2, 2), 3: (2, 1, 1)}


def _moved(md, s, step: float, seed: int):
    """``s`` with every particle displaced by up to ``step`` on each axis,
    as windows would move it (at most one cell), unwrapped."""
    rng = np.random.default_rng(seed)
    occ = s.occ.numpy()
    moves = {k: getattr(s, k) + torch.from_numpy(rng.uniform(-step, step, occ.shape).astype(np.float32) * occ)
             for k in ("xg", "yg", "zg")}
    return s.replace(**moves)


def _crowded(md, s, n: int = 40):
    """``s`` with ``n`` particles of the cells around cell (1, 1, 1) moved
    to points spread inside it (at most one cell each)."""
    cell = md.box / md.cps
    occ = s.occ > 0.5
    xs = [g.clone() for g in (s.xg, s.yg, s.zg)]
    cand = torch.nonzero(occ).tolist()
    rng = np.random.default_rng(3)
    picked = 0
    for cx, a, lane in cand:
        cy, cz = divmod(lane, md.cps)
        if picked == n or max(abs(cx - 1), abs(cy - 1), abs(cz - 1)) > 1 or (cx, cy, cz) == (1, 1, 1):
            continue
        for g in xs:
            g[cx, a, lane] = float(cell * (1.1 + 0.8 * rng.random()))
        picked += 1
    assert picked == n
    return s.replace(xg=xs[0], yg=xs[1], zg=xs[2])


@pytest.fixture(scope="module")
def states():
    pos = np.mod(lattice_positions(N, BOX, seed=6, dim=3), BOX)
    vel = velocities(N, kt=1.0, seed=7, dim=3)
    md = GridMD3(make_cell_grid_fn(BOX, 2.5, N, dim=3), compensated=True, static_cov="auto",
                 migrate_k_mov=K_MOV, device="cpu")
    s0 = md.init(torch.from_numpy(pos), torch.from_numpy(vel))
    mild = _moved(md, s0, 0.35, seed=4)
    out = {"mild": mild, "hot": _moved(md, s0, 1.2, seed=3), "capacity": _crowded(md, mild)}
    return md, out


def _inputs(md, s):
    """The allocation and the rebuild's 16 field planes and fills."""
    xw, yw, zw, scode, occ_new, overflow, _ = md._migration_dest(s)
    planes = [xw, yw, zw, s.vxg, s.vyg, s.vzg, s.fxg, s.fyg, s.fzg, s.pid.float(),
              s.crx, s.cry, s.crz, s.cvx, s.cvy, s.cvz]
    fills = [md.sentinel] + [0.0] * 8 + [-1.0] + [0.0] * 6
    return scode, occ_new, overflow, planes, fills


def _movers(scode, cap):
    return ((scode >= 0) & (torch.div(scode, cap, rounding_mode="floor") != migrate_cuda3.STAY)).sum(1)


def test_states_cover_the_cases(states):
    md, out = states
    flags = {}
    for name, s in out.items():
        scode, _, overflow, _, _ = _inputs(md, s)
        flags[name] = (int(_movers(scode, md.cap).max()) > K_MOV, bool(overflow))
    assert flags == {"mild": (False, False), "hot": (True, False), "capacity": (flags["capacity"][0], True)}


@pytest.mark.parametrize("which", STATES)
def test_codes_name_exactly_the_allocated_slots(states, which):
    """Every valid code names a distinct slot, and the named slots are the
    allocation's ``occ_new`` (slots ``0 .. tot - 1`` of each target cell):
    the fill's slots and the scatter's are disjoint and cover the grid."""
    md, out = states
    scode, occ_new, _, _, _ = _inputs(md, out[which])
    src, tgt = migrate_cuda3._targets3(scode, md.cps, halo=False)
    assert tgt.numel() == torch.unique(tgt).numel()
    named = torch.zeros(scode.numel())
    named[tgt] = 1.0
    assert torch.equal(named.view(scode.shape), occ_new)
    tot = occ_new.sum(1, keepdim=True)
    assert torch.equal(occ_new > 0.5, torch.arange(md.cap).view(1, -1, 1) < tot)
    if which == "capacity":
        assert int(tot.max()) == md.cap and int(src.numel()) < int((out[which].occ > 0.5).sum())


def _emulate(groups, occ, fills, k_mov, cap, c, halo):
    """The kernel's launch in plain Python: for each source row and slot,
    the scatter of its fields to the target its code names (a halo target
    outside the local rows dropped), the fill of the same output slot where
    ``occ`` is 0, and the per-cell mover count of the local rows; each
    output element's writes counted. ``groups`` are the source rows as
    ``(code, planes)``: the previous row, the local rows and the next row
    (``halo``), or the local rows alone."""
    code = torch.cat([g[0] for g in groups]).numpy()
    fields = np.stack([torch.cat(f).numpy() for f in zip(*(g[1] for g in groups))])
    rows = occ.shape[0]
    occ = occ.numpy()
    out = np.full((len(fills), rows, cap, c * c), np.nan, np.float32)
    writes = np.zeros((rows, cap, c * c), np.int64)
    over = False
    for r in range(code.shape[0]):
        local = not halo or 1 <= r <= rows
        lr = r - 1 if halo else r
        for lane in range(c * c):
            cy, cz = divmod(lane, c)
            movers = 0
            for a in range(cap):
                v = int(code[r, a, lane])
                d = v // cap if v >= 0 else -1
                if local and d >= 0 and d != migrate_cuda3.STAY:
                    movers += 1
                if 0 <= d < 27:
                    tx = r + d // 9 - 1
                    tx = tx - 1 if halo else tx % rows
                    if 0 <= tx < rows:
                        t = (tx, v - d * cap, ((cy + (d // 3) % 3 - 1) % c) * c + (cz + d % 3 - 1) % c)
                        out[(slice(None),) + t] = fields[:, r, a, lane]
                        writes[t] += 1
                if local and not occ[lr, a, lane] > 0.5:
                    out[:, lr, a, lane] = fills
                    writes[lr, a, lane] += 1
            over |= local and movers > k_mov
    return torch.from_numpy(out), writes, over


@pytest.mark.parametrize("which", STATES)
def test_one_launch_emulation_gives_the_plain_version(states, which):
    """Whole grid, at k_mov 8 and 1: every output element written once, the
    output ``migrate3_reference``'s bits, the flag ``mover_overflow``'s."""
    md, out = states
    scode, occ_new, _, planes, fills = _inputs(md, out[which])
    want = migrate_cuda3.migrate3_reference(scode, torch.stack(planes), fills)
    for k_mov in (K_MOV, 1):
        got, writes, flag = _emulate([(scode, planes)], occ_new, fills, k_mov, md.cap, md.cps, halo=False)
        assert (writes == 1).all()
        assert torch.equal(got, want)
        assert flag is bool(migrate_cuda3.mover_overflow(scode, k_mov))


def _row_blocks(t: torch.Tensor, sizes, dim: int = 0):
    """``(prev, local, next)`` rows of each block of ``sizes`` rows of a
    whole grid along ``dim``, periodic."""
    n, r0, out = t.shape[dim], 0, []
    for k in sizes:
        out.append((t.narrow(dim, (r0 - 1) % n, 1), t.narrow(dim, r0, k), t.narrow(dim, (r0 + k) % n, 1)))
        r0 += k
    return out


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("which", STATES)
def test_one_launch_emulation_over_halo_blocks(states, which, n_blocks):
    """The halo form over x-row blocks: each block's output written once,
    joined ``migrate3_reference``'s bits, the blocks' flags ORed
    ``mover_overflow``'s; each block also ``migrate3_halo_reference``'s and
    the wrapper's on the CPU."""
    md, out = states
    scode, occ_new, _, planes, fills = _inputs(md, out[which])
    want = migrate_cuda3.migrate3_reference(scode, torch.stack(planes), fills)
    sizes = BLOCKS[n_blocks]
    code_b = _row_blocks(scode, sizes)
    plane_b = [_row_blocks(f, sizes) for f in planes]
    occ_b = _row_blocks(occ_new, sizes)
    parts, flags = [], []
    for k in range(n_blocks):
        groups = [(code_b[k][j], [pb[k][j] for pb in plane_b]) for j in range(3)]
        got, writes, flag = _emulate(groups, occ_b[k][1], fills, K_MOV, md.cap, md.cps, halo=True)
        assert (writes == 1).all()
        ext = torch.cat(code_b[k])
        fields = torch.stack([torch.cat(pb[k]) for pb in plane_b])
        assert torch.equal(got, migrate_cuda3.migrate3_halo_reference(ext, fields, fills))
        halo = migrate_cuda3.migrate3_halo(ext, fields, fills, k_mov=K_MOV, occ=occ_b[k][1])
        assert torch.equal(halo[0], got) and bool(halo[1]) is flag
        parts.append(got)
        flags.append(flag)
    assert torch.equal(torch.cat(parts, 1), want)
    assert any(flags) is bool(migrate_cuda3.mover_overflow(scode, K_MOV))


def test_wrapper_takes_planes_and_checks_new_arguments(states):
    """``migrate3`` takes the planes as a list or as one stacked tensor,
    always with ``occ``, and counts no launch on the
    CPU; a missing or bad ``occ`` or plane raises."""
    md, out = states
    scode, occ_new, _, planes, fills = _inputs(md, out["hot"])
    before = (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES, migrate_cuda3.HALO_LAUNCHES)
    want = migrate_cuda3.migrate3_reference(scode, torch.stack(planes), fills)
    for f in (planes, torch.stack(planes)):
        got, flag = migrate_cuda3.migrate3(scode, f, fills, k_mov=K_MOV, occ=occ_new)
        assert torch.equal(got, want) and bool(flag)
    assert (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES, migrate_cuda3.HALO_LAUNCHES) == before
    with pytest.raises(TypeError, match="occ"):
        migrate_cuda3.migrate3(scode, planes, fills)
    with pytest.raises(ValueError, match="occ"):
        migrate_cuda3.migrate3(scode, planes, fills, occ=occ_new[:, :-1].contiguous())
    with pytest.raises(ValueError, match="occ"):
        migrate_cuda3.migrate3(scode, planes, fills, occ=occ_new.double())
    with pytest.raises(ValueError, match="occ"):
        migrate_cuda3.migrate3_halo(scode, planes, fills, occ=occ_new)
    with pytest.raises(TypeError):
        migrate_cuda3.migrate3(scode, [planes[0].double()] + planes[1:], fills, occ=occ_new)
    with pytest.raises(ValueError, match="no field plane"):
        migrate_cuda3.migrate3(scode, [], [], occ=occ_new)
