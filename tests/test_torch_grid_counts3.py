"""The 3D engine's cell counts, as the counted B5 kernel derives them, and
the invariant that kernel rests on: after ``init`` and after every rebuild
a cell's particles fill its slots ``0 .. count-1`` and no other, so a
cell's count is its number of non-sentinel slots. Also on the halo rows a
rank of ``ShardedGridMD3`` attaches (where the x seam moves the sentinel
by -+ box), and, on the CPU, why the counted loop is bit-equal to B5's
full loop: the count-bounded loop written out op for op in float32 gives
the full loops' bits, B5's at ``cov`` and B4's at ``max_occ`` and at the
capacity, also where the fullest cell exceeds ``cov`` (the state in which
the hybrid windows run B4, the counted kernel at the capacity's shared
memory), whole-grid and over halo row blocks. And the wrapper's dispatch
and checks.

The counts have no counterpart in the JAX package (its kernels loop over
every slot); the 3D engine against JAX's is in ``test_torch_grid_md3.py``
and ``test_torch_cell_force3.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3, migrate_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks, make_mesh
from tests.torch_parity import lattice_positions, velocities

N, RHO, DT = 8192, 0.8, 1e-3  # box 21.71: cps 7, cap 48, cov ("auto") 40
SHIFT = 0.45  # lattice spacing 1.034: about a hundred particles start outside [0, box)


SQUEEZED = 17  # particles moved into one cell: its 27 become 44, above cov 40, within cap 48


def _squeeze(pos: np.ndarray, box: float, cps: int) -> np.ndarray:
    """``pos`` with the last ``SQUEEZED`` particles (in far cells) moved into
    cell (3, 3, 3): onto the first points of a 12^3 grid in that cell at
    least 0.75 from every particle near it and from each other, so its
    occupancy (27) exceeds the hybrid bound and no pair is closer than
    0.75 sigma."""
    cell = box / cps
    lo = np.full(3, 3 * cell)
    g = np.linspace(0.1, cell - 0.1, 12)
    cand = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) + lo
    near = pos[np.all(np.abs(np.mod(pos, box) - (lo + cell / 2)) < cell, axis=1)]
    chosen = []
    for c in cand:
        if len(chosen) == SQUEEZED:
            break
        pts = np.concatenate([near] + chosen)
        if np.min(np.linalg.norm(pts - c, axis=1)) >= 0.75:
            chosen.append(c[None])
    out = pos.copy()
    out[-SQUEEZED:] = np.concatenate(chosen).astype(np.float32)
    return out


def _engine(shift=0.0, static_cov="auto", sharded=False, squeeze=False):
    """The engine and its initial state: a jittered cubic lattice, moved by
    ``shift`` on every axis (about half a spacing puts a plane of particles
    across each seam, unwrapped, as between rebuilds); with ``squeeze``,
    :func:`_squeeze`d so that the fullest cell exceeds ``cov``."""
    box = float((N / RHO) ** (1.0 / 3.0))
    gf = make_cell_grid_fn(box, 2.5, N, dim=3)
    if sharded:
        md = ShardedGridMD3(gf, make_mesh(device="cpu"), dt=DT, compensated=True, static_cov=static_cov)
    else:
        md = GridMD3(gf, dt=DT, compensated=True, static_cov=static_cov, device="cpu")
    pos = lattice_positions(N, box, seed=41, dim=3) - np.float32(shift)
    if squeeze:
        pos = _squeeze(pos, box, gf.cells_per_side)
    vel = torch.from_numpy(velocities(N, kt=1.0, seed=42, dim=3))
    return md, md.init(torch.from_numpy(pos), vel)


def _start(start: str, sharded: bool = False):
    """``within_cov``: 16 steps from the shifted lattice, every cell within
    ``cov`` (B5's windows); ``above_cov``: the squeezed shifted lattice, its
    fullest cell above ``cov`` and within the capacity (B4's windows)."""
    if start == "within_cov":
        md, s = _engine(SHIFT, sharded=sharded)
        s = md._window_for(s, 16)(s)
        assert int(s.max_occ) < md.static_cov
    else:
        md, s = _engine(SHIFT, sharded=sharded, squeeze=True)
        assert md.static_cov < int(s.max_occ) <= md.cap
    assert not bool(s.overflow)
    return md, s


def _counts(xg, p: cell_cuda3.CellForce3Params, bound=None):
    """``(rows, c, c)`` int counts as the counted kernel derives them: the
    slots below ``bound`` (default: all) whose x is none of the sentinel,
    the sentinel - box and the sentinel + box (fl32, as a halo row across
    the x seam carries it)."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else bound
    s = torch.tensor(p.sentinel, dtype=torch.float32)
    box = torch.tensor(p.box, dtype=torch.float32)
    x4 = xg.view(-1, cap, c, c)[:, :bound]
    empty = (x4 == s) | (x4 == s - box) | (x4 == s + box)
    return (~empty).sum(1)


def _check_compact(md, s, where):
    """The sentinel-derived counts against the occupancy the engine holds,
    and the occupancy grid against ``slot < count``, exact; every particle
    counted once."""
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    counts = _counts(s.xg, p)
    c = md.cps
    occ = s.occ.view(c, md.cap, c, c) > 0.5
    assert torch.equal(counts, occ.sum(1)), where
    slot = torch.arange(md.cap).view(1, md.cap, 1, 1)
    assert torch.equal(occ, slot < counts.unsqueeze(1)), where
    assert int(counts.sum()) == N and int(counts.max()) == int(s.max_occ), where


@pytest.mark.parametrize("shift", [-SHIFT, SHIFT])
def test_slots_compact_at_init_and_every_rebuild(shift):
    """Eight window -> rebuild cycles with lattice planes next to the cell
    faces, so that particles cross cells, from a start inside the box and
    from one shifted across the seams: after ``init``, after each sort-free
    rebuild and after the sort-based one every cell's particles fill its
    slots from 0, and the sentinel-derived count is the cell's occupancy."""
    md, s = _engine(shift)
    assert bool(((s.xg < 0) | (s.yg < 0) | (s.zg < 0))[s.occ > 0.5].any()) == (shift > 0)
    _check_compact(md, s, "init")
    moved = 0
    for k in range(8):
        s = md._window_for(s, 8)(s)
        _, _, _, scode, _, _, _ = md._migration_dest(s)
        moved += int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != migrate_cuda3.STAY)).sum())
        s = md._rebuild_migrate(s)
        _check_compact(md, s, f"rebuild {k}")
    assert moved > 50 and not bool(s.overflow)
    _check_compact(md, md._rebuild(md._window_for(s, 8)(s)), "sort-based rebuild")


def test_halo_rows_of_one_rank_carry_the_counts():
    """The halo rows ``ShardedGridMD3`` attaches at world size 1 (its last
    x-row minus box before its rows, its first plus box after them): the
    sentinel-derived counts of the extended grid are the occupancies of the
    rows they copy, after ``init`` and after a rebuild."""
    md, s = _engine(SHIFT, sharded=True)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    for where in ("init", "rebuild"):
        xh, yh, zh = md._with_halo(s.xg, s.yg, s.zg)
        assert tuple(xh.shape) == (md.cps + 2, md.cap, md.cps**2)
        occ = s.occ.view(md.cps, md.cap, -1) > 0.5
        want = occ.sum(1)
        got = _counts(xh, p).view(md.cps + 2, -1)
        assert torch.equal(got, torch.cat([want[-1:], want, want[:1]])), where
        # the seam moved every x of the halo rows, sentinels included
        assert bool((xh[0][~occ[-1]] == torch.tensor(p.sentinel, dtype=torch.float32) - p.box).all())
        s = md._rebuild_migrate(md._window_for(s, 8)(s))


def _loop_sums(x4, y4, z4, partners, p, bound, with_energy, counts=None):
    """Every slot's sums as the CUDA kernels compute them, op for op in
    float32 on ``(rows, cap, c, c)`` views: the 27 offsets in the full
    loop's order (dx, dy, dz), partner slots ascending into per-offset
    partial sums added in offset order. Without ``counts``, B5's full loop
    (``cell_force3_kernel``): every partner slot ``b < bound``, every
    non-sentinel target below ``bound``. With them, the counted kernel's
    loop: partner slots ``b < min(count, bound)``, targets below their
    cell's count. ``partners(dx)`` gives the partner views of x offset
    ``dx`` (x seam included) and their counts."""
    c = p.cps
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    box, cutoff2, sigma2, fscale = f32(p.box), f32(p.cutoff2), f32(p.sigma2), f32(p.fscale)
    two_fscale, four_eps, wscale, shift = 2.0 * fscale, 4.0 * f32(p.epsilon), fscale * sigma2, f32(p.shift)
    zero = torch.zeros((), dtype=torch.float32)
    idx = torch.arange(c)
    slot = torch.arange(x4.shape[1]).view(1, -1, 1, 1)

    def seam(d):
        return torch.where(idx + d < 0, -box, torch.where(idx + d >= c, box, zero))

    acc = [torch.zeros_like(x4) for _ in range(5 if with_energy else 3)]
    for dx in (-1, 0, 1):
        xr, yr, zr, nr = partners(dx)
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                xp = torch.roll(xr, (-dy, -dz), (2, 3))
                yp = torch.roll(yr, (-dy, -dz), (2, 3)) + seam(dy).view(1, 1, c, 1)
                zp = torch.roll(zr, (-dy, -dz), (2, 3)) + seam(dz).view(1, 1, 1, c)
                n_p = None if counts is None else torch.roll(nr, (-dy, -dz), (1, 2)).unsqueeze(1)
                part = [torch.zeros_like(x4) for _ in acc]
                for b in range(bound):
                    ddx = x4 - xp[:, b : b + 1]
                    ddy = y4 - yp[:, b : b + 1]
                    ddz = z4 - zp[:, b : b + 1]
                    r2 = ddx * ddx + ddy * ddy + ddz * ddz
                    valid = (r2 > 0) & (r2 < cutoff2)
                    inv = sigma2 / r2
                    s6 = inv * inv * inv
                    if with_energy:
                        s12 = s6 * s6
                        fmag = torch.where(valid, (2.0 * s12 - s6) * inv * fscale, zero)
                        terms = (fmag * ddx, fmag * ddy, fmag * ddz,
                                 torch.where(valid, four_eps * (s12 - s6) - shift, zero),
                                 torch.where(valid, (2.0 * s12 - s6) * wscale, zero))
                    else:
                        fmag = torch.where(valid, s6 * inv * (two_fscale * s6 - fscale), zero)
                        terms = (fmag * ddx, fmag * ddy, fmag * ddz)
                    for k, t in enumerate(terms):
                        part[k] = part[k] + t if n_p is None else torch.where(b < n_p, part[k] + t, part[k])
                acc = [a + q for a, q in zip(acc, part)]
    if counts is None:
        target = (slot < bound) & (x4 != f32(p.sentinel))
    else:
        target = slot < counts.clamp(max=bound).unsqueeze(1)
    return [torch.where(target, a, zero).view(x4.shape[0], x4.shape[1], c * c) for a in acc]


def _whole_grid_sums(s, p, bound, with_energy, counted):
    """:func:`_loop_sums` on the whole grid (x seam added to the rolled
    rows), with the sentinel-derived counts if ``counted``."""
    c, cap = p.cps, p.cap
    g4 = [g.view(c, cap, c, c) for g in (s.xg, s.yg, s.zg)]
    n = _counts(s.xg, p)
    idx = torch.arange(c)
    box = torch.tensor(p.box, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)

    def partners(dx):
        seam = torch.where(idx + dx < 0, -box, torch.where(idx + dx >= c, box, zero)).view(c, 1, 1, 1)
        return (torch.roll(g4[0], -dx, 0) + seam, torch.roll(g4[1], -dx, 0), torch.roll(g4[2], -dx, 0),
                torch.roll(n, -dx, 0))

    return _loop_sums(*g4, partners, p, bound, with_energy, n if counted else None)


def _close(got, plain):
    """Within 1e-5 of the largest value: the plain versions sum each pair
    block over b with torch's reduction, whose order is not ascending."""
    for a, b in zip(got, plain):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("start", ["within_cov", "above_cov"])
@pytest.mark.parametrize("with_energy", [False, True])
def test_count_bounded_sums_bit_equal_to_full_loops(with_energy, start):
    """On states with coordinates outside [0, box) (unwrapped), the counted
    kernel's loop gives the full loops bit for bit: a skipped pair adds an
    exact +-0 to a partial sum that is never -0, and b stays ascending.
    Within ``cov``: counted at ``cov`` (B5) against B5's full loop and B4's
    at ``max_occ``. Above it (B4's windows): counted at ``max_occ`` and at
    the capacity (B4 with and without its run-time bound) against B4's
    loop at both. All agree with the plain versions to summation order."""
    md, s = _start(start)
    occ = s.occ > 0.5
    assert int(((s.xg < 0) | (s.yg < 0) | (s.zg < 0))[occ].sum()) > 50
    mo, cov, cap = int(s.max_occ), md.static_cov, md.cap
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    counted_bounds, full_bounds = ((cov,), (cov, mo)) if start == "within_cov" else ((mo, cap), (mo, cap))
    counted = [_whole_grid_sums(s, p, b, with_energy, True) for b in counted_bounds]
    full = [_whole_grid_sums(s, p, b, with_energy, False) for b in full_bounds]
    for got in counted[1:] + full:
        assert all(torch.equal(a, b) for a, b in zip(counted[0], got))
    for bound in full_bounds:
        _close(counted[0], cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, bound, with_energy))


def test_counted_sums_at_a_bound_below_the_occupancy():
    """Pure static mode with ``cov`` below the max occupancy (flagged):
    counts clamped to ``cov`` give B5's full loop, which drops the slots
    at and past ``cov``, bit for bit."""
    md, s = _engine(SHIFT, static_cov=8)
    assert int(s.max_occ) > 8 and bool(s.overflow)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    counted = _whole_grid_sums(s, p, 8, False, True)
    assert all(torch.equal(a, b) for a, b in zip(counted, _whole_grid_sums(s, p, 8, False, False)))
    _close(counted, cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, 8))


def _row_blocks(g4: torch.Tensor, sizes, seam: float):
    """The x-row blocks of ``sizes`` rows of a whole ``(c, cap, c, c)`` grid,
    each with its periodic neighbour rows attached, ``-seam`` on the first
    block's previous row and ``+seam`` on the last block's next row (x:
    ``box``), as a rank's exchange attaches them; the blocks may differ in
    length."""
    c = g4.shape[0]
    out, r0 = [], 0
    for k, n in enumerate(sizes):
        prev, nxt = g4[(r0 - 1) % c][None], g4[(r0 + n) % c][None]
        if k == 0:
            prev = prev - seam
        if k == len(sizes) - 1:
            nxt = nxt + seam
        out.append(torch.cat([prev, g4[r0 : r0 + n], nxt]))
        r0 += n
    return out


@pytest.mark.parametrize("start", ["within_cov", "above_cov"])
def test_counted_halo_sums_bit_equal_to_full_halo_loop(start):
    """The counted loop on one rank's extended grid (the halo x-rows
    ``ShardedGridMD3`` attaches, with their seam, counts from the shifted
    sentinels) gives the halo form's full loop and the whole-grid counted
    sums bit for bit, and the plain halo version to summation order; at
    ``cov`` within it, and (B4's windows) at ``max_occ`` above it, where
    the same holds over 1, 2 and 3 x-row blocks of 7, 4 + 3 and 3 + 2 + 2
    rows and at the capacity."""
    md, s = _start(start, sharded=True)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    c, cap = p.cps, p.cap
    bound = md.static_cov if start == "within_cov" else int(s.max_occ)

    def block_sums(h4, bound):
        nh = _counts(h4[0].reshape(-1, cap, c * c), p)
        rows = h4[0].shape[0] - 2

        def partners(dx):
            return tuple(g[1 + dx : 1 + dx + rows] for g in h4) + (nh[1 + dx : 1 + dx + rows],)

        local = [g[1:-1] for g in h4]
        counted = _loop_sums(*local, partners, p, bound, True, nh[1:-1])
        assert all(torch.equal(a, b) for a, b in zip(counted, _loop_sums(*local, partners, p, bound, True)))
        _close(counted, cell_cuda3.grid_force3_halo_reference(*(g.reshape(rows + 2, cap, c * c) for g in h4),
                                                               p, bound, True))
        return counted

    whole = _whole_grid_sums(s, p, bound, True, True)
    h4 = [g.view(c + 2, cap, c, c) for g in md._with_halo(s.xg, s.yg, s.zg)]
    assert all(torch.equal(a, b) for a, b in zip(block_sums(h4, bound), whole))
    if start == "above_cov":
        g4 = [g.view(c, cap, c, c) for g in (s.xg, s.yg, s.zg)]
        for sizes in ((7,), (4, 3), (3, 2, 2)):
            blocks = zip(*(_row_blocks(g, sizes, seam) for g, seam in zip(g4, (p.box, 0.0, 0.0))))
            got = [torch.cat(q) for q in zip(*(block_sums(list(b), bound) for b in blocks))]
            assert all(torch.equal(a, b) for a, b in zip(got, whole)), sizes
        assert all(torch.equal(a, b) for a, b in zip(block_sums(h4, cap), whole))


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_inputs():
    """On a CPU tensor ``grid_force3`` / ``grid_force3_halo`` (B5 with
    ``static_cov``, B4 without, at any strip) and the full loops take the
    plain version and count no launch; bad shapes, dtypes, bounds, strips
    and a capacity beyond B4's shared memory raise."""
    md, s = _engine()
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    cov = md.static_cov
    names = ("LAUNCHES", "ENERGY_LAUNCHES", "COUNTED_LAUNCHES", "HALO_COUNTED_LAUNCHES", "STATIC_LAUNCHES",
             "HALO_STATIC_LAUNCHES", "LOOP_LAUNCHES", "HALO_LOOP_LAUNCHES")
    before = [getattr(cell_cuda3, n) for n in names]
    want = cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, cov, True)
    for got in (cell_cuda3.grid_force3(s.xg, s.yg, s.zg, p, with_energy=True, static_cov=cov),
                cell_cuda3._forces3((s.xg, s.yg, s.zg), p, None, True, cov, halo=False, strip=2)[0],
                cell_cuda3.grid_force3_static_loop(s.xg, s.yg, s.zg, p, cov, True)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    mo = s.max_occ
    want4 = cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, int(mo))
    for got in (cell_cuda3.grid_force3(s.xg, s.yg, s.zg, p, max_occ=mo),
                cell_cuda3._forces3((s.xg, s.yg, s.zg), p, mo, False, None, halo=False, strip=2)[0],
                cell_cuda3.grid_force3_loop(s.xg, s.yg, s.zg, p, max_occ=mo)):
        assert all(torch.equal(a, b) for a, b in zip(got, want4))
    (xh,), (yh,), (zh,) = halo_blocks(s.xg, 1, md.box), halo_blocks(s.yg, 1), halo_blocks(s.zg, 1)
    want_h = cell_cuda3.grid_force3_halo_reference(xh, yh, zh, p, cov)
    for got in (cell_cuda3.grid_force3_halo(xh, yh, zh, p, static_cov=cov),
                cell_cuda3.grid_force3_static_loop(xh, yh, zh, p, cov, halo=True)):
        assert all(torch.equal(a, b) for a, b in zip(got, want_h))
    assert [getattr(cell_cuda3, n) for n in names] == before
    with pytest.raises(TypeError):
        cell_cuda3.grid_force3(s.xg.double(), s.yg, s.zg, p, static_cov=cov)
    with pytest.raises(ValueError, match="shape"):
        cell_cuda3.grid_force3(s.xg[:-1], s.yg[:-1], s.zg[:-1], p, static_cov=cov)
    with pytest.raises(ValueError, match="static_cov"):
        cell_cuda3.grid_force3(s.xg, s.yg, s.zg, p, static_cov=md.cap + 8)
    grids = (s.xg, s.yg, s.zg)
    for strip in (0, md.cps + 1):
        with pytest.raises(ValueError, match="strip"):
            cell_cuda3._forces3(grids, p, None, False, cov, halo=False, strip=strip)
    with pytest.raises(ValueError, match="strip"):
        cell_cuda3._forces3(grids, p, s.max_occ, False, None, halo=False, loop=True, strip=2)  # a loop has none
    # B4 beyond the capacity its shared memory holds (on the card as here)
    wide = make_cell_grid_fn(md.box, 2.5, N, dim=3, capacity=cell_cuda3.MAX_CAP + 8)
    pw = cell_cuda3.CellForce3Params.from_grid(wide)
    big = torch.zeros(pw.grid_shape)
    with pytest.raises(ValueError, match=f"MAX_CAP = {cell_cuda3.MAX_CAP}"):
        cell_cuda3.grid_force3(big, big, big, pw)
