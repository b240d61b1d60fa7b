"""The 3D engine's cell counts, as the counted B5 kernel derives them, and
the invariant that kernel rests on: after ``init`` and after every rebuild
a cell's particles fill its slots ``0 .. count-1`` and no other, so a
cell's count is its number of non-sentinel slots. Also on the halo rows a
rank of ``ShardedGridMD3`` attaches (where the x seam moves the sentinel
by -+ box), and, on the CPU, why the counted loop is bit-equal to B5's
full loop: the count-bounded loop written out op for op in float32 gives
the plain versions' bits. And the wrapper's dispatch and checks.

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


def _engine(shift=0.0, static_cov="auto", sharded=False):
    """The engine and its initial state: a jittered cubic lattice, moved by
    ``shift`` on every axis (about half a spacing puts a plane of particles
    across each seam, unwrapped, as between rebuilds)."""
    box = float((N / RHO) ** (1.0 / 3.0))
    gf = make_cell_grid_fn(box, 2.5, N, dim=3)
    if sharded:
        md = ShardedGridMD3(gf, make_mesh(device="cpu"), dt=DT, compensated=True, static_cov=static_cov)
    else:
        md = GridMD3(gf, dt=DT, compensated=True, static_cov=static_cov, device="cpu")
    pos = torch.from_numpy(lattice_positions(N, box, seed=41, dim=3) - np.float32(shift))
    vel = torch.from_numpy(velocities(N, kt=1.0, seed=42, dim=3))
    return md, md.init(pos, vel)


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
        _, _, _, scode, _, _ = md._migration_dest3(s)
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


@pytest.mark.parametrize("with_energy", [False, True])
def test_count_bounded_sums_bit_equal_to_full_loops(with_energy):
    """On a state 16 steps from a lattice across the seams (coordinates
    outside [0, box), unwrapped), the counted kernel's loop gives B5's full
    loop at ``cov`` and B4's at ``max_occ`` bit for bit: a skipped pair adds
    an exact +-0 to a partial sum that is never -0, and b stays ascending.
    All three agree with B5's and B4's plain versions to summation order."""
    md, s = _engine(SHIFT)
    s = md._window_for(s, 16)(s)
    occ = s.occ > 0.5
    assert int(((s.xg < 0) | (s.yg < 0) | (s.zg < 0))[occ].sum()) > 50 and not bool(s.overflow)
    mo, cov = int(s.max_occ), md.static_cov
    assert mo < cov  # B4's bound and B5's differ
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    counted = _whole_grid_sums(s, p, cov, with_energy, True)
    for full in (_whole_grid_sums(s, p, cov, with_energy, False), _whole_grid_sums(s, p, mo, with_energy, False)):
        assert all(torch.equal(a, b) for a, b in zip(counted, full))
    for bound in (cov, mo):
        _close(counted, cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, bound, with_energy))


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


def test_counted_halo_sums_bit_equal_to_full_halo_loop():
    """The counted loop on one rank's extended grid (the halo x-rows with
    their seam, counts from the shifted sentinels) gives B5 halo's full
    loop and the whole-grid counted sums bit for bit, and B5 halo's plain
    version to summation order."""
    md, s = _engine(SHIFT, sharded=True)
    s = md._window_for(s, 16)(s)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    c, cap, cov = p.cps, p.cap, md.static_cov
    h4 = [g.view(c + 2, cap, c, c) for g in md._with_halo(s.xg, s.yg, s.zg)]
    nh = _counts(h4[0].reshape(c + 2, cap, c * c), p)

    def partners(dx):
        return tuple(g[1 + dx : 1 + dx + c] for g in h4) + (nh[1 + dx : 1 + dx + c],)

    local = [g[1:-1] for g in h4]
    counted = _loop_sums(*local, partners, p, cov, True, nh[1:-1])
    full = _loop_sums(*local, partners, p, cov, True)
    assert all(torch.equal(a, b) for a, b in zip(counted, full))
    assert all(torch.equal(a, b) for a, b in zip(counted, _whole_grid_sums(s, p, cov, True, True)))
    _close(counted, cell_cuda3.grid_force3_halo_reference(*(g.view(c + 2, cap, c * c) for g in h4), p, cov, True))


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_inputs():
    """On a CPU tensor ``grid_force3`` / ``grid_force3_halo`` with
    ``static_cov`` and ``grid_force3_static_loop`` take the plain version
    and count no launch; bad shapes, dtypes, bounds and strips raise."""
    md, s = _engine()
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    cov = md.static_cov
    names = ("COUNTED_LAUNCHES", "HALO_COUNTED_LAUNCHES", "STATIC_LAUNCHES", "HALO_STATIC_LAUNCHES")
    before = [getattr(cell_cuda3, n) for n in names]
    want = cell_cuda3.grid_force3_reference(s.xg, s.yg, s.zg, p, cov, True)
    for got in (cell_cuda3.grid_force3(s.xg, s.yg, s.zg, p, with_energy=True, static_cov=cov),
                cell_cuda3._forces3((s.xg, s.yg, s.zg), p, None, True, cov, halo=False, strip=2)[0],
                cell_cuda3.grid_force3_static_loop(s.xg, s.yg, s.zg, p, cov, True)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
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
        cell_cuda3._forces3(grids, p, s.max_occ, False, None, halo=False, strip=2)  # B4 has no strips
