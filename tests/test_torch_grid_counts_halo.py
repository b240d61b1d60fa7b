"""The 2D tile kernel's cell counts (B1 and B1 halo as launched), and the
invariant it rests on: after ``init`` and after every rebuild of the 2D
engine at R = 1 a cell's particles fill its slots ``0 .. count-1``, so a
cell's count is its number of non-sentinel slots. Also on the halo rows
``parallel.mesh.halo_blocks`` and ``ShardedGridMD`` attach (where the x
seam moves the sentinel by -+ box), and, on the CPU, why the tile kernel is
bit-equal to B1's loop: the count-bounded loop over halo blocks written out
op for op in float32 (r2 clamped as the kernel clamps it) gives the
full-capacity loop's bits. And the edge-row form of B1 halo's wrapper.

The counts have no counterpart in the JAX package (its kernels loop over
every slot); B1 and B1 halo against JAX's are in ``test_torch_cell_force.py``
and ``test_torch_halo_kernels.py``."""

import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks, make_mesh
from tests.test_torch_grid_counts import DT, _engine, _sums

SHIFT = 0.55  # lattice spacing 1.118: a row of particles starts across each seam, unwrapped
COUNTERS = ("LAUNCHES", "ENERGY_LAUNCHES", "HALO_LAUNCHES", "HALO_ENERGY_LAUNCHES", "LOOP_LAUNCHES",
            "LOOP_ENERGY_LAUNCHES", "HALO_LOOP_LAUNCHES", "HALO_LOOP_ENERGY_LAUNCHES")


def _counts(xg: torch.Tensor, p: cell_cuda.CellForceParams) -> torch.Tensor:
    """``(rows, cps)`` counts as the tile kernel derives them: the slots whose
    x is none of the sentinel, the sentinel - box and the sentinel + box
    (fl32, as a halo row across the x seam carries it)."""
    s = torch.tensor(p.sentinel, dtype=torch.float32)
    box = torch.tensor(p.box, dtype=torch.float32)
    empty = (xg == s) | (xg == s - box) | (xg == s + box)
    return (~empty).sum(1, dtype=torch.int32)


def _params(md):
    return cell_cuda.CellForceParams.from_grid(md.grid_fn)


@pytest.mark.parametrize("shift", [0.0, SHIFT])
def test_sentinel_counts_equal_the_count_grid(shift):
    """Eight window -> rebuild cycles at R = 1, from a start inside the box
    and from one shifted across the seams: after ``init``, after each
    sort-free rebuild and after the sort-based one, the sentinel-derived
    count of every cell is ``s.counts``."""
    md, s = _engine(1, shift)
    p = _params(md)
    assert bool(((s.xg < 0) | (s.yg < 0))[s.occ > 0.5].any()) == (shift > 0)
    assert torch.equal(_counts(s.xg, p), s.counts), "init"
    window = md._make_window(md.force_kernel, 10)
    for k in range(8):
        s = md._rebuild_migrate(window(s))
        assert torch.equal(_counts(s.xg, p), s.counts), f"rebuild {k}"
    assert not bool(s.overflow)
    s = md._rebuild(window(s))
    assert torch.equal(_counts(s.xg, p), s.counts), "sort-based rebuild"


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_sentinel_counts_on_halo_rows(n_blocks):
    """The halo rows ``halo_blocks`` attaches over 2 and 4 row blocks (the
    first block's previous row minus box, the last block's next row plus
    box): their sentinel-derived counts are the counts of the rows they copy,
    a window after a rebuild."""
    md, s = _engine(1, SHIFT)
    s = md._make_window(md.force_kernel, 10)(md._rebuild_migrate(md._make_window(md.force_kernel, 10)(s)))
    p = _params(md)
    rows = md.cps // n_blocks
    ext = torch.cat([s.counts[-1:], s.counts, s.counts[:1]])
    for k, xh in enumerate(halo_blocks(s.xg, n_blocks, md.box)):
        assert torch.equal(_counts(xh, p), ext[k * rows : k * rows + rows + 2]), k
    sentinel = torch.tensor(p.sentinel, dtype=torch.float32)
    first = halo_blocks(s.xg, n_blocks, md.box)[0][0]
    assert bool((first[s.occ[-1] < 0.5] == sentinel - p.box).all())  # the seam moved the sentinels


def test_sharded_edge_rows_carry_the_counts():
    """The edge rows ``ShardedGridMD`` exchanges at world size 1 (its last
    row minus box before its rows, its first plus box after them) count as
    the rows they copy, after ``init`` and after a rebuild."""
    md0, s0 = _engine(1, SHIFT)
    md = ShardedGridMD(md0.grid_fn, make_mesh(device="cpu"), dt=DT, compensated=True)
    s = md.prepare(s0)
    p = _params(md)
    for where in ("init", "rebuild"):
        prev, nxt = md._edge_rows(s.xg, s.yg)
        assert torch.equal(_counts(prev[0][None], p)[0], s.counts[-1]), where
        assert torch.equal(_counts(nxt[0][None], p)[0], s.counts[0]), where
        s = md._rebuild_migrate(md._make_window(md.force_kernel, 10)(s))


def _bounded_halo_sums(xh, yh, p, with_energy):
    """The tile kernel's loop, op for op in float32, on one ``(rows + 2, cap,
    cps)`` halo block: the 9 offsets in B1's order, partner slots ``b <
    count`` ascending into per-offset partial sums added in offset order,
    ``r2`` clamped at ``sigma^2 2^-46`` before the IEEE division (the
    kernel's ``div_rn_normal`` gives IEEE's quotient there), targets below
    their cell's count; empty slots 0."""
    rows, cap, cps = xh.shape[0] - 2, p.cap, p.cps
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    box, cutoff2, sigma2, fscale = f32(p.box), f32(p.cutoff2), f32(p.sigma2), f32(p.fscale)
    two_fscale, four_eps, wscale, shift = 2.0 * fscale, 4.0 * f32(p.epsilon), fscale * sigma2, f32(p.shift)
    r2_lo = sigma2 * f32(2.0**-46)
    zero = torch.zeros((), dtype=torch.float32)
    idx = torch.arange(cps)
    nh = _counts(xh, p)
    xl, yl = xh[1:-1], yh[1:-1]
    acc = [torch.zeros_like(xl) for _ in range(4 if with_energy else 2)]
    for dx in (-1, 0, 1):
        xr, yr, nr = xh[1 + dx : 1 + dx + rows], yh[1 + dx : 1 + dx + rows], nh[1 + dx : 1 + dx + rows]
        for dy in (-1, 0, 1):
            off_y = torch.where(idx + dy < 0, -box, torch.where(idx + dy >= cps, box, zero)).view(1, 1, cps)
            xp = torch.roll(xr, -dy, 2) + zero  # the kernel stages x + 0.0f
            yp = torch.roll(yr, -dy, 2) + off_y
            n_p = torch.roll(nr, -dy, 1).unsqueeze(1)
            part = [torch.zeros_like(xl) for _ in acc]
            for b in range(cap):
                ddx = xl - xp[:, b : b + 1]
                ddy = yl - yp[:, b : b + 1]
                r2 = ddx * ddx + ddy * ddy
                valid = (r2 > 0) & (r2 < cutoff2)
                inv = sigma2 / torch.maximum(r2, r2_lo)
                s6 = inv * inv * inv
                if with_energy:
                    s12 = s6 * s6
                    fmag = torch.where(valid, (2.0 * s12 - s6) * inv * fscale, zero)
                    terms = (fmag * ddx, fmag * ddy, torch.where(valid, four_eps * (s12 - s6) - shift, zero),
                             torch.where(valid, (2.0 * s12 - s6) * wscale, zero))
                else:
                    fmag = torch.where(valid, s6 * inv * (two_fscale * s6 - fscale), zero)
                    terms = (fmag * ddx, fmag * ddy)
                for k, t in enumerate(terms):
                    part[k] = torch.where(b < n_p, part[k] + t, part[k])
            acc = [a + q for a, q in zip(acc, part)]
    target = torch.arange(cap).view(1, cap, 1) < nh[1:-1].unsqueeze(1)
    return [torch.where(target, a, zero) for a in acc]


@pytest.mark.parametrize("with_energy", [False, True])
def test_count_bounded_halo_sums_bit_equal_to_loop(with_energy):
    """On a state 20 steps from a lattice across the seams (coordinates
    outside [0, box), unwrapped), the tile kernel's loop over 1, 2 and 4
    halo blocks gives B1's full-capacity loop on the whole grid bit for bit:
    a skipped pair adds an exact +-0 to a partial sum that is never -0, and
    b stays ascending. Against B1 halo's plain version it agrees within 1e-5
    of the largest value: the plain version sums each pair block over b
    with torch's reduction, whose order is not ascending."""
    md, s = _engine(1, SHIFT)
    s = md._make_window(md.force_kernel, 20)(s)
    assert int(((s.xg < 0) | (s.yg < 0))[s.occ > 0.5].sum()) > 50 and not bool(s.overflow)
    p = _params(md)
    full = _sums(s.xg, s.yg, p, with_energy=with_energy)
    for n_blocks in (1, 2, 4):
        blocks = list(zip(halo_blocks(s.xg, n_blocks, md.box), halo_blocks(s.yg, n_blocks)))
        parts = [_bounded_halo_sums(xh, yh, p, with_energy) for xh, yh in blocks]
        got = [torch.cat(q) for q in zip(*parts)]
        assert all(torch.equal(a, b) for a, b in zip(got, full)), n_blocks
        plain = [torch.cat(q) for q in zip(*(cell_cuda.grid_force_halo_reference(xh, yh, p, with_energy)
                                             for xh, yh in blocks))]
        for a, b in zip(got, plain):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("with_energy", [False, True])
def test_edge_form_on_cpu_takes_the_plain_version(with_energy):
    """``grid_force_halo_edges`` on CPU tensors gives the tensors of the
    ``(rows + 2)`` form over 2 blocks, and the sharded engine's force at
    world size 1 those of ``grid_force_halo`` on its ``_with_halo`` grids;
    no launch is counted, of the tile kernel or of the loop."""
    md, s = _engine(1, SHIFT)
    p = _params(md)
    before = [getattr(cell_cuda, n) for n in COUNTERS]
    for xh, yh in zip(halo_blocks(s.xg, 2, md.box), halo_blocks(s.yg, 2)):
        want = cell_cuda.grid_force_halo(xh, yh, p, with_energy)
        got = cell_cuda.grid_force_halo_edges(xh[1:-1], yh[1:-1], xh[0], yh[0], xh[-1], yh[-1], p, with_energy)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        loop = cell_cuda.grid_force_halo_loop(xh, yh, p, with_energy)
        assert all(torch.equal(a, b) for a, b in zip(loop, want))
    assert all(torch.equal(a, b) for a, b in zip(cell_cuda.grid_force_loop(s.xg, s.yg, p, with_energy),
                                                 cell_cuda.grid_force(s.xg, s.yg, p, with_energy)))
    sharded = ShardedGridMD(md.grid_fn, make_mesh(device="cpu"), dt=DT, compensated=True)
    ss = sharded.prepare(s)
    want = cell_cuda.grid_force_halo(*sharded._with_halo(ss.xg, ss.yg), p, with_energy)
    got = sharded._halo_energy(ss.xg, ss.yg) if with_energy else sharded._halo_force(ss.xg, ss.yg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [getattr(cell_cuda, n) for n in COUNTERS] == before


@pytest.mark.parametrize("bad", ["local shape", "local dtype", "edge shape", "edge dtype", "edge strides",
                                 "edge device", "no rows"])
def test_edge_form_rejects_bad_inputs(bad):
    """Bad local grids and bad edge rows raise before any launch, on the
    CPU as on the card."""
    md, s = _engine(1)
    p = _params(md)
    xg, yg = s.xg[:8].contiguous(), s.yg[:8].contiguous()
    rows = [s.xg[-1], s.yg[-1], s.xg[8], s.yg[8]]
    if bad == "local shape":
        xg, yg = xg[:, :-1].contiguous(), yg[:, :-1].contiguous()
    elif bad == "local dtype":
        xg = xg.double()
    elif bad == "edge shape":
        rows[1] = rows[1][:-1]
    elif bad == "edge dtype":
        rows[2] = rows[2].double()
    elif bad == "edge strides":
        rows[3] = s.yg[8].t().contiguous().t()  # (cap, cps), column-major
    elif bad == "edge device":
        rows[0] = rows[0].to("meta")
    elif bad == "no rows":
        xg, yg = xg[:0], yg[:0]
    before = [getattr(cell_cuda, n) for n in COUNTERS]
    with pytest.raises((TypeError, ValueError)):
        cell_cuda.grid_force_halo_edges(xg, yg, *rows, p)
    assert [getattr(cell_cuda, n) for n in COUNTERS] == before
