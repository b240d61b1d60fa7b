"""The 2D engine's per-cell count grid, which kernel B3 takes, and the
invariant B3 rests on: after ``init`` and after every rebuild a cell's
particles fill its slots ``0 .. count-1`` and no other. Also the B3
wrapper's checks of the count grid, and, on the CPU, why B3's
count-bounded loop is bit-equal to B1's full-capacity loop: both loops
written out op for op in float32 give the same bits.

The count grid has no counterpart in the JAX package (its kernels loop over
every slot); the packed engine's trajectory against JAX's, with the count
grid in the state, is in ``test_torch_grid_md_packed*.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda, cell_cuda_packed
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import lattice_positions, velocities

N, RHO, DT = 4096, 0.8, 2e-3  # box 71.55: cps 24, cap 16


def _engine(rows_per_block, shift=0.0):
    """The engine and its initial state: a jittered lattice, moved by
    ``shift`` (a shift of about half a spacing puts a row of particles
    across the seam, unwrapped, as between rebuilds)."""
    box = float(np.sqrt(N / RHO))
    md = GridMD(make_cell_grid_fn(box, 2.5, N, dim=2), dt=DT, compensated=True,
                rows_per_block=rows_per_block, device="cpu")
    pos = torch.from_numpy(lattice_positions(N, box, seed=31) - np.float32(shift))
    vel = torch.from_numpy(velocities(N, kt=1.0, seed=32))
    return md, md.init(pos, vel)


def _check_counts(md, s, where):
    """``s.counts`` against the cells of the particles' positions, and the
    occupancy grid against ``slot < count``, exact."""
    assert s.counts.dtype == torch.int32 and tuple(s.counts.shape) == (md.cps, md.cps), where
    cells = torch.div(md.positions(s), md.box / md.cps, rounding_mode="floor").long().clamp(0, md.cps - 1)
    want = torch.bincount(cells[:, 0] * md.cps + cells[:, 1], minlength=md.cps * md.cps).view(md.cps, md.cps)
    assert torch.equal(s.counts.long(), want), where
    occ = cell_cuda_packed.unpack(s.occ, md.rows_per_block) > 0.5  # (cps, cap, cps)
    slot = torch.arange(md.cap).view(1, md.cap, 1)
    assert torch.equal(occ, slot < s.counts.unsqueeze(1)), where


@pytest.mark.parametrize("rows_per_block", [1, 4])  # grid (24, 16, 24) and (6, 16, 96)
def test_counts_match_positions_at_init_and_every_rebuild(rows_per_block):
    """Eight window -> rebuild cycles with particles crossing cells: the count
    grid is the per-cell particle count and the slots stay compact, after
    ``init``, after each sort-free rebuild and after the sort-based one."""
    md, s = _engine(rows_per_block)
    _check_counts(md, s, "init")
    window = md._make_window(md.force_kernel, 10)
    moved = 0
    for k in range(8):
        s = window(s)
        _, _, scode, _, _, _ = md._migration_dest(s)
        moved += int(((scode >= 0) & (torch.div(scode, md.cap, rounding_mode="floor") != 4)).sum())
        s = md._rebuild_migrate(s)
        _check_counts(md, s, f"rebuild {k}")
    assert moved > 50 and not bool(s.overflow)
    _check_counts(md, md._rebuild(window(s)), "sort-based rebuild")


def _sums(xu, yu, p, counts=None, with_energy=False):
    """Every slot's force (and e, w) summed as the CUDA kernels sum them, op
    for op in float32 on the unpacked ``(cps, cap, cps)`` grids: offsets in
    B1's order, partner slots ascending into per-offset partial sums added
    in offset order. Without ``counts``, B1's loop over all ``cap`` partner
    slots; with them, B3's loop, which skips partner slots ``b >= count``
    and gives empty targets 0."""
    cps, cap = p.cps, p.cap
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    box, cutoff2, sigma2, fscale = f32(p.box), f32(p.cutoff2), f32(p.sigma2), f32(p.fscale)
    two_fscale, four_eps, wscale, shift = 2.0 * fscale, 4.0 * f32(p.epsilon), fscale * sigma2, f32(p.shift)
    zero = torch.zeros((), dtype=torch.float32)
    idx = torch.arange(cps)
    acc = [torch.zeros_like(xu) for _ in range(4 if with_energy else 2)]
    for dx in (-1, 0, 1):
        off_x = torch.where(idx + dx < 0, -box, torch.where(idx + dx >= cps, box, zero)).view(cps, 1, 1)
        for dy in (-1, 0, 1):
            off_y = torch.where(idx + dy < 0, -box, torch.where(idx + dy >= cps, box, zero)).view(1, 1, cps)
            xp = torch.roll(xu, (-dx, -dy), (0, 2))
            yp = torch.roll(yu, (-dx, -dy), (0, 2))
            n_p = None if counts is None else torch.roll(counts, (-dx, -dy), (0, 1)).unsqueeze(1)
            part = [torch.zeros_like(xu) for _ in acc]
            for b in range(cap):
                ddx = xu - (xp[:, b : b + 1] + off_x)
                ddy = yu - (yp[:, b : b + 1] + off_y)
                r2 = ddx * ddx + ddy * ddy
                valid = (r2 > 0) & (r2 < cutoff2)
                inv = sigma2 / r2
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
                    part[k] = part[k] + t if n_p is None else torch.where(b < n_p, part[k] + t, part[k])
            acc = [a + q for a, q in zip(acc, part)]
    if counts is not None:
        occupied = torch.arange(cap).view(1, cap, 1) < counts.unsqueeze(1)
        acc = [torch.where(occupied, a, zero) for a in acc]
    return acc


@pytest.mark.parametrize("with_energy", [False, True])
def test_count_bounded_sums_bit_equal_to_full_capacity(with_energy):
    """On a state 20 steps from a lattice across the seams (coordinates
    outside [0, box), unwrapped), B3's
    count-bounded loop gives B1's full-capacity loop's bits on every slot:
    a skipped pair adds an exact +-0 to a partial sum that is never -0.
    Both loops also agree with B1's plain version within 1e-5 of the
    largest value (another summation order)."""
    md, s = _engine(4, shift=0.55)  # lattice spacing 1.118
    s = md._make_window(md.force_kernel, 20)(s)
    xu, yu = (cell_cuda_packed.unpack(g, 4).contiguous() for g in (s.xg, s.yg))
    occ = cell_cuda_packed.unpack(s.occ, 4) > 0.5
    assert int(((xu < 0) | (yu < 0))[occ].sum()) > 50 and not bool(s.overflow)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    full = _sums(xu, yu, p, with_energy=with_energy)
    bounded = _sums(xu, yu, p, s.counts, with_energy=with_energy)
    assert all(torch.equal(a, b) for a, b in zip(full, bounded))
    plain = cell_cuda.grid_force_reference(xu, yu, p, with_energy)
    for a, b in zip(full, plain):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("bad", ["missing", "shape", "dtype", "device", "strides"])
def test_packed_wrapper_rejects_a_malformed_count_grid(bad):
    """B3 never loops to ``cap`` for want of counts: a missing count grid, or
    one of the wrong shape, dtype, device or layout, raises (on the CPU as
    on the card, before any launch)."""
    md, s = _engine(4)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    counts = {
        "missing": None,
        "shape": s.counts[:, :-1].contiguous(),
        "dtype": s.counts.long(),
        "device": s.counts.to("meta"),
        "strides": s.counts.t(),
    }[bad]
    before = (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES)
    with pytest.raises((TypeError, ValueError), match="counts"):
        cell_cuda_packed.grid_force_packed(s.xg, s.yg, counts, p, 4)
    with pytest.raises(TypeError):
        md.force_kernel(s.xg, s.yg)  # the engine's B3 without its count grid
    assert (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES) == before
