"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version, and the engine on the card against the engine on the CPU.

The CUDA kernels have no CPU or interpret mode, so every test here needs an
NVIDIA GPU and skips without one. On the card (where jax, which
``tests/conftest.py`` imports, may be absent):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import (
    cell_cuda,
    cell_cuda3,
    cell_cuda_packed,
    copy_cuda,
    migrate_cuda,
    migrate_cuda3,
    pairwise_cuda,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD

# the rebuild's inputs and overflow states of the B2 checks, from this
# directory (pytest puts it on sys.path; the card may lack the conftest)
import torch_migrate_designs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


CFG = override(MDConfig(), n=4096, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice",
               eq_steps=100, prod_steps=100, sample_every=50)  # cps 24: the engine packs R=24


def _advanced_state(device, rows_per_block=1):
    """A grid state 20 steps after a rebuild, on the layout with
    ``rows_per_block`` cell rows a block: coordinates unwrapped."""
    gf = lj_fluid._make_grid_md(CFG, device).grid_fn
    md = GridMD(gf, dt=CFG.dt, compensated=True, rows_per_block=rows_per_block, device=device)
    s0 = lj_fluid.init_state(CFG, device)
    gs = md.make_production_run(200, 5, gate_frac=0.35)(md.init(s0.position, s0.velocity))
    return md, md._make_window(md.force_kernel, 20)(gs)


CFG3 = override(CFG, n=8192, dim=3)  # cps 8, cap 32, B5 bound 24


def _advanced_state3(device, n: int = CFG3.n):
    """A 3D grid state at ``n`` particles 5 steps after a rebuild:
    coordinates unwrapped."""
    cfg = override(CFG3, n=n)
    md = lj_fluid._make_grid_md(cfg, device)
    s0 = lj_fluid.init_state(cfg, device)
    gs = md.make_production_run_fixed(100, 10)(md.init(s0.position, s0.velocity))
    return md, md._window_for(gs, 5)(gs)


def test_cell_force_kernel_matches_plain(cuda_device):
    md, gs = _advanced_state(cuda_device)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    occ = gs.occ > 0.5
    before = (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy=with_energy)
        want = cell_cuda.grid_force_reference(gs.xg, gs.yg, p, with_energy=with_energy)
        torch.cuda.synchronize()
        for a, b in zip(got[:2], want[:2]):
            assert float((a - b)[occ].abs().max()) <= 1e-4
            assert bool((a[~occ] == 0).all())
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_allclose(float(a.double().sum()), float(b.double().sum()), rtol=1e-5)
    assert (cell_cuda.LAUNCHES, cell_cuda.ENERGY_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("with_energy", [False, True])
def test_tile_kernel_bit_equal_to_loop(cuda_device, with_energy):
    """B1 as launched (the tile kernel, at its default tile and at tiles of
    1 to 24 rows x 1 to 24 columns) torch.equal to B1's loop on the same
    state, and over two launches; the wrappers' launches counted."""
    md, gs = _advanced_state(cuda_device, rows_per_block=1)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    before = (cell_cuda.LAUNCHES + cell_cuda.ENERGY_LAUNCHES, cell_cuda.LOOP_LAUNCHES + cell_cuda.LOOP_ENERGY_LAUNCHES)
    loop = cell_cuda.grid_force_loop(gs.xg, gs.yg, p, with_energy)
    got = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy)
    again = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, loop))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    h, w, threads = cell_cuda.tile_shape(p, md.cps, with_energy, cuda_device)
    assert 1 <= h <= md.cps and 1 <= w <= md.cps and threads % 32 == 0 and threads >= h * w
    for tile in ((1, 1), (1, 24), (2, 7), (3, 13), (5, 24), (24, 5)):
        out = cell_cuda.grid_force(gs.xg, gs.yg, p, with_energy, tile=tile)
        assert all(torch.equal(a, b) for a, b in zip(out, loop)), tile
    after = (cell_cuda.LAUNCHES + cell_cuda.ENERGY_LAUNCHES, cell_cuda.LOOP_LAUNCHES + cell_cuda.LOOP_ENERGY_LAUNCHES)
    assert after == (before[0] + 8, before[1] + 1)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_tile_halo_kernel_bit_equal_to_whole_grid(cuda_device, p):
    """B1 halo as launched (the tile kernel) over p row blocks, both variants
    and both input forms (the ``(rows + 2)`` grids, and the local grids with
    the four edge rows), torch.equal to the whole-grid tile kernel and to
    B1 halo's loop on the same blocks."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    md, gs = _advanced_state(cuda_device, rows_per_block=1)
    params = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    blocks = list(zip(halo_blocks(gs.xg, p, md.box), halo_blocks(gs.yg, p)))
    before = (cell_cuda.HALO_LAUNCHES + cell_cuda.HALO_ENERGY_LAUNCHES,
              cell_cuda.HALO_LOOP_LAUNCHES + cell_cuda.HALO_LOOP_ENERGY_LAUNCHES)
    for with_energy in (False, True):
        whole = cell_cuda.grid_force(gs.xg, gs.yg, params, with_energy)
        stacked = [cell_cuda.grid_force_halo(x, y, params, with_energy) for x, y in blocks]
        edges = [cell_cuda.grid_force_halo_edges(x[1:-1].contiguous(), y[1:-1].contiguous(), x[0].clone(),
                                                 y[0].clone(), x[-1].clone(), y[-1].clone(), params, with_energy)
                 for x, y in blocks]
        loop = [cell_cuda.grid_force_halo_loop(x, y, params, with_energy) for x, y in blocks]
        for got in (stacked, edges, loop):
            assert all(torch.equal(torch.cat(q), f) for q, f in zip(zip(*got), whole))
    after = (cell_cuda.HALO_LAUNCHES + cell_cuda.HALO_ENERGY_LAUNCHES,
             cell_cuda.HALO_LOOP_LAUNCHES + cell_cuda.HALO_LOOP_ENERGY_LAUNCHES)
    assert after == (before[0] + 4 * p, before[1] + 2 * p)


def _b2_cases(md, gs):
    """The rebuild's inputs (``torch_migrate_designs.rebuild_inputs``: the
    code grid, the allocation's occupancy, the 11 planes where they lie,
    the fills, the overflow flag) on ``gs`` and on its overflow state (a
    cell crowded past its capacity)."""
    cases = [torch_migrate_designs.rebuild_inputs(md, gs),
             torch_migrate_designs.rebuild_inputs(md, torch_migrate_designs.overflow_state(md, gs))]
    assert [bool(c[4]) for c in cases] == [False, True]
    return cases


def test_migrate_kernel_bit_equal(cuda_device):
    """B2 (one launch: fill and scatter) torch.equal to its plain version,
    the planes passed as a list of separate tensors, also at overflow."""
    md, gs = _advanced_state(cuda_device)
    for scode, occ, planes, fills, _ in _b2_cases(md, gs):
        before = migrate_cuda.LAUNCHES
        got = migrate_cuda.migrate(scode, planes, fills, occ=occ)
        assert torch.equal(got, migrate_cuda.migrate_reference(scode, torch.stack(planes), fills))
        assert migrate_cuda.LAUNCHES == before + 1


@pytest.mark.parametrize("rows_per_block", [4, 24])  # G = 6 and 1
def test_cell_force_packed_kernel_matches_plain(cuda_device, rows_per_block):
    """B3 (both variants) against its plain version: forces at atol 1e-4 on
    occupied slots (summation order), exact zeros elsewhere, e and w sums
    at rtol 1e-5; two launches bit-equal (no atomics), and bit-equal to B1
    on the unpacked grids (the same pairs in the same order)."""
    md, gs = _advanced_state(cuda_device, rows_per_block)
    assert tuple(gs.xg.shape) == (24 // rows_per_block, md.cap, 24 * rows_per_block)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    occ = gs.occ > 0.5
    r = rows_per_block
    xu, yu = cell_cuda_packed.unpack(gs.xg, r).contiguous(), cell_cuda_packed.unpack(gs.yg, r).contiguous()
    before = (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, with_energy)
        again = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, with_energy)
        want = cell_cuda_packed.grid_force_packed_reference(gs.xg, gs.yg, p, r, with_energy)
        b1 = [cell_cuda_packed.pack(t, r) for t in cell_cuda.grid_force(xu, yu, p, with_energy)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(torch.equal(a, b) for a, b in zip(got, b1))
        for a, b in zip(got[:2], want[:2]):
            assert float((a - b)[occ].abs().max()) <= 1e-4
            assert bool((a[~occ] == 0).all())
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_allclose(float(a.double().sum()), float(b.double().sum()), rtol=1e-5)
    assert (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("rows_per_block", [4, 24])
def test_migrate_packed_kernel_bit_equal(cuda_device, rows_per_block):
    md, gs = _advanced_state(cuda_device, rows_per_block)
    for scode, occ, planes, fills, _ in _b2_cases(md, gs):
        before = (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES)
        got = migrate_cuda.migrate(scode, planes, fills, rows_per_block, occ=occ)
        assert torch.equal(got, migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, rows_per_block))
        assert (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES) == (before[0], before[1] + 1)


@pytest.mark.parametrize("rows_per_block", [7, 49])
def test_migrate_packed_kernel_across_block_seams(cuda_device, rows_per_block):
    """Packed B2 at N=16,384 (49 cells per side) with R = 7 (G = 7: block
    rows of 343 lanes, 11 blocks of 32 lanes, most of them across a seam
    of cell rows) and R = 49 (G = 1), on a state with movers across the
    block seams and at overflow: torch.equal to the plain version."""
    cfg = override(CFG, n=16_384)
    md = GridMD(lj_fluid._make_grid_md(cfg, cuda_device).grid_fn, dt=cfg.dt, compensated=True,
                rows_per_block=rows_per_block, device=cuda_device)
    s0 = lj_fluid.init_state(cfg, cuda_device)
    gs = md._make_window(md.force_kernel, 20)(md.make_production_run(200, 5, gate_frac=0.35)(
        md.init(s0.position, s0.velocity)))
    for scode, occ, planes, fills, _ in _b2_cases(md, gs):
        sub = torch.div(torch.arange(md.lanes, device=cuda_device), md.cps, rounding_mode="floor")
        dx = torch.div(scode, 3 * md.cap, rounding_mode="floor") - 1
        if rows_per_block == 7:
            assert int(((scode >= 0) & (((dx == -1) & (sub == 0)) | ((dx == 1) & (sub == 6)))).sum()) > 0
        got = migrate_cuda.migrate(scode, planes, fills, rows_per_block, occ=occ)
        assert torch.equal(got, migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, rows_per_block))


def test_migrate_wrappers_reject_a_wrong_occ(cuda_device):
    """B2 and B2 halo on the card refuse an ``occ`` of the wrong shape, type
    or device, or not contiguous, before any launch."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    md, gs = _advanced_state(cuda_device)
    scode, occ, planes, fills, _ = _b2_cases(md, gs)[0]
    (ch,), (fh,) = halo_blocks(scode, 1), halo_blocks(torch.stack(planes), 1, dim=1)
    before = (migrate_cuda.LAUNCHES, migrate_cuda.HALO_LAUNCHES)
    for bad in (occ[:, :-1].contiguous(), occ.double(), occ.cpu(), occ.transpose(0, 2), occ.bool()):
        with pytest.raises(ValueError, match="occ"):
            migrate_cuda.migrate(scode, planes, fills, occ=bad)
        with pytest.raises(ValueError, match="occ"):
            migrate_cuda.migrate_halo(ch, fh, fills, occ=bad)
    with pytest.raises(ValueError, match="occ"):
        migrate_cuda.migrate_halo(ch, fh, fills, occ=torch.zeros_like(ch, dtype=torch.float32))
    with pytest.raises(TypeError, match="occ"):
        migrate_cuda.migrate(scode, planes, fills)
    assert (migrate_cuda.LAUNCHES, migrate_cuda.HALO_LAUNCHES) == before


def test_cell_force3_kernels_match_plain(cuda_device):
    """B4 (both variants) and B5 against their plain versions at the same
    bound: forces at atol 1e-4 on occupied slots (summation order), exact
    zeros elsewhere, e and w sums at rtol 1e-5. (This state is still
    melting from the lattice, so its max occupancy may exceed B5's bound:
    B5 then differs from B4, as it should.)"""
    md, gs = _advanced_state3(cuda_device)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    occ = gs.occ > 0.5
    mo = int(gs.max_occ)
    before = (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.COUNTED_LAUNCHES)
    args = (gs.xg, gs.yg, gs.zg, p)
    for with_energy in (False, True):
        got = cell_cuda3.grid_force3(*args, max_occ=gs.max_occ, with_energy=with_energy)
        want = cell_cuda3.grid_force3_reference(*args, mo, with_energy)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b)[occ].abs().max()) <= 1e-4
            assert bool((a[~occ] == 0).all())
        for a, b in zip(got[3:], want[3:]):
            np.testing.assert_allclose(float(a.double().sum()), float(b.double().sum()), rtol=1e-5)
    got = cell_cuda3.grid_force3(*args, static_cov=md.static_cov)
    want = cell_cuda3.grid_force3_reference(*args, md.static_cov)
    for a, b in zip(got, want):
        assert float((a - b)[occ].abs().max()) <= 1e-4
        assert bool((a[:, md.static_cov:] == 0).all())
    assert (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.COUNTED_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("with_energy", [False, True])
def test_counted_kernel3_bit_equal_to_static_loop(cuda_device, with_energy):
    """B5 as launched (the counted kernel, at the default strip and, through
    the wrappers' launcher, at every strip width of 1 to 8 z-cells)
    torch.equal to B5's full loop on the same state, and over two launches;
    the wrappers' launches counted."""
    md, gs = _advanced_state3(cuda_device)
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    args, cov = (gs.xg, gs.yg, gs.zg, p), md.static_cov
    before = (cell_cuda3.COUNTED_LAUNCHES, cell_cuda3.STATIC_LAUNCHES)
    loop = cell_cuda3.grid_force3_static_loop(*args, cov, with_energy)
    got = cell_cuda3.grid_force3(*args, with_energy=with_energy, static_cov=cov)
    again = cell_cuda3.grid_force3(*args, with_energy=with_energy, static_cov=cov)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, loop))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert 1 <= cell_cuda3.strip_width(p, md.cps, cov, with_energy, cuda_device) <= md.cps
    for strip in range(1, md.cps + 1):
        out, _ = cell_cuda3._forces3(args[:3], p, None, with_energy, cov, halo=False, strip=strip)
        assert all(torch.equal(a, b) for a, b in zip(out, loop)), strip
    assert (cell_cuda3.COUNTED_LAUNCHES, cell_cuda3.STATIC_LAUNCHES) == (before[0] + 2, before[1] + 1)


def _melt_state3(device):
    """A 3D grid state 30 steps into the melt from the lattice at N=8192:
    its fullest cell exceeds B5's bound, where the hybrid windows run B4."""
    md = lj_fluid._make_grid_md(CFG3, device)
    s0 = lj_fluid.init_state(CFG3, device)
    return md, md.make_production_run_fixed(30, 10)(md.init(s0.position, s0.velocity))


@pytest.mark.parametrize("with_energy", [False, True])
def test_b4_counted_bit_equal_to_loop(cuda_device, with_energy):
    """B4 as launched (the counted kernel, bound ``max_occ`` read on the
    card) torch.equal to B4's loop and to itself at the full capacity and
    over two launches, on ``_advanced_state3``'s state (where its max
    occupancy is within B5's bound, B5's bits too) and on a melt above that
    bound; its halo form over 1, 2 and 4 x-row blocks
    torch.equal to the whole grid and to the loop's halo form."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    for state in (_advanced_state3, _melt_state3):
        md, gs = state(cuda_device)
        p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
        args, mo, cov = (gs.xg, gs.yg, gs.zg, p), gs.max_occ, md.static_cov
        before = (cell_cuda3.LAUNCHES + cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.LOOP_LAUNCHES)
        loop = cell_cuda3.grid_force3_loop(*args, max_occ=mo, with_energy=with_energy)
        got = cell_cuda3.grid_force3(*args, max_occ=mo, with_energy=with_energy)
        for again in (cell_cuda3.grid_force3(*args, max_occ=mo, with_energy=with_energy),
                      cell_cuda3.grid_force3(*args, with_energy=with_energy), loop):
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), state.__name__
        if int(mo) <= cov:
            b5 = cell_cuda3.grid_force3(*args, with_energy=with_energy, static_cov=cov)
            assert all(torch.equal(a, b) for a, b in zip(got, b5))
        assert (cell_cuda3.LAUNCHES + cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.LOOP_LAUNCHES) == (
            before[0] + 3, before[1] + 1)
        for n in (1, 2, 4):
            blocks = list(zip(halo_blocks(gs.xg, n, md.box), halo_blocks(gs.yg, n), halo_blocks(gs.zg, n)))
            parts = [cell_cuda3.grid_force3_halo(*b, p, max_occ=mo, with_energy=with_energy) for b in blocks]
            loops = [cell_cuda3.grid_force3_loop(*b, p, max_occ=mo, with_energy=with_energy, halo=True)
                     for b in blocks]
            for q in (parts, loops):
                assert all(torch.equal(torch.cat(c), f) for c, f in zip(zip(*q), got)), (state.__name__, n)
    assert int(mo) > cov  # the melt state is above B5's bound


@pytest.mark.parametrize("p", [1, 2, 4])
def test_counted_halo_kernel3_bit_equal_to_static_loops(cuda_device, p):
    """B5 halo as launched (the counted kernel) over p x-row blocks, both
    variants, torch.equal to B5 halo's full loop on the same blocks and to
    B5's full loop on the whole grid: the seam-shifted sentinels of the
    halo rows count as empty."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    md, gs = _advanced_state3(cuda_device)
    params = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    cov = md.static_cov
    blocks = list(zip(halo_blocks(gs.xg, p, md.box), halo_blocks(gs.yg, p), halo_blocks(gs.zg, p)))
    before = (cell_cuda3.HALO_COUNTED_LAUNCHES, cell_cuda3.HALO_STATIC_LAUNCHES)
    for with_energy in (False, True):
        whole = cell_cuda3.grid_force3_static_loop(gs.xg, gs.yg, gs.zg, params, cov, with_energy)
        counted = [cell_cuda3.grid_force3_halo(*b, params, with_energy=with_energy, static_cov=cov) for b in blocks]
        loop = [cell_cuda3.grid_force3_static_loop(*b, params, cov, with_energy, halo=True) for b in blocks]
        for got in (counted, loop):
            assert all(torch.equal(torch.cat(q), f) for q, f in zip(zip(*got), whole))
    assert (cell_cuda3.HALO_COUNTED_LAUNCHES, cell_cuda3.HALO_STATIC_LAUNCHES) == (before[0] + 2 * p, before[1] + 2 * p)


def test_migrate3_kernels_bit_equal(cuda_device):
    """B6 and B7 (one launch each: fill, scatter and flag) bit-equal to the
    plain version, on the stacked fields and on the planes where they lie,
    with the flag of the CPU's ``mover_overflow`` at k_mov 8 and at 1
    (which trips it)."""
    md, gs = _advanced_state3(cuda_device)
    _, _, _, scode, occ_new, _, _ = md._migration_dest(gs)
    planes = [gs.xg, gs.yg, gs.zg, gs.vxg, gs.pid.float()]
    fields = torch.stack(planes)
    fills = [md.sentinel, 0.0, 0.0, 0.0, -1.0]
    before = (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES)
    want = migrate_cuda3.migrate3_reference(scode, fields, fills)
    for k_mov in (8, 1, None):
        for f in (fields, planes):
            got, mov_of = migrate_cuda3.migrate3(scode, f, fills, k_mov=k_mov, occ=occ_new)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert mov_of.dtype == torch.bool and mov_of.device.type == "cuda"
            want_flag = k_mov is not None and bool(migrate_cuda3.mover_overflow(scode.cpu(), k_mov))
            assert bool(mov_of) is want_flag, k_mov
    assert bool(migrate_cuda3.mover_overflow(scode, 1))
    assert (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES) == (before[0] + 4, before[1] + 2)


def test_migrate3_flags_back_to_back(cuda_device):
    """B6, B7 and B6 halo launched in turn, queued with no sync between
    them, on two grids of different sizes (N=2048 and N=8192) with
    the flag tripping and not, then again on a second stream: every flag is
    ``mover_overflow``'s (B7's False), so each launch leaves the flag's
    device scratch as it found it."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    cases = []
    for md, gs in (_advanced_state3(cuda_device, n=2048), _advanced_state3(cuda_device)):
        _, _, _, scode, occ, _, _ = md._migration_dest(gs)
        planes = [gs.xg, gs.pid.float()]
        fills = [md.sentinel, -1.0]
        (ch,), (fh,) = halo_blocks(scode, 1), halo_blocks(torch.stack(planes), 1, dim=1)
        for k_mov in (1, md.migrate_k_mov):
            want = bool(migrate_cuda3.mover_overflow(scode.cpu(), k_mov))
            cases.append((lambda s=scode, f=planes, v=fills, k=k_mov, o=occ: migrate_cuda3.migrate3(s, f, v, k, occ=o),
                          want))
            cases.append((lambda s=scode, f=planes, v=fills, o=occ: migrate_cuda3.migrate3(s, f, v, occ=o), False))
            cases.append((lambda s=ch, f=fh, v=fills, k=k_mov, o=occ: migrate_cuda3.migrate3_halo(s, f, v, k, occ=o),
                          want))
    assert {w for _, w in cases} == {True, False}
    side = torch.cuda.Stream(device=cuda_device)
    for stream in (torch.cuda.current_stream(cuda_device), side):
        with torch.cuda.stream(stream):
            flags = [run()[1] for run, _ in cases + cases[::-1]]
        stream.synchronize()
        assert [bool(f) for f in flags] == [w for _, w in cases + cases[::-1]]


def test_wrappers_reject_bad_cuda_inputs(cuda_device):
    md, gs = _advanced_state(cuda_device)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    with pytest.raises(ValueError, match="contiguous"):
        cell_cuda.grid_force(gs.xg.transpose(0, 2), gs.yg.transpose(0, 2), p)
    with pytest.raises(ValueError):
        cell_cuda.grid_force(gs.xg, gs.yg.cpu(), p)
    mdp, gsp = _advanced_state(cuda_device, 4)
    for bad in (None, gsp.counts.cpu(), gsp.counts.long(), gsp.counts[:-1]):
        with pytest.raises((TypeError, ValueError)):
            cell_cuda_packed.grid_force_packed(gsp.xg, gsp.yg, bad, p, 4)
    fields = torch.zeros((17,) + tuple(gs.xg.shape), device=cuda_device)
    scode = torch.full(tuple(gs.xg.shape), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        migrate_cuda.migrate(scode, fields, [0.0] * 17, occ=torch.zeros_like(gs.xg))
    md3, gs3 = _advanced_state3(cuda_device)
    p3 = cell_cuda3.CellForce3Params.from_grid(md3.grid_fn)
    with pytest.raises(ValueError, match="built for"):
        cell_cuda3.grid_force3(gs3.xg, gs3.yg, gs3.zg, p3, static_cov=12)
    with pytest.raises(ValueError):
        cell_cuda3.grid_force3(gs3.xg, gs3.yg, gs3.zg, p3, max_occ=gs3.max_occ.cpu())


def test_engine_on_card_matches_cpu(cuda_device):
    """The same equilibrate + production on the card (kernels B3, B2 on the
    packed layout) and on the CPU (plain versions): energies at rtol 1e-4
    (summation order)."""
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        s_eq, ovf_eq = lj_fluid.equilibrate(CFG, lj_fluid.init_state(CFG, device))
        _, (_, ke, pe), ovf = lj_fluid.production(CFG, s_eq)
        assert not bool(ovf_eq) and not bool(ovf)
        out[device.type] = (ke.cpu().double().numpy(), pe.cpu().double().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4)


def _melted_positions(device, n: int, dim: int):
    """Positions 100 dense steps from a lattice start (B8 on the card)."""
    cfg = override(MDConfig(), n=n, dim=dim, rho=0.8, init="lattice", eq_steps=100)
    return lj_fluid.equilibrate(cfg, lj_fluid.init_state(cfg, device))[0].position, cfg.box_size


@pytest.mark.parametrize("n,dim,periodic,cutoff", [(16384, 2, True, None), (4096, 2, True, 2.5),
                                                   (4096, 3, False, None), (3000, 3, True, 2.5)])
def test_pairwise_kernel_matches_plain(cuda_device, n, dim, periodic, cutoff):
    """B8 and its energy variant against the plain version: forces within
    1e-4 * max |f| (summation order), the energy sum at rtol 1e-5; two
    launches on one input bit-equal (no atomics)."""
    pos, box = _melted_positions(cuda_device, n, dim)
    p = pairwise_cuda.PairwiseParams(box=box if periodic else None, cutoff=cutoff)
    before = (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
        again = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
        want = pairwise_cuda.lj_force_pairwise_reference(pos, p, with_energy)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        fmax = float(want[0].abs().max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-4 * fmax
        if with_energy:
            np.testing.assert_allclose(float(got[1].double().sum()), float(want[1].double().sum()), rtol=1e-5)
    assert (pairwise_cuda.LAUNCHES, pairwise_cuda.ENERGY_LAUNCHES) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("n", [1, 2, 255, 257, 513, 1100])
def test_pairwise_kernel_ragged_geometry(cuda_device, n):
    """B8 where N is not a multiple of the 512-particle block and tile (a
    block's own tile cut short, one particle alone): forces within 1e-4 *
    max |f| of the plain version, the energy sum at rtol 1e-5, two launches
    bit-equal; 2D with a box and 3D without one."""
    rng = np.random.default_rng(n)
    for dim, periodic in ((2, True), (3, False)):
        # a jittered lattice of spacing 1.1, the first n sites
        per_side = int(np.ceil(n ** (1.0 / dim) - 1e-9))
        sites = np.stack(np.meshgrid(*([np.arange(per_side) * 1.1 + 0.55] * dim), indexing="ij"), -1)
        pos_np = sites.reshape(-1, dim)[:n] + 0.05 * rng.standard_normal((n, dim))
        pos = torch.from_numpy(pos_np.astype(np.float32)).to(cuda_device)
        p = pairwise_cuda.PairwiseParams(box=1.1 * per_side if periodic else None)
        for with_energy in (False, True):
            got = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
            again = pairwise_cuda.lj_force_pairwise(pos, p, with_energy)
            want = pairwise_cuda.lj_force_pairwise_reference(pos, p, with_energy)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            fmax = float(want[0].abs().max())
            assert float((got[0] - want[0]).abs().max()) <= 1e-4 * fmax
            if with_energy:
                np.testing.assert_allclose(float(got[1].double().sum()), float(want[1].double().sum()), rtol=1e-5)


def test_pairwise_energy_gradient_on_card(cuda_device):
    """The autograd energy launches the energy variant once; its gradient is
    -force from that launch, equal to the force kernel's output."""
    pos, box = _melted_positions(cuda_device, 4096, 2)
    energy = pairwise_cuda.make_lj_energy_pairwise(4096, box=box)
    x = pos.clone().requires_grad_(True)
    before = pairwise_cuda.ENERGY_LAUNCHES
    (grad,) = torch.autograd.grad(energy(x), x)
    assert pairwise_cuda.ENERGY_LAUNCHES == before + 1
    force = pairwise_cuda.make_lj_force_pairwise(4096, box=box)(pos)
    assert torch.equal(grad, -force)


def test_pairwise_wrapper_rejects_bad_cuda_inputs(cuda_device):
    p = pairwise_cuda.PairwiseParams()
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_cuda.lj_force_pairwise(torch.zeros((2, 64), device=cuda_device).t(), p)
    with pytest.raises(TypeError):
        pairwise_cuda.lj_force_pairwise(torch.zeros((64, 2), dtype=torch.float64, device=cuda_device), p)


@pytest.mark.parametrize("impl,cutoff", [("dense_pallas", None), ("neighbor", 2.5), ("cell", 2.5)])
def test_force_paths_on_card_match_cpu(cuda_device, impl, cutoff):
    """A dense or list path on the card against the same path on the CPU:
    energies at rtol 1e-4 (summation order), no overflow."""
    cfg = override(CFG, n=2048, cutoff=cutoff, force_impl=impl)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        s_eq, ovf_eq = lj_fluid.equilibrate(cfg, lj_fluid.init_state(cfg, device))
        _, (_, ke, pe), ovf = lj_fluid.production(cfg, s_eq)
        assert not bool(ovf_eq) and not bool(ovf)
        out[device.type] = (ke.cpu().double().numpy(), pe.cpu().double().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4)


def _bodies(device, n: int, dim: int, seed: int = 0):
    """Positions normal * 10 and masses 0.5 + U(0, 1), from a numpy seed."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.standard_normal((n, dim)) * 10.0).astype(np.float32)).to(device)
    return pos, torch.from_numpy((0.5 + rng.random(n)).astype(np.float32)).to(device)


@pytest.mark.parametrize("softening", [0.0, 0.1])
@pytest.mark.parametrize("n,dim", [(4096, 2), (4096, 3), (3001, 2), (1000, 3)])
def test_gravity_kernel_matches_plain(cuda_device, n, dim, softening):
    """B9 with and without the potential against its plain version: within
    1e-5 x max |.| (the FMAs' roundings and the summation order; the rsqrt
    is the plain version's), two launches bit-equal (no atomics); 3001 and
    1000 are not multiples of the 512-particle blocks and tiles, so the last
    row block and the last tile are ragged; at softening 0 the diagonal
    tiles' j == i select keeps every value finite."""
    pos, m = _bodies(cuda_device, n, dim, seed=n + dim)
    before = (pairwise_cuda.GRAVITY_LAUNCHES, pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES)
    for with_potential in (False, True):
        got = pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, softening, with_potential)
        again = pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, softening, with_potential)
        want = pairwise_cuda.gravity_accel_pairwise_reference(pos, m, 1.0, softening, with_potential)
        assert all(bool(torch.isfinite(a).all()) for a in got)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert (pairwise_cuda.GRAVITY_LAUNCHES, pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES) == (
        before[0] + 2, before[1] + 2)


def test_gravity_wrapper_rejects_bad_cuda_inputs(cuda_device):
    pos, m = _bodies(cuda_device, 64, 2)
    with pytest.raises(ValueError, match="masses on"):
        pairwise_cuda.gravity_accel_pairwise(pos, m.cpu())
    with pytest.raises(TypeError):
        pairwise_cuda.gravity_accel_pairwise(pos.double(), m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_kernel_bit_equal(cuda_device, dtype):
    """B10 bit-equal to its source, through make_bandwidth_op's truncation to
    whole chunks and on a length whose bytes are not a multiple of 16."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.ops import make_bandwidth_op

    src = torch.randn(3 * 4096 + 77, device=cuda_device).to(dtype)
    before = copy_cuda.COPY_LAUNCHES
    op = make_bandwidth_op(src.numel(), dtype=dtype, mode="pallas_copy", chunk=4096)
    out = op(src)
    assert op.n_elems == 3 * 4096 and torch.equal(out, src[: op.n_elems])
    odd = copy_cuda.chunked_copy(src[: 12 * 1001])
    assert odd.numel() == 12 * 1001 and torch.equal(odd, src[: odd.numel()])
    assert torch.equal(copy_cuda.chunked_copy(src), copy_cuda.copy_reference(src))
    assert copy_cuda.COPY_LAUNCHES == before + 3
    with pytest.raises(ValueError, match="aligned"):
        copy_cuda.chunked_copy(src[1:])
    # past the kernel's 16 KB blocks: 3 blocks, 1001 vectors and 4 bytes
    big = torch.randn((3 * 16384 + 16 * 1001 + 4) // src.element_size(), device=cuda_device).to(dtype)
    assert torch.equal(copy_cuda.chunked_copy(big), big)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_halo_kernels_2d_bit_equal_to_whole_grid(cuda_device, p):
    """B1 halo (both variants) and B2 halo over p row blocks (cps 24 at
    R = 1) against B1 and B2 on the whole grid, B2 halo also at overflow,
    the planes separate tensors, and each launch counted."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    md, gs = _advanced_state(cuda_device, rows_per_block=1)
    params = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    before = (cell_cuda.HALO_LAUNCHES, cell_cuda.HALO_ENERGY_LAUNCHES, migrate_cuda.HALO_LAUNCHES)
    for with_energy in (False, True):
        full = cell_cuda.grid_force(gs.xg, gs.yg, params, with_energy)
        parts = [cell_cuda.grid_force_halo(x, y, params, with_energy)
                 for x, y in zip(halo_blocks(gs.xg, p, md.box), halo_blocks(gs.yg, p))]
        assert all(torch.equal(torch.cat(q), f) for q, f in zip(zip(*parts), full))
    for scode, occ, planes, fills, _ in _b2_cases(md, gs):
        blocks = list(zip(*(halo_blocks(f, p) for f in planes)))
        got = torch.cat([migrate_cuda.migrate_halo(c, list(f), fills, occ=o)
                         for c, f, o in zip(halo_blocks(scode, p), blocks, occ.chunk(p))], 1)
        assert torch.equal(got, migrate_cuda.migrate(scode, planes, fills, occ=occ))
        assert torch.equal(got, migrate_cuda.migrate_reference(scode, torch.stack(planes), fills))
    assert (cell_cuda.HALO_LAUNCHES, cell_cuda.HALO_ENERGY_LAUNCHES, migrate_cuda.HALO_LAUNCHES) == (
        before[0] + p, before[1] + p, before[2] + 2 * p)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_halo_kernels_3d_bit_equal_to_whole_grid(cuda_device, p):
    """B4 halo (both variants), B5 halo and B6 halo over p x-row blocks (cps
    8) against the whole-grid kernels, the mover flag included."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks

    md, gs = _advanced_state3(cuda_device)
    params = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    blocks = list(zip(halo_blocks(gs.xg, p, md.box), halo_blocks(gs.yg, p), halo_blocks(gs.zg, p)))
    for kw in (dict(max_occ=gs.max_occ), dict(max_occ=gs.max_occ, with_energy=True), dict(static_cov=md.static_cov)):
        full = cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, params, **kw)
        parts = [cell_cuda3.grid_force3_halo(*b, params, **kw) for b in blocks]
        assert all(torch.equal(torch.cat(q), f) for q, f in zip(zip(*parts), full))
    _, _, _, scode, occ_new, _, _ = md._migration_dest(gs)
    fields = torch.stack([gs.xg, gs.yg, gs.zg, gs.pid.float()])
    fills = [md.sentinel, 0.0, 0.0, -1.0]
    fblocks = halo_blocks(fields, p, dim=1)
    for k_mov in (1, md.migrate_k_mov):
        full, flag = migrate_cuda3.migrate3(scode, fields, fills, k_mov=k_mov, occ=occ_new)
        outs = [migrate_cuda3.migrate3_halo(c, f, fills, k_mov=k_mov, occ=o)
                for c, f, o in zip(halo_blocks(scode, p), fblocks, occ_new.chunk(p))]
        assert torch.equal(torch.cat([o[0] for o in outs], 1), full)
        assert any(bool(o[1]) for o in outs) is bool(flag)


def test_sharded_engines_at_one_rank_match_unsharded(cuda_device):
    """``ShardedGridMD`` and ``ShardedGridMD3`` on the card with a mesh of
    one rank: 100 chunked steps (rebuilds included) launch the halo kernels
    and no whole-grid one, and 50 match the one-device engine at ``scaling._check_parity``'s
    tolerance."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh

    def whole_grid():
        return (cell_cuda.LAUNCHES, cell_cuda.LOOP_LAUNCHES, cell_cuda.HALO_LOOP_LAUNCHES, cell_cuda_packed.LAUNCHES,
                cell_cuda3.LAUNCHES, cell_cuda3.COUNTED_LAUNCHES, cell_cuda3.STATIC_LAUNCHES, migrate_cuda.LAUNCHES,
                migrate_cuda.PACKED_LAUNCHES, migrate_cuda3.LAUNCHES)

    def halo():
        return (cell_cuda.HALO_LAUNCHES + cell_cuda3.HALO_LAUNCHES + cell_cuda3.HALO_COUNTED_LAUNCHES,
                migrate_cuda.HALO_LAUNCHES + migrate_cuda3.HALO_LAUNCHES)

    for cfg, engine in ((CFG, ShardedGridMD), (CFG3, ShardedGridMD3)):
        plain = scaling._build_engine(cfg, 1, cuda_device)[0]
        sharded = engine(plain.grid_fn, make_mesh(device=cuda_device), dt=cfg.dt, compensated=cfg.compensated)
        k, gate = lj_fluid._grid_inner_steps(cfg, sharded)
        state = lj_fluid.init_state(cfg, cuda_device)
        before, halo_before = whole_grid(), halo()
        gs = sharded.init(state.position, state.velocity)
        chunk = sharded.make_chunk_step(k, gate_frac=gate)
        for _ in range(100 // k):
            gs = chunk(gs)
        torch.cuda.synchronize()
        assert whole_grid() == before
        assert all(a > b for a, b in zip(halo(), halo_before))
        ok, err = scaling.parity(cfg, sharded, state, 50, cuda_device)
        assert ok, err
