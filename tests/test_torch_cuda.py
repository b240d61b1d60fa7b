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


def _advanced_state3(device):
    """A 3D grid state 5 steps after a rebuild: coordinates unwrapped."""
    md = lj_fluid._make_grid_md(CFG3, device)
    s0 = lj_fluid.init_state(CFG3, device)
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


def test_migrate_kernel_bit_equal(cuda_device):
    md, gs = _advanced_state(cuda_device)
    _, _, scode, _, _ = md._migration_dest(gs)
    fields = torch.stack([gs.xg, gs.yg, gs.vxg, gs.vyg, gs.pid.float()])
    fills = [md.sentinel, 0.0, 0.0, 0.0, -1.0]
    before = migrate_cuda.LAUNCHES
    got = migrate_cuda.migrate(scode, fields, fills)
    assert torch.equal(got, migrate_cuda.migrate_reference(scode, fields, fills))
    assert migrate_cuda.LAUNCHES == before + 1


@pytest.mark.parametrize("rows_per_block", [4, 24])  # G = 6 and 1
def test_cell_force_packed_kernel_matches_plain(cuda_device, rows_per_block):
    """B3 (both variants) against its plain version: forces at atol 1e-4 on
    occupied slots (summation order), exact zeros elsewhere, e and w sums
    at rtol 1e-5; two launches bit-equal (no atomics)."""
    md, gs = _advanced_state(cuda_device, rows_per_block)
    assert tuple(gs.xg.shape) == (24 // rows_per_block, md.cap, 24 * rows_per_block)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    occ = gs.occ > 0.5
    before = (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES)
    for with_energy in (False, True):
        got = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, p, rows_per_block, with_energy)
        again = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, p, rows_per_block, with_energy)
        want = cell_cuda_packed.grid_force_packed_reference(gs.xg, gs.yg, p, rows_per_block, with_energy)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got[:2], want[:2]):
            assert float((a - b)[occ].abs().max()) <= 1e-4
            assert bool((a[~occ] == 0).all())
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_allclose(float(a.double().sum()), float(b.double().sum()), rtol=1e-5)
    assert (cell_cuda_packed.LAUNCHES, cell_cuda_packed.ENERGY_LAUNCHES) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("rows_per_block", [4, 24])
def test_migrate_packed_kernel_bit_equal(cuda_device, rows_per_block):
    md, gs = _advanced_state(cuda_device, rows_per_block)
    _, _, scode, _, _ = md._migration_dest(gs)
    fields = torch.stack([gs.xg, gs.yg, gs.vxg, gs.vyg, gs.pid.float()])
    fills = [md.sentinel, 0.0, 0.0, 0.0, -1.0]
    before = (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES)
    got = migrate_cuda.migrate(scode, fields, fills, rows_per_block)
    assert torch.equal(got, migrate_cuda.migrate_reference(scode, fields, fills, rows_per_block))
    assert (migrate_cuda.LAUNCHES, migrate_cuda.PACKED_LAUNCHES) == (before[0], before[1] + 1)


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
    before = (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.STATIC_LAUNCHES)
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
    assert (cell_cuda3.LAUNCHES, cell_cuda3.ENERGY_LAUNCHES, cell_cuda3.STATIC_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


def test_migrate3_kernels_bit_equal(cuda_device):
    """B6 and B7 (one scatter) bit-equal to the plain version, with the
    same mover flag as on the CPU."""
    md, gs = _advanced_state3(cuda_device)
    _, _, _, scode, _, _ = md._migration_dest3(gs)
    fields = torch.stack([gs.xg, gs.yg, gs.zg, gs.vxg, gs.pid.float()])
    fills = [md.sentinel, 0.0, 0.0, 0.0, -1.0]
    before = (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES)
    want = migrate_cuda3.migrate3_reference(scode, fields, fills)
    for k_mov in (8, None):
        got, mov_of = migrate_cuda3.migrate3(scode, fields, fills, k_mov=k_mov)
        assert torch.equal(got, want)
        _, mov_of_cpu = migrate_cuda3.migrate3(scode.cpu(), fields.cpu(), fills, k_mov=k_mov)
        assert bool(mov_of) == bool(mov_of_cpu)
    assert (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_wrappers_reject_bad_cuda_inputs(cuda_device):
    md, gs = _advanced_state(cuda_device)
    p = cell_cuda.CellForceParams.from_grid(md.grid_fn)
    with pytest.raises(ValueError, match="contiguous"):
        cell_cuda.grid_force(gs.xg.transpose(0, 2), gs.yg.transpose(0, 2), p)
    with pytest.raises(ValueError):
        cell_cuda.grid_force(gs.xg, gs.yg.cpu(), p)
    fields = torch.zeros((17,) + tuple(gs.xg.shape), device=cuda_device)
    scode = torch.full(tuple(gs.xg.shape), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        migrate_cuda.migrate(scode, fields, [0.0] * 17)
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


@pytest.mark.parametrize("n,dim", [(4096, 2), (4096, 3), (3001, 2), (1000, 3)])
def test_gravity_kernel_matches_plain(cuda_device, n, dim):
    """B9 with and without the potential against its plain version: within
    1e-5 x max |.| (rsqrtf's 2 ulp and the summation order), two launches
    bit-equal (no atomics); 3001 and 1000 leave a ragged last tile."""
    pos, m = _bodies(cuda_device, n, dim, seed=n + dim)
    before = (pairwise_cuda.GRAVITY_LAUNCHES, pairwise_cuda.GRAVITY_POTENTIAL_LAUNCHES)
    for with_potential in (False, True):
        got = pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, 0.1, with_potential)
        again = pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, 0.1, with_potential)
        want = pairwise_cuda.gravity_accel_pairwise_reference(pos, m, 1.0, 0.1, with_potential)
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
