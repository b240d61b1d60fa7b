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
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda, migrate_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


CFG = override(MDConfig(), n=4096, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice",
               eq_steps=100, prod_steps=100, sample_every=50)


def _advanced_state(device):
    """A grid state 20 steps after a rebuild: coordinates unwrapped."""
    md = lj_fluid._make_grid_md(CFG, device)
    s0 = lj_fluid.init_state(CFG, device)
    gs = md.make_production_run(200, 5, gate_frac=0.35)(md.init(s0.position, s0.velocity))
    return md, md._make_window(md.force_kernel, 20)(gs)


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


def test_engine_on_card_matches_cpu(cuda_device):
    """The same equilibrate + production on the card (kernels) and on the
    CPU (plain versions): energies at rtol 1e-4 (summation order)."""
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        s_eq, ovf_eq = lj_fluid.equilibrate(CFG, lj_fluid.init_state(CFG, device))
        _, (_, ke, pe), ovf = lj_fluid.production(CFG, s_eq)
        assert not bool(ovf_eq) and not bool(ovf)
        out[device.type] = (ke.cpu().double().numpy(), pe.cpu().double().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4)
