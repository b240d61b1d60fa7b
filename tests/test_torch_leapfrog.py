"""The NVE window's fused leapfrog pass (``ops/kernels/leapfrog_cuda.py``,
``csrc/leapfrog.cu``) against the eager window it replaced
(``tests/torch_window_eager.py``), slot for slot.

On the CPU: the wrapper's checks, the plain version's path (no launch)
and its bits, and the benchmark's reader of the launch counter. Marked
``cuda`` (skipped without a card): the kernel on the card, torch.equal to
the eager window in 2D (R = 1 and R = 7) and 3D, with and without Kahan
compensation, at 1, 4 and 7 steps; inputs untouched; a NaN displacement
trips the gate; Langevin windows launch nothing; the row-sharded engines
at one rank. Imports no jax. On the card:

    python -m pytest tests/test_torch_leapfrog.py --noconftest -q
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import leapfrog_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog

# pytest puts this directory on sys.path (the card may lack the conftest)
from torch_window_eager import assert_states_equal, eager_window  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_INNER = (1, 4, 7)

CFG2 = override(MDConfig(), n=512, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice")  # cps 8
CFG3 = override(CFG2, n=216, rho=0.125, dim=3)  # cps 4
CFG2_R7 = override(CFG2, n=16384)  # cps 49: packed R = 7 on the card


def _engine(cfg, device, compensated: bool, rows_per_block=1):
    gf = make_cell_grid_fn(cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, rho=cfg.rho,
                           skin=lj_fluid.resolve_skin(cfg, "grid"))
    if cfg.dim == 3:
        return GridMD3(gf, dt=cfg.dt, compensated=compensated, device=device)
    return GridMD(gf, dt=cfg.dt, compensated=compensated, rows_per_block=rows_per_block, device=device)


def _state(md, cfg, device):
    """A state 24 steps and a rebuild past its start: displacements,
    residuals and unwrapped coordinates all non-trivial."""
    s0 = lj_fluid.init_state(cfg, device)
    s = md.init(s0.position, s0.velocity)
    window = eager_window(md, md.force_kernel, 4)
    for k in range(6):
        s = window(s)
        if k == 3:
            s = md._rebuild_migrate(s)
    return s


def _launches():
    return leapfrog_cuda.STEP_LAUNCHES, leapfrog_cuda.CLOSE_LAUNCHES


# -- CPU ------------------------------------------------------------------------
def _planes(dim=2, shape=(2, 3, 4), dtype=torch.float32):
    return [torch.randn(shape, dtype=dtype) for _ in range(dim)]


def _bad_transposed():
    p = _planes(shape=(4, 4, 4))
    p[1] = p[1].transpose(0, 2)
    return p


BAD = {
    "device": (lambda: dict(pos=[torch.empty((2, 3, 4), device="meta")] * 2), ValueError),
    "plane_device": (lambda: dict(v=[torch.zeros(2, 3, 4), torch.empty((2, 3, 4), device="meta")]), ValueError),
    "dtype_int": (lambda: dict(pos=[torch.zeros((2, 3, 4), dtype=torch.int32)] * 2), TypeError),
    "dtype_mixed": (lambda: dict(disp=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, dtype=torch.float64)]), TypeError),
    "shape": (lambda: dict(v=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)]), ValueError),
    "contiguity": (lambda: dict(pos=_bad_transposed(), v=_planes(shape=(4, 4, 4)), disp=_planes(shape=(4, 4, 4))),
                   ValueError),
    "axes": (lambda: dict(v=_planes(dim=3)), ValueError),
    "one_residual": (lambda: dict(cr=_planes()), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_wrong_planes(case):
    make, err = BAD[case]
    kw = dict(v=_planes(), pos=_planes(), disp=_planes())
    kw.update(make())
    with pytest.raises(err):
        Leapfrog(**kw, dt=1e-3)


@pytest.mark.parametrize("case", ["force_shape", "force_dtype"])
def test_wrapper_rejects_wrong_calls(case):
    lf = Leapfrog(_planes(), _planes(), _planes(), dt=1e-3)
    with pytest.raises((ValueError, TypeError)):
        if case == "force_shape":
            lf.step(_planes(shape=(2, 3, 5)))
        else:
            lf.step(_planes(dtype=torch.float64))


def _pointers(planes):
    got = [p.data_ptr() for p in planes or ()]
    return got + [None] * (leapfrog_cuda._MAX_DIM - len(got))


@pytest.mark.parametrize("n", N_INNER)
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_launch_pointers_follow_the_window(dim, compensated, n):
    """Each launch's pointer array, built anew for a window's first three
    launches and patched at ``f`` after them, is the one the launch's
    fields give: ``f``, then each field's input and output planes. No
    output is a plane the window was given, and from the second launch on
    (the third for ``cv``) every field is updated in place."""
    res = dict(cr=_planes(dim), cv=_planes(dim)) if compensated else {}
    lf = Leapfrog(_planes(dim), _planes(dim), _planes(dim), **res, dt=1e-3)
    names = ("v", "pos", "cr", "cv", "disp")
    given = {p.data_ptr() for name in names for p in (getattr(lf, name) or ())}
    modes = [leapfrog_cuda._FIRST] + [leapfrog_cuda._STEP] * (n - 1) + [leapfrog_cuda._CLOSE]
    for i, mode in enumerate(modes):
        f = _planes(dim)
        ins = [_pointers(getattr(lf, name)) for name in names]
        got = list(lf._bind(mode, f))
        outs = [_pointers(getattr(lf, name)) for name in names]
        want = _pointers(f) + [p for pair in zip(ins, outs) for q in pair for p in q]
        assert got == want
        written = {p for name, o in zip(names, outs) if name != "cv" or i > 0 for p in o if p is not None}
        assert not written & given
        if i >= (2 if compensated else 1):
            assert ins == outs
        if mode != leapfrog_cuda._CLOSE:
            lf._steps += 1


def test_cpu_state_takes_the_plain_path():
    """A CPU state runs the plain version: no kernel launch is counted,
    whatever the window's length."""
    md = _engine(CFG2, "cpu", True)
    s = _state(md, CFG2, "cpu")
    before = _launches()
    for n in N_INNER:
        md._make_window(md.force_kernel, n)(s)
    assert _launches() == before


def _receding(md, s):
    """``s`` with each displacement moved 50 steps against its velocity,
    so that it shrinks through a window: the window's largest ``|disp|``
    is its starting one."""
    return s.replace(**{f"disp{a}": getattr(s, f"disp{a}") - 50 * md.dt * getattr(s, f"v{a}g") for a in md.AXES})


@pytest.mark.parametrize("start", ["run", "receding"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_window_matches_the_eager_window(dim, compensated, start):
    """On the CPU the refactored window gives the previous window's bits in
    every field it writes, at 1, 4 and 7 steps, also where the largest
    displacement is the window's first."""
    cfg = CFG2 if dim == 2 else CFG3
    md = _engine(cfg, "cpu", compensated)
    s = _state(md, cfg, "cpu")
    if start == "receding":
        s = _receding(md, s)
    for n in N_INNER:
        assert_states_equal(md, md._make_window(md.force_kernel, n)(s), eager_window(md, md.force_kernel, n)(s))


def _reader():
    path = ROOT / "port_bench" / "metrics" / "fused_step_pct.py"
    spec = importlib.util.spec_from_file_location("port_bench_metrics_fused_step_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, steps, counters):
        self.n, self.steps, self.counters = 1000, steps, counters


@pytest.mark.parametrize("steps,counters,want", [
    (2000, {"leapfrog_cuda.STEP_LAUNCHES": 2000, "leapfrog_cuda.CLOSE_LAUNCHES": 500}, 100.0),
    (2000, {"leapfrog_cuda.STEP_LAUNCHES": 500}, 25.0),
    (2000, {"migrate_cuda.PACKED_LAUNCHES": 74}, None),  # a program without the counter
    (0, {"leapfrog_cuda.STEP_LAUNCHES": 0}, None),
])
def test_fused_step_pct_reader(steps, counters, want):
    assert _reader()(_Run(steps, counters)) == want


# -- the card --------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tensors(s):
    return {k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)}


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("cfg,rows_per_block", [(CFG2, 1), (CFG2_R7, 7), (CFG3, None)], ids=["2d-r1", "2d-r7", "3d"])
def test_fused_window_bit_equal_to_eager(cuda_device, cfg, rows_per_block, compensated):
    """The kernel's window is torch.equal to the eager window in every
    field, ``dmax2``, ``overflow`` and ``time`` (also where the largest
    displacement is the window's first); it launches once a step and once a
    window, and writes nothing it was given."""
    md = _engine(cfg, cuda_device, compensated, rows_per_block)
    s = _state(md, cfg, cuda_device)
    force = md.force_kernel  # B1, B3, or in 3D B4 (static_cov None)
    for start in (s, _receding(md, s)):
        given = _tensors(start)
        for n in N_INNER:
            before = _launches()
            got = md._make_window(force, n)(start)
            torch.cuda.synchronize()
            assert _launches() == (before[0] + n, before[1] + 1)
            assert_states_equal(md, got, eager_window(md, force, n)(start))
        for k, v in given.items():
            assert torch.equal(getattr(start, k), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim,shape,offset", [(2, (3, 5, 7), 0), (3, (3, 5, 7), 0), (2, (4, 4, 8), 1)],
                         ids=["2d-odd", "3d-odd", "2d-unaligned"])
def test_kernel_matches_plain_on_any_planes(cuda_device, dim, shape, offset, compensated):
    """Planes the 16-byte path cannot take (a slot count not a multiple of
    4, or a start off 16 bytes) run slot by slot: 3 steps and the close on
    the card give the plain version's bits on the CPU."""
    gen = torch.Generator().manual_seed(11)
    n = torch.Size(shape).numel()

    def planes(scale):
        """``dim`` flat buffers; a plane is a buffer past ``offset`` slots."""
        return [torch.randn(n + offset, generator=gen) * scale for _ in range(dim)]

    def put(bufs, dev):
        return [b.to(dev)[offset:].view(shape) for b in bufs]

    fields = dict(v=planes(1.0), pos=planes(10.0), disp=planes(0.01))
    if compensated:
        fields.update(cr=planes(1e-7), cv=planes(1e-7))
    forces = [planes(50.0) for _ in range(4)]
    ends = []
    for dev in ("cpu", cuda_device):
        lf = Leapfrog(**{k: put(v, dev) for k, v in fields.items()}, dt=1e-3)
        for f in forces[:3]:
            lf.step(put(f, dev))
        lf.close(put(forces[3], dev))
        ends.append(lf)
    for name in ("v", "pos", "disp") + (("cr", "cv") if compensated else ()):
        for a, b in zip(getattr(ends[0], name), getattr(ends[1], name)):
            assert torch.equal(a, b.cpu()), name
    assert torch.equal(ends[0].dmax2, ends[1].dmax2.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG2, CFG3], ids=["2d", "3d"])
def test_fused_window_nan_trips_the_gate(cuda_device, cfg):
    md = _engine(cfg, cuda_device, True)
    s = _state(md, cfg, cuda_device)
    disp = s.dispy.clone()
    disp.view(-1)[disp.numel() // 3] = float("nan")
    s = s.replace(dispy=disp, dmax2=torch.zeros_like(s.dmax2))
    out = md._make_window(md.force_kernel, 4)(s)
    assert torch.isnan(out.dmax2) and bool(out.overflow)
    assert bool(md._needs_rebuild(out))
    assert torch.isnan(eager_window(md, md.force_kernel, 4)(s).dmax2)


@pytest.mark.cuda
def test_langevin_window_launches_no_fused_step(cuda_device):
    md = _engine(CFG2, cuda_device, True)
    s0 = lj_fluid.init_state(CFG2, cuda_device)
    s = md.init(s0.position, s0.velocity, seed=7)
    before = _launches()
    md._make_window(md.force_kernel, 4, (1.0, 1.0))(s)
    torch.cuda.synchronize()
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG2, CFG3], ids=["2d", "3d"])
def test_sharded_engine_at_one_rank_bit_equal(cuda_device, cfg):
    """The row-sharded engine at world size 1 with the fused window: a
    window torch.equal to the eager window on the same engine, and 100
    gated steps (windows and rebuilds) torch.equal to the unsharded
    engine's."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh

    plain = _engine(cfg, cuda_device, True)
    engine = ShardedGridMD3 if cfg.dim == 3 else ShardedGridMD
    sharded = engine(plain.grid_fn, make_mesh(device=cuda_device), dt=cfg.dt, compensated=True)
    s = _state(sharded, cfg, cuda_device)
    before = _launches()
    assert_states_equal(sharded, sharded._make_window(sharded.force_kernel, 4)(s),
                        eager_window(sharded, sharded.force_kernel, 4)(s))
    assert _launches()[0] == before[0] + 4
    s0 = lj_fluid.init_state(cfg, cuda_device)
    k, gate = lj_fluid._grid_inner_steps(cfg, plain)
    ends = [md.make_production_run(100 // k * k, k, gate_frac=gate)(md.init(s0.position, s0.velocity))
            for md in (plain, sharded)]
    assert_states_equal(plain, *ends)
    assert torch.equal(ends[0].pid, ends[1].pid)
