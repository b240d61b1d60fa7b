"""The Langevin window's fused BAOAB pass (``ops/kernels/baoab_cuda.py``,
``csrc/baoab.cu``) against the eager window it replaced
(``tests/torch_window_eager.eager_langevin_window``), slot for slot.

On the CPU: the wrapper's checks, each launch's pointer array, the plain
version's path (no launch) and its bits in 2D and 3D, with and without
Kahan positions, at 1, 4 and 7 steps from a state past a rebuild; inputs
untouched; a NaN displacement trips the gate; the benchmark's reader of
the launch counter. Marked ``cuda`` (skipped without a card): the kernel on
the card, torch.equal to the eager window with the same noise in 2D (R = 1
and packed R = 7 on B3's list form) and 3D, with and without Kahan
positions; one step launch a Langevin step and one closing launch a window;
odd and unaligned planes; NaN trips the gate; NVE windows launch none; the
row-sharded engines at one rank; the profiled kernel names. Imports no
jax. On the card:

    python -m pytest tests/test_torch_baoab.py --noconftest -q
"""

import importlib.util
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import baoab_cuda, leapfrog_cuda, noise_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.baoab_cuda import Baoab
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3

# pytest puts this directory on sys.path (the card may lack the conftest)
from torch_window_eager import assert_states_equal, eager_langevin_window, eager_window  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_INNER = (1, 4, 7)
THERMO = (1.0, 1.0)  # (gamma, kT): the benchmark cell's bath
SEED = 9_000_000_017  # above 32 bits: both key words used
COEF = dict(dt=1e-3, c1=0.999, c2=0.0447)

CFG2 = override(MDConfig(), n=512, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice")  # cps 8
CFG3 = override(CFG2, n=216, rho=0.125, dim=3)  # cps 4
CFG2_R7 = override(CFG2, n=16384)  # cps 49: packed R = 7 on the card, B3's list form


def _engine(cfg, device, compensated: bool, rows_per_block=1):
    gf = make_cell_grid_fn(cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, rho=cfg.rho,
                           skin=lj_fluid.resolve_skin(cfg, "grid"))
    if cfg.dim == 3:
        return GridMD3(gf, dt=cfg.dt, compensated=compensated, device=device)
    return GridMD(gf, dt=cfg.dt, compensated=compensated, rows_per_block=rows_per_block, device=device)


def _state(md, cfg, device):
    """A Langevin state 24 steps and a rebuild past its start, its global
    step past 2^32: displacements, residuals and unwrapped coordinates all
    non-trivial."""
    s0 = lj_fluid.init_state(cfg, device)
    s = md.init(s0.position, s0.velocity, seed=SEED, step=2**32 - 10)
    window = eager_langevin_window(md, md.force_kernel, 4, THERMO)
    for k in range(6):
        s = window(s)
        if k == 3:
            s = md._rebuild_migrate(s)
    return s


def _receding(md, s):
    """``s`` with each displacement moved 50 steps against its velocity,
    so that it shrinks through a window: the window's largest ``|disp|``
    is its starting one."""
    return s.replace(**{f"disp{a}": getattr(s, f"disp{a}") - 50 * md.dt * getattr(s, f"v{a}g") for a in md.AXES})


def _assert_windows_equal(md, got, want) -> None:
    """Every field a window writes, and the global step and steps since the
    binning it hands on."""
    assert_states_equal(md, got, want)
    assert got.rng_counter == want.rng_counter and got.since_binning == want.since_binning


def _launches():
    return baoab_cuda.STEP_LAUNCHES, baoab_cuda.CLOSE_LAUNCHES


def _tensors(s):
    return {k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)}


def _assert_untouched(s, given) -> None:
    for k, v in given.items():
        assert torch.equal(getattr(s, k), v), k


# -- CPU ------------------------------------------------------------------------
def _planes(dim=2, shape=(2, 3, 4), dtype=torch.float32):
    return [torch.randn(shape, dtype=dtype) for _ in range(dim)]


def _bad_transposed():
    p = _planes(shape=(4, 4, 4))
    p[1] = p[1].transpose(0, 2)
    return p


def _card_float64():
    """Planes on the card in float64, made under a fake tensor mode, so
    that the refusal is checked without a card."""
    with FakeTensorMode():
        return {k: [torch.zeros((2, 3, 4), dtype=torch.float64, device="cuda")] * 2 for k in ("v", "pos", "disp")}


BAD = {
    "device": (lambda: dict(pos=[torch.empty((2, 3, 4), device="meta")] * 2), ValueError),
    "plane_device": (lambda: dict(v=[torch.zeros(2, 3, 4), torch.empty((2, 3, 4), device="meta")]), ValueError),
    "dtype_int": (lambda: dict(pos=[torch.zeros((2, 3, 4), dtype=torch.int32)] * 2), TypeError),
    "dtype_mixed": (lambda: dict(disp=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, dtype=torch.float64)]), TypeError),
    "card_float64": (_card_float64, TypeError),
    "shape": (lambda: dict(v=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)]), ValueError),
    "contiguity": (lambda: dict(pos=_bad_transposed(), v=_planes(shape=(4, 4, 4)), disp=_planes(shape=(4, 4, 4))),
                   ValueError),
    "axes": (lambda: dict(v=_planes(dim=3)), ValueError),
    "one_axis": (lambda: dict(pos=_planes(dim=1), v=_planes(dim=1), disp=_planes(dim=1)), ValueError),
    "four_axes": (lambda: dict(pos=_planes(dim=4), v=_planes(dim=4), disp=_planes(dim=4)), ValueError),
    "residual_axes": (lambda: dict(cr=_planes(dim=3)), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_wrong_planes(case):
    make, err = BAD[case]
    kw = dict(v=_planes(), pos=_planes(), disp=_planes())
    kw.update(make())
    with pytest.raises(err):
        Baoab(**kw, **COEF)


CALLS = {
    "force_shape": lambda b: b.step(_planes(shape=(2, 3, 5)), _planes()),
    "force_dtype": lambda b: b.step(_planes(dtype=torch.float64), _planes()),
    "force_axes": lambda b: b.step(_planes(dim=3), _planes()),
    "noise_axes": lambda b: b.step(_planes(), _planes(dim=3)),
    "noise_shape": lambda b: b.step(_planes(), _planes(shape=(2, 3, 5))),
    "noise_dtype": lambda b: b.step(_planes(), _planes(dtype=torch.float64)),
    "close_shape": lambda b: b.close(_planes(shape=(2, 3, 5))),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_wrapper_rejects_wrong_calls(case):
    b = Baoab(_planes(), _planes(), _planes(), **COEF)
    with pytest.raises((ValueError, TypeError)):
        CALLS[case](b)


def _pointers(planes):
    got = [p.data_ptr() for p in planes or ()]
    return got + [None] * (baoab_cuda._MAX_DIM - len(got))


@pytest.mark.parametrize("n", N_INNER)
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_launch_pointers_follow_the_window(dim, compensated, n):
    """Each launch's pointer array, built anew for a window's first two
    launches and patched at ``f`` and ``xi`` after them, is the one the
    launch's fields give: ``f``, ``xi`` (none at the close of a one-step
    window, where the kernel reads none), then each field's input and
    output planes. No output is a plane the window was given, and from the
    second launch on every field is updated in place."""
    b = Baoab(_planes(dim), _planes(dim), _planes(dim), _planes(dim) if compensated else None, **COEF)
    names = ("v", "pos", "cr", "disp")
    given = {p.data_ptr() for name in names for p in (getattr(b, name) or ())}
    modes = [baoab_cuda._FIRST] + [baoab_cuda._STEP] * (n - 1) + [baoab_cuda._CLOSE]
    xi = None
    for i, mode in enumerate(modes):
        f = _planes(dim)
        if mode != baoab_cuda._CLOSE:
            xi = _planes(dim)
        elif i < 2:
            xi = None
        ins = [_pointers(getattr(b, name)) for name in names]
        got = list(b._bind(mode, f, None if mode == baoab_cuda._CLOSE else xi))
        outs = [_pointers(getattr(b, name)) for name in names]
        want = _pointers(f) + _pointers(xi) + [p for pair in zip(ins, outs) for q in pair for p in q]
        assert got == want
        written = {p for o in outs for p in o if p is not None}
        assert not written & given
        if i >= 1:
            assert ins == outs
        if mode != baoab_cuda._CLOSE:
            b._steps += 1


def test_cpu_state_takes_the_plain_path():
    """A CPU state runs the plain version: no kernel launch is counted,
    whatever the window's length."""
    md = _engine(CFG2, "cpu", True)
    s = _state(md, CFG2, "cpu")
    before = _launches()
    for n in N_INNER:
        md._make_window(md.force_kernel, n, THERMO)(s)
    assert _launches() == before


@pytest.mark.parametrize("start", ["run", "receding"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_window_matches_the_eager_window(dim, compensated, start):
    """On the CPU the engine's Langevin window gives the eager window's
    bits in every field it writes, ``dmax2`` and ``overflow`` included, at
    1, 4 and 7 steps from a state past a rebuild, also where the largest
    displacement is the window's first; it writes nothing it was given."""
    cfg = CFG2 if dim == 2 else CFG3
    md = _engine(cfg, "cpu", compensated)
    s = _state(md, cfg, "cpu")
    if start == "receding":
        s = _receding(md, s)
    given = _tensors(s)
    for n in N_INNER:
        _assert_windows_equal(md, md._make_window(md.force_kernel, n, THERMO)(s),
                              eager_langevin_window(md, md.force_kernel, n, THERMO)(s))
    _assert_untouched(s, given)


@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_pass_matches_the_eager_ops_on_any_planes(dim, compensated):
    """The plain version alone, 3 steps and the close on random planes,
    against the eager window's ops written out: the same bits, its inputs
    untouched."""
    gen = torch.Generator().manual_seed(23)

    def planes(scale):
        return [torch.randn((3, 5, 7), generator=gen) * scale for _ in range(dim)]

    v, pos, disp, cr = planes(1.0), planes(10.0), planes(0.01), planes(1e-7)
    forces, noise = [planes(50.0) for _ in range(4)], [planes(1.0) for _ in range(3)]
    given = [t.clone() for t in v + pos + disp + cr]
    b = Baoab(v, pos, disp, cr if compensated else None, **COEF)
    for f, xi in zip(forces, noise):
        b.step(f, xi)
    b.close(forces[3])
    assert all(torch.equal(a, t) for a, t in zip(v + pos + disp + cr, given))

    dt, c1, c2 = COEF["dt"], COEF["c1"], COEF["c2"]
    vh = [a + 0.5 * dt * fa for a, fa in zip(v, forces[0])]
    p, c, d = list(pos), list(cr), list(disp)
    dm = leapfrog_cuda.sumsq(d)
    for i in range(3):
        vp = [c1 * a + c2 * x for a, x in zip(vh, noise[i])]
        inc = [0.5 * dt * (a + q) for a, q in zip(vh, vp)]
        vh = vp
        for k in range(dim):
            if compensated:
                p[k], c[k] = leapfrog_cuda.kadd(p[k], c[k], inc[k])
            else:
                p[k] = p[k] + inc[k]
            d[k] = d[k] + inc[k]
        dm = torch.maximum(dm, leapfrog_cuda.sumsq(d))
        vh = [a + dt * fa for a, fa in zip(vh, forces[i + 1])]
    want_v = [a - 0.5 * dt * fa for a, fa in zip(vh, forces[3])]
    for got, want in ((b.v, want_v), (b.pos, p), (b.disp, d)) + (((b.cr, c),) if compensated else ()):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(b.dmax2, torch.max(dm))


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_window_nan_trips_the_gate(dim):
    """A NaN displacement leaves the window's ``dmax2`` NaN: the skin flag
    and the gate trip, as in the eager window."""
    cfg = CFG2 if dim == 2 else CFG3
    md = _engine(cfg, "cpu", True)
    s = _state(md, cfg, "cpu")
    disp = s.dispy.clone()
    disp.view(-1)[disp.numel() // 3] = float("nan")
    s = s.replace(dispy=disp, dmax2=torch.zeros_like(s.dmax2))
    out = md._make_window(md.force_kernel, 4, THERMO)(s)
    assert torch.isnan(out.dmax2) and bool(out.overflow)
    assert bool(md._needs_rebuild(out))
    assert torch.isnan(eager_langevin_window(md, md.force_kernel, 4, THERMO)(s).dmax2)


def _reader():
    path = ROOT / "port_bench" / "metrics" / "baoab_step_pct.py"
    spec = importlib.util.spec_from_file_location("port_bench_metrics_baoab_step_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, steps, counters):
        self.n, self.steps, self.counters = 1000, steps, counters


@pytest.mark.parametrize("steps,counters,want", [
    (2000, {"baoab_cuda.STEP_LAUNCHES": 2000, "baoab_cuda.CLOSE_LAUNCHES": 500}, 100.0),
    (2000, {"baoab_cuda.STEP_LAUNCHES": 500}, 25.0),
    (2000, {"leapfrog_cuda.STEP_LAUNCHES": 2000}, None),  # a program without the counter
    (0, {"baoab_cuda.STEP_LAUNCHES": 0}, None),
])
def test_baoab_step_pct_reader(steps, counters, want):
    assert _reader()(_Run(steps, counters)) == want


# -- the card --------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("cfg,rows_per_block", [(CFG2, 1), (CFG2_R7, 7), (CFG3, None)], ids=["2d-r1", "2d-r7", "3d"])
def test_fused_window_bit_equal_to_eager(cuda_device, cfg, rows_per_block, compensated):
    """The kernel's window, on the force kernel the engine's windows run
    (B3's list form at R = 7), is torch.equal to the eager window with the
    same noise in every field, ``dmax2``, ``overflow`` and ``time`` (also
    where the largest displacement is the window's first); it launches once
    a step and once a window beside one noise launch a step, and writes
    nothing it was given."""
    md = _engine(cfg, cuda_device, compensated, rows_per_block)
    s = _state(md, cfg, cuda_device)
    if rows_per_block == 7:
        s = md._rebuild_migrate(s)
        s = md._window_for(s, 4, THERMO)(s)  # builds the binning's list
        assert s.plist is not None
        force = md._list_force(s.plist, None)
    else:
        force = md.force_kernel  # B1, or in 3D B4 (static_cov None)
    for start in (s, _receding(md, s)):
        given = _tensors(start)
        for n in N_INNER:
            before, noise_before = _launches(), noise_cuda.LAUNCHES
            got = md._make_window(force, n, THERMO)(start)
            torch.cuda.synchronize()
            assert _launches() == (before[0] + n, before[1] + 1)
            assert noise_cuda.LAUNCHES == noise_before + n
            _assert_windows_equal(md, got, eager_langevin_window(md, force, n, THERMO)(start))
        _assert_untouched(start, given)


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
        fields.update(cr=planes(1e-7))
    forces, noise = [planes(50.0) for _ in range(4)], [planes(1.0) for _ in range(3)]
    ends = []
    for dev in ("cpu", cuda_device):
        b = Baoab(**{k: put(v, dev) for k, v in fields.items()}, **COEF)
        for f, xi in zip(forces[:3], noise):
            b.step(put(f, dev), put(xi, dev))
        b.close(put(forces[3], dev))
        ends.append(b)
    for name in ("v", "pos", "disp") + (("cr",) if compensated else ()):
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
    out = md._make_window(md.force_kernel, 4, THERMO)(s)
    assert torch.isnan(out.dmax2) and bool(out.overflow)
    assert bool(md._needs_rebuild(out))
    assert torch.isnan(eager_langevin_window(md, md.force_kernel, 4, THERMO)(s).dmax2)


@pytest.mark.cuda
def test_nve_window_launches_no_baoab_step(cuda_device):
    md = _engine(CFG2, cuda_device, True)
    s = _state(md, CFG2, cuda_device)
    before = _launches()
    assert_states_equal(md, md._make_window(md.force_kernel, 4)(s), eager_window(md, md.force_kernel, 4)(s))
    torch.cuda.synchronize()
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG2, CFG3], ids=["2d", "3d"])
def test_sharded_engine_at_one_rank_bit_equal(cuda_device, cfg):
    """The row-sharded engine at world size 1 with the fused window: a
    Langevin window torch.equal to the eager window on the same engine,
    and 100 gated Langevin steps (windows and rebuilds) torch.equal to the
    unsharded engine's."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh

    plain = _engine(cfg, cuda_device, True)
    engine = ShardedGridMD3 if cfg.dim == 3 else ShardedGridMD
    sharded = engine(plain.grid_fn, make_mesh(device=cuda_device), dt=cfg.dt, compensated=True)
    s = _state(sharded, cfg, cuda_device)
    before = _launches()
    _assert_windows_equal(sharded, sharded._make_window(sharded.force_kernel, 4, THERMO)(s),
                          eager_langevin_window(sharded, sharded.force_kernel, 4, THERMO)(s))
    assert _launches() == (before[0] + 4, before[1] + 1)
    s0 = lj_fluid.init_state(cfg, cuda_device)
    k, gate = lj_fluid._grid_inner_steps(cfg, plain)
    ends = [md.make_production_run(100 // k * k, k, gate_frac=gate, thermostat=THERMO)(
        md.init(s0.position, s0.velocity, seed=SEED)) for md in (plain, sharded)]
    assert_states_equal(plain, *ends)
    assert torch.equal(ends[0].pid, ends[1].pid)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG2, CFG3], ids=["2d", "3d"])
def test_profiled_kernel_names(cuda_device, cfg):
    """A 4-step Langevin window on the card is 4 noise launches, 4 step
    launches and one close of ``baoab_kernel<...>`` (beside the force
    kernel, the scalar's memset and the gate's few ops, at most 8 device
    operations a step), named so that no roofline reader of the benchmark
    takes them for its kernel."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import device_op_count
    from port_bench import harness
    from port_bench.counts.timing import kernel_name

    md = _engine(cfg, cuda_device, True)
    s = _state(md, cfg, cuda_device)
    window = md._make_window(md.force_kernel, 4, THERMO)
    window(s)
    names = {}
    for k, v in device_op_count(lambda: window(s)).items():
        names[kernel_name(k)] = names.get(kernel_name(k), 0) + v
    d = len(md.AXES)
    ours = {f"baoab_kernel<{d}, true, {mode}, 4>": 1 if mode != 1 else 3 for mode in (0, 1, 2)}
    assert all(names.get(k) == v for k, v in ours.items()), names
    assert names.get(f"langevin_noise_kernel<{d}>") == 4, names
    mods = {m: harness._module(ROOT / "port_bench" / "metrics" / f"{m}.py")
            for m in ("force_kernel_roofline", "rebuild_kernel_roofline", "noise_kernel_roofline",
                      "torch_ops_us_per_step")}
    for k in ours:
        assert not mods["force_kernel_roofline"].KERNELS.match(k)
        assert not mods["rebuild_kernel_roofline"].KERNELS.match(k)
        assert not mods["noise_kernel_roofline"].KERNEL.match(k)
        assert not mods["torch_ops_us_per_step"].TORCH.search(k)
    assert sum(names.values()) <= 8 * 4, names  # the eager window: ~30 a step
