"""A1, the rebuild's allocation (``ops/kernels/alloc_cuda.py``,
``csrc/alloc.cu``), against its plain version, the eager allocation
(``alloc_cuda.allocation_reference``).

On the CPU: the wrapper's CPU route is the engine's allocation, output by
output, and launches nothing; a plain emulation of the three kernel passes
(``tests/torch_alloc_designs.emulate``) gives the plain version's bits in
2D at R = 1 and at a packed R = 7, in 3D at capacity 48 and 64, and on the
row-sharded engines at one rank, on states after a window, with every
particle moved up to 0.45 of a cell, and with the edge cases planted
(``torch_alloc_designs.planted``: a far mover, a cell over its capacity, a
coordinate on a cell face, one at ``box``, one at ``-skin/2``); the
wrapper's refusals; the benchmark's reader of the launch counter. Marked
``cuda`` (skipped without a card): the kernels torch.equal to the plain
version on the same engines and states, on both benchmark cells' states
after 1, 4 and 6 steps and planted, on the sharded engines at world size
1, the launch counter, the checked row extension, and the profiled kernel
names. Imports no jax. On the card:

    python -m pytest tests/test_torch_alloc.py --noconftest -q
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import alloc_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # port_bench is a directory of the checkout, not a package
    sys.path.insert(0, str(ROOT))

# pytest puts this directory on sys.path (the card may lack the conftest)
import torch_alloc_designs as designs  # noqa: E402

CFG2 = override(MDConfig(), n=512, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice")  # cps 8, cap 16
CFG2_R7 = override(CFG2, n=16384)  # cps 49, packed at R = 7
# in.lj's density, kT and step: cps 5, capacity 48 (N = 2800) and 64 (N = 4000)
CFG3 = override(CFG2, n=2800, rho=0.8442, dim=3, kt=1.44, dt=0.005)
CFG3_64 = override(CFG3, n=4000)
ENGINES = {"2d-r1": (CFG2, 1), "2d-r7": (CFG2_R7, 7), "3d-cap48": (CFG3, None), "3d-cap64": (CFG3_64, None),
           "2d-sharded": (CFG2, "sharded"), "3d-sharded": (CFG3, "sharded")}
CAPS = {"3d-cap48": 48, "3d-cap64": 64}


def _engine(name: str, device):
    cfg, r = ENGINES[name]
    gf = make_cell_grid_fn(cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, rho=cfg.rho,
                           skin=lj_fluid.resolve_skin(cfg, "grid"))
    if r == "sharded":
        from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md3_sharded import ShardedGridMD3
        from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.grid_md_sharded import ShardedGridMD
        from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import make_mesh

        engine = ShardedGridMD3 if cfg.dim == 3 else ShardedGridMD
        md = engine(gf, make_mesh(device=device), dt=cfg.dt, compensated=True)
    elif cfg.dim == 3:
        md = GridMD3(gf, dt=cfg.dt, compensated=True, device=device)
    else:
        md = GridMD(gf, dt=cfg.dt, compensated=True, rows_per_block=r, device=device)
    assert md.cap == CAPS.get(name, md.cap) and (r != 7 or md.rows_per_block == 7)
    return md, cfg


def _jiggled(md, s, seed: int = 3):
    """``s`` with every particle moved by up to 0.45 of a cell on each axis
    (unwrapped): movers of every class."""
    gen = torch.Generator().manual_seed(seed)
    cell = md.box / md.cps
    moved = {}
    for a in md.AXES:
        g = getattr(s, f"{a}g")
        step = (torch.rand(g.shape, generator=gen) * 0.9 - 0.45) * cell
        moved[f"{a}g"] = g + step.to(g.device) * s.occ
    return s.replace(**moved)


def _states(name: str, device) -> dict:
    """The engine ``name`` and its states: after a 4-step window from the
    lattice, with every particle moved, and with the edge cases planted."""
    md, cfg = _engine(name, device)
    s0 = lj_fluid.init_state(cfg, device)
    s = md._make_window(md.force_kernel, 4)(md.init(s0.position, s0.velocity))
    return md, {"window": s, "jiggled": _jiggled(md, s), "planted": designs.planted(md, s)}


@pytest.fixture(scope="module")
def cpu_states():
    return {name: _states(name, "cpu") for name in ENGINES}


def _args(md):
    return dict(cps=md.cps, box=md.box, rows_per_block=md.rows_per_block, row0=md._row0, row_ext=md._row_ext)


def _inputs(md, s):
    return [getattr(s, f"{a}g") for a in md.AXES], s.occ, s.overflow


# -- CPU ------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cpu_route_is_the_engine_allocation(cpu_states, name):
    """``alloc_cuda.allocate`` on CPU tensors is the plain version and the
    engine's ``_migration_dest``, output by output, and launches nothing."""
    md, states = cpu_states[name]
    for key, s in states.items():
        before = alloc_cuda.LAUNCHES
        got = alloc_cuda.allocate(*_inputs(md, s), **_args(md))
        assert alloc_cuda.LAUNCHES == before
        designs.assert_equal(got, md._migration_dest(s), f"{name} {key}: the engine")
        designs.assert_equal(got, designs.reference(md, s), f"{name} {key}: the plain version")


@pytest.mark.parametrize("state", ["window", "jiggled", "planted"])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_emulated_passes_match_the_plain_version(cpu_states, name, state):
    """The three passes, emulated in the grid's layout, give every output
    of the plain version; the planted state raises ``overflow`` (the far
    mover and the crowded cell) and the others do not."""
    md, states = cpu_states[name]
    s = states[state]
    want = designs.reference(md, s)
    designs.assert_equal(designs.emulate(*_inputs(md, s), **_args(md)), want, f"{name} {state}")
    assert bool(want[-2]) == (state == "planted")


@pytest.mark.parametrize("name", ["2d-r1", "3d-cap48"])
def test_planted_cases_each_raise_or_move(cpu_states, name):
    """Each planted case alone: the far mover and the crowded cell raise
    ``overflow``; the coordinate on a cell face, at ``box`` and at
    ``-skin/2`` do not, and the particles at ``box`` and at ``-skin/2``
    cross the periodic seam (+1 and -1 in x). The emulated passes give the
    plain version's bits each time."""
    md, states = cpu_states[name]
    s = states["window"]
    xs = 3 ** (len(md.AXES) - 1)  # classes a step of x
    raised = {}
    for case in designs.PLANTED:
        p = designs.planted(md, s, only=(case,))
        out = designs.reference(md, p)
        designs.assert_equal(designs.emulate(*_inputs(md, p), **_args(md)), out, f"{name} {case}")
        raised[case] = bool(out[-2])
        if case in ("box", "below"):
            (idx,) = torch.nonzero((p.xg != s.xg).reshape(-1)).squeeze(1)
            dx = torch.div(out[-4].reshape(-1)[idx], xs * md.cap, rounding_mode="floor") - 1
            assert int(dx) == (1 if case == "box" else -1), case
    assert raised == {"crowd": True, "far": True, "face": False, "box": False, "below": False}


def _planes(shape=(2, 4, 8), dtype=torch.float32, device="cpu"):
    return [torch.rand(shape, dtype=dtype, device=device) for _ in range(2)]


BAD = {
    "one_plane": (lambda: dict(pos=_planes()[:1]), ValueError),
    "four_planes": (lambda: dict(pos=_planes() * 2), ValueError),
    "device": (lambda: dict(pos=_planes(device="meta"), occ=torch.empty((2, 4, 8), device="meta")), ValueError),
    "plane_shape": (lambda: dict(occ=torch.ones(2, 4, 9)), ValueError),
    "dtype_int": (lambda: dict(pos=[torch.zeros((2, 4, 8), dtype=torch.int32)] * 2,
                               occ=torch.zeros((2, 4, 8), dtype=torch.int32)), TypeError),
    "dtype_mixed": (lambda: dict(occ=torch.ones((2, 4, 8), dtype=torch.float64)), TypeError),
    "contiguity": (lambda: dict(pos=[torch.rand(8, 4, 2).permute(2, 1, 0)] * 2), ValueError),
    "overflow": (lambda: dict(overflow=torch.zeros((), dtype=torch.int32)), ValueError),
    "overflow_shape": (lambda: dict(overflow=torch.zeros(1, dtype=torch.bool)), ValueError),
    "lanes": (lambda: dict(rows_per_block=2), ValueError),
    "rows": (lambda: dict(row0=7), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses(case):
    """A (2, 4, 8) grid is rows 0-1 of cps 8 in 2D; each case breaks one
    thing the wrapper checks."""
    make, err = BAD[case]
    kw = dict(pos=_planes(), occ=torch.ones(2, 4, 8), overflow=torch.zeros((), dtype=torch.bool), cps=8, box=8.0,
              rows_per_block=1, row0=0, row_ext=lambda t, dim: t)
    kw.update(make())
    with pytest.raises(err):
        alloc_cuda.allocate(kw.pop("pos"), kw.pop("occ"), kw.pop("overflow"), **kw)


def _reader():
    path = ROOT / "port_bench" / "metrics" / "alloc_kernel_pct.py"
    spec = importlib.util.spec_from_file_location("port_bench_metrics_alloc_kernel_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, counters):
        self.n, self.steps, self.counters = 1000, 200, counters


@pytest.mark.parametrize("counters,want", [
    ({"alloc_cuda.LAUNCHES": 34, "migrate_cuda3.LAUNCHES": 34}, 100.0),
    ({"alloc_cuda.LAUNCHES": 37, "migrate_cuda.PACKED_LAUNCHES": 74}, 50.0),
    ({"migrate_cuda3.LAUNCHES": 34}, None),  # a program without the counter
    ({"alloc_cuda.LAUNCHES": 0, "migrate_cuda.LAUNCHES": 0}, None),
])
def test_alloc_kernel_pct_reader(counters, want):
    assert _reader()(_Run(counters)) == want


# -- the card --------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_kernels_bit_equal_to_plain(cuda_device, name):
    """On the card the three passes give the plain version's bits (eager
    PyTorch on the same card) in every output, one launch counted an
    allocation, the inputs untouched."""
    md, states = _states(name, cuda_device)
    for key, s in states.items():
        given = [t.clone() for t in (*_inputs(md, s)[0], s.occ, s.overflow)]
        before = alloc_cuda.LAUNCHES
        got = md._migration_dest(s)
        torch.cuda.synchronize()
        assert alloc_cuda.LAUNCHES == before + 1
        designs.assert_equal(got, designs.reference(md, s), f"{name} {key}")
        assert bool(got[-2]) == (key == "planted")
        assert all(torch.equal(a, b) for a, b in zip((*_inputs(md, s)[0], s.occ, s.overflow), given))


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("lj2d-n1m", 4200000041), ("lj3d-inlj-2m", 4200000053)])
def test_kernels_bit_equal_on_the_benchmark_cells(cuda_device, name, seed):
    """At both benchmark cells' states: after 1, 4 and 6 steps of a window,
    and with the edge cases planted on each."""
    _, md, s0 = designs.cell_state(name, seed, cuda_device)
    flags = designs.check_states(md, s0, name)
    assert flags == [False] * len(designs.STEPS) + [True] * len(designs.STEPS)


@pytest.mark.cuda
def test_overflow_in_is_carried(cuda_device):
    """A state whose ``overflow`` is already raised keeps it."""
    md, states = _states("3d-cap48", cuda_device)
    s = states["window"].replace(overflow=torch.ones((), dtype=torch.bool, device=cuda_device))
    got = md._migration_dest(s)
    designs.assert_equal(got, designs.reference(md, s), "overflow in")
    assert bool(got[-2])


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["shape", "contiguity"])
def test_row_extension_is_checked(cuda_device, how):
    md, states = _states("2d-r1", cuda_device)
    s = states["window"]

    def bad(t, dim):
        out = md._row_ext(t, dim)
        return out[:, 1:] if how == "shape" else out.transpose(1, 2).contiguous().transpose(1, 2)

    with pytest.raises(ValueError):
        alloc_cuda.allocate(*_inputs(md, s), **{**_args(md), "row_ext": bad})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["2d-r7", "3d-cap48"])
def test_profiled_kernel_names(cuda_device, name):
    """One allocation on the card is the three kernels (and the flag's
    memset and the two row extensions' copies): named so that neither
    roofline reader of the benchmark takes them for its kernel, nor its
    count of PyTorch's own operations."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import device_op_count
    from port_bench import harness
    from port_bench.counts.timing import kernel_name

    md, states = _states(name, cuda_device)
    s = states["window"]
    md._migration_dest(s)
    ops = device_op_count(lambda: md._migration_dest(s))
    names = {kernel_name(k): v for k, v in ops.items()}
    d = len(md.AXES)
    ours = {f"alloc_{p}_kernel<{d}>" for p in ("classes", "bases", "codes")}
    assert all(names.get(k) == 1 for k in ours), names
    mods = {m: harness._module(ROOT / "port_bench" / "metrics" / f"{m}.py")
            for m in ("force_kernel_roofline", "rebuild_kernel_roofline", "torch_ops_us_per_step")}
    for k in ours:
        assert not mods["force_kernel_roofline"].KERNELS.match(k)
        assert not mods["rebuild_kernel_roofline"].KERNELS.match(k)
        assert not mods["torch_ops_us_per_step"].TORCH.search(k)
    assert sum(ops.values()) <= 8, names
