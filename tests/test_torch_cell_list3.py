"""The partner list of the 3D grid engine and the list form of the counted
kernel (``cell_cuda3.build_partner_list3``, ``grid_force3(..., plist=)``).

On the CPU: the list's plain version holds every pair within its radius in
the counted loop's order, keeps a pair whose partners then close in by
just under skin/2 each, marks and counts the targets over its capacity,
and the forces summed from it are ``grid_force3_reference``'s bits across
the engine's windows. On the card (``-m cuda``; skipped without one): the
build kernel against its plain version, and the list form against the
counted kernel at LAMMPS in.lj's 2,048,000 atoms, step by step, at B5 and
B4, with targets forced full, over a whole 200-step block, and under its
profiled name. This file imports no jax, so on the card:

    python -m pytest tests/test_torch_cell_list3.py --noconftest -q
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from port_bench.counts import lattice

# LAMMPS in.lj's density, temperature and step, at 4000 atoms (10 fcc cells
# a side: 5 grid cells, capacity 64, B5 bound 48)
INLJ = override(MDConfig(), n=4000, dim=3, rho=0.8442, kt=1.44, dt=0.005, cutoff=2.5, force_impl="grid",
                compensated=True, eq_steps=0, prod_steps=100, sample_every=100)
GRIDS = ("xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "crx", "cvz", "pid", "occ")


def _engine(cfg, device, **kw):
    gf = lj_fluid._make_grid_md(cfg, device).grid_fn
    return GridMD3(gf, dt=cfg.dt, compensated=cfg.compensated, static_cov="auto", device=device, **kw)


def _fcc(cfg, device, seed=5):
    gen = torch.Generator(device=device).manual_seed(seed)
    pos, vel, _ = lattice.fcc_lattice(cfg.n, cfg.rho, cfg.kt, gen)
    return pos.to(device), vel.to(device)


@pytest.fixture(scope="module")
def melt():
    """The engine (list off) and its state 24 steps into the in.lj melt,
    just rebuilt: coordinates wrapped, the binning fresh."""
    md = _engine(INLJ, "cpu")
    gs = md.make_production_run_fixed(24, 6)(md.init(*_fcc(INLJ, "cpu")))
    return md, md._rebuild_migrate(gs)


def _decoded(plist, occ):
    """Per occupied target (flat ``(c, bound, c, c)`` index), its entries
    as ``(offset, slot)`` pairs in list order, and its count."""
    c, bound = occ.shape[0], occ.shape[1]
    flat, place = cell_cuda3._list_targets(occ, plist.strip, plist.stride)
    counts = plist.counts.reshape(-1)[place]
    ent = plist.entries.reshape(-1, plist.k)[place]
    out = {}
    for i, f in enumerate(flat.tolist()):
        n = int(counts[i])
        cz = f % c
        e = ent[i, :n]
        cell, b = e >> cell_cuda3.LIST_SLOT_BITS, e & 127
        o = (cell // (plist.strip + 2)) * 3 + cell % (plist.strip + 2) - cz % plist.strip
        out[f] = (list(zip(o.tolist(), b.tolist())), n)
    return out


def _partner_pid(md, gs, f, o, b, bound):
    """The particle id in slot ``b`` of target ``f``'s neighbour cell at
    offset ``o``."""
    c = md.cps
    cx, _, cy, cz = (f // (bound * c * c), 0, (f // c) % c, f % c)
    dx, dy, dz = o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1
    return int(gs.pid.view(c, md.cap, c, c)[(cx + dx) % c, b, (cy + dy) % c, (cz + dz) % c])


def test_list_holds_every_pair_within_radius_in_loop_order(melt):
    md, gs = melt
    p = cell_cuda3.CellForce3Params.from_grid(md.grid_fn)
    cov = md.static_cov
    assert int(gs.max_occ) <= cov
    plist, full = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, md.list_r2, md.list_cap, static_cov=cov)
    assert int(full) == 0
    c = md.cps
    occ = gs.xg.view(c, md.cap, c, c)[:, :cov] != p.sentinel
    pid_t = gs.pid.view(c, md.cap, c, c)[:, :cov].reshape(-1)
    lists = _decoded(plist, occ)
    assert len(lists) == md.n
    # every pair by the minimum image in float64, from the binned positions
    pos = md.positions(gs).double()
    d = pos[:, None] - pos[None]
    d -= md.box * torch.round(d / md.box)
    r = d.pow(2).sum(-1).sqrt()
    r.fill_diagonal_(math.inf)
    r_list = math.sqrt(md.list_r2)
    for f, (entries, n) in lists.items():
        assert entries == sorted(entries) and len(set(entries)) == n, "not in the counted loop's order"
        i = int(pid_t[f])
        got = {_partner_pid(md, gs, f, o, b, cov) for o, b in entries}
        assert len(got) == n and i not in got
        assert set(torch.nonzero(r[i] < r_list - 1e-3).squeeze(1).tolist()) <= got
        assert got <= set(torch.nonzero(r[i] < r_list + 1e-3).squeeze(1).tolist())
    # the mean partners near the capacity rule's mean, and no target near
    # its margin
    n = torch.tensor([v[1] for v in lists.values()], dtype=torch.float64)
    m = md.n / md.box**3 * 4.0 / 3.0 * math.pi * r_list**3
    assert abs(float(n.mean()) / m - 1.0) < 0.05 and int(n.max()) < md.list_cap


def test_planted_pair_closing_by_half_skin_is_listed():
    """Two particles just inside cutoff + skin, each moved just under
    skin/2 toward the other after the list is built: they end inside the
    cutoff, the pair is on the list and the list form gives the counted
    loop's bits; a list whose radius leaves the pair out does not."""
    cfg = override(INLJ, n=1000, rho=0.1, kt=1.0)
    md = _engine(cfg, "cpu", partner_list=True)
    gen = torch.Generator().manual_seed(11)
    pos = torch.rand((cfg.n, 3), generator=gen, dtype=torch.float32) * md.box
    rc, skin = cfg.cutoff, md.skin
    delta = 1e-4
    pos[0] = torch.tensor([0.5, 0.5, 0.5]) * md.box
    pos[1] = pos[0] + torch.tensor([rc + skin - delta, 0.0, 0.0])
    gs = md.init(pos, torch.zeros_like(pos))
    p = md._params
    cov = md.static_cov if int(gs.max_occ) <= md.static_cov else None
    plist, _ = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, md.list_r2, md.list_cap, gs.max_occ, cov)
    short, _ = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, (rc + skin - 2 * delta) ** 2, md.list_cap,
                                              gs.max_occ, cov)
    step = skin / 2 - delta / 4
    xg = gs.xg.clone()
    i0, i1 = (torch.nonzero(gs.pid.reshape(-1) == k).item() for k in (0, 1))
    xg.view(-1)[i0] += step
    xg.view(-1)[i1] -= step
    gap = float(xg.view(-1)[i1] - xg.view(-1)[i0])
    assert gap ** 2 < p.cutoff2
    want = cell_cuda3.grid_force3(xg, gs.yg, gs.zg, p, gs.max_occ, static_cov=cov)
    got = cell_cuda3.grid_force3(xg, gs.yg, gs.zg, p, gs.max_occ, static_cov=cov, plist=plist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want[0].view(-1)[i0]) != 0.0
    missed = cell_cuda3.grid_force3(xg, gs.yg, gs.zg, p, gs.max_occ, static_cov=cov, plist=short)
    assert not torch.equal(missed[0], want[0])


def test_small_capacity_marks_full_and_counts(melt):
    md, gs = melt
    cov = md.static_cov
    k = 128  # below the largest list (~135 partners a target on average)
    plist, full = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, k, static_cov=cov,
                                                 full=torch.tensor(7, dtype=torch.int32))
    n_full = int((plist.counts == cell_cuda3.LIST_FULL).sum())
    assert 0 < n_full < md.n and int(full) == 7 + n_full
    want = cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, md._params, static_cov=cov)
    got = cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, md._params, static_cov=cov, plist=plist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the engine counts them in list_overflows and runs the same steps
    on = _engine(INLJ, "cpu", partner_list=True)
    on.list_cap = k
    a = on.make_production_run_fixed(12, 6)(gs)
    b = md.make_production_run_fixed(12, 6)(gs)
    assert int(a.list_overflows) > 0 and int(b.list_overflows) == 0
    assert all(torch.equal(getattr(a, g), getattr(b, g)) for g in GRIDS)


@pytest.mark.parametrize("static", [True, False], ids=["B5", "B4"])
def test_list_force_bit_equal_across_six_step_window(melt, static):
    """Each of windows of 2 to 6 steps from the rebuilt state, and two
    whole cadence-6 blocks, with the list on and off: every grid equal."""
    md, gs = melt
    kw = {} if static else dict(static_cov=None)
    gf = md.grid_fn
    on = GridMD3(gf, dt=INLJ.dt, compensated=True, device="cpu", partner_list=True, **{"static_cov": "auto", **kw})
    off = GridMD3(gf, dt=INLJ.dt, compensated=True, device="cpu", **{"static_cov": "auto", **kw})
    for n in range(2, 7):
        a, b = on._window_for(gs, n)(gs), off._window_for(gs, n)(gs)
        assert a.plist is not None and b.plist is None and a.since_binning == n
        assert all(torch.equal(getattr(a, g), getattr(b, g)) for g in GRIDS), n
    a = on.make_production_run_fixed(12, 6)(gs)
    b = off.make_production_run_fixed(12, 6)(gs)
    assert all(torch.equal(getattr(a, g), getattr(b, g)) for g in GRIDS)
    assert int(a.list_overflows) == 0


def test_window_uses_list_only_where_it_holds(melt):
    """One-step windows build no list; a list is built only on a state
    fresh from its binning and serves at most ``LIST_STEPS`` steps; a
    rebuild drops it."""
    md, gs = melt
    on = _engine(INLJ, "cpu", partner_list=True)
    one = on._window_for(gs, 1)(gs)
    assert one.plist is None and one.since_binning == 1
    assert on._window_for(one, 2)(one).plist is None  # moved since the binning
    two = on._window_for(gs, 2)(gs)
    assert two.plist is not None
    late = two.replace(since_binning=cell_cuda3.LIST_STEPS - 1)
    calls = cell_cuda3.grid_force3_list_reference
    seen = []
    cell_cuda3.grid_force3_list_reference = lambda *a, **k: seen.append(1) or calls(*a, **k)
    try:
        on._window_for(late, 2)(late)
        assert not seen
        on._window_for(two, 2)(two)
        assert len(seen) == 2
    finally:
        cell_cuda3.grid_force3_list_reference = calls
    assert on._rebuild_migrate(two).plist is None and on._rebuild_migrate(two).since_binning == 0
    assert md.partner_list is False  # off by default on the CPU


def test_state_of_unknown_binning_runs_counted_loop(melt, monkeypatch):
    """A state that neither init nor a rebuild made (here one carried in
    from the JAX package's leaves, 3 steps into its period, displacements
    not zero) does not know when it was binned: its windows build no list
    and run the counted loop, until a rebuild makes the binning fresh."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch import interop
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import grid_md3

    md, gs = melt
    moved = md._window_for(gs, 3)(gs)
    leaves = {f: getattr(moved, f).numpy() for f in (*GRIDS, "cry", "crz", "cvx", "cvy", "dispx", "dispy", "dispz")}
    leaves.update({f: getattr(moved, f).numpy() for f in ("dmax2", "overflow", "time", "max_occ")})
    on = _engine(INLJ, "cpu", partner_list=True)
    s = interop.grid3_state_from_jax(leaves, on)
    assert s.since_binning is None and float(s.dispx.abs().max()) > 0
    builds, listed = [], []
    build, ref = grid_md3.build_partner_list3, cell_cuda3.grid_force3_list_reference
    monkeypatch.setattr(grid_md3, "build_partner_list3", lambda *a, **k: builds.append(1) or build(*a, **k))
    monkeypatch.setattr(cell_cuda3, "grid_force3_list_reference", lambda *a, **k: listed.append(1) or ref(*a, **k))
    a = on._window_for(s, 2)(s)
    assert not builds and not listed and a.plist is None and a.since_binning is None
    assert all(torch.equal(getattr(a, g), getattr(md._window_for(moved, 2)(moved), g)) for g in GRIDS)
    fresh = on._rebuild_migrate(a)
    assert fresh.since_binning == 0
    assert on._window_for(fresh, 2)(fresh).plist is not None and builds and listed


def test_fixed_driver_returns_no_list(melt):
    """The fixed-cadence driver's next call rebins first, so the state it
    hands back holds no list, which would stay alive beside the next one."""
    _, gs = melt
    on = _engine(INLJ, "cpu", partner_list=True)
    out = on.make_production_run_fixed(12, 6)(gs)
    assert out.plist is None and out.since_binning == 6


def test_list_rules():
    """The radius covers cutoff + skin with a margin far below the skin,
    the capacity is the rule's, and the wrappers refuse what the kernels do
    not take."""
    r2 = cell_cuda3.list_radius2(2.5, 0.421, 134.37)
    assert 2.921 < math.sqrt(r2) < 2.921 + 0.01 * 0.421
    assert torch.tensor(r2, dtype=torch.float32).item() == r2
    assert cell_cuda3.list_radius2(2.5, 0.421, 134.37, steps=1) < r2
    m = 2_048_000 / 134.37**3 * 4 / 3 * math.pi * r2**1.5
    k = cell_cuda3.list_capacity(2_048_000, 134.37, r2)
    assert k % 8 == 0 and m + 6 * math.sqrt(m) <= k < m + 6 * math.sqrt(m) + 8
    assert cell_cuda3.list_bound_ok(64, 672) and not cell_cuda3.list_bound_ok(None, 672)


def test_list_wrappers_reject_bad_inputs(melt):
    md, gs = melt
    p, cov = md._params, md.static_cov
    args = (gs.xg, gs.yg, gs.zg, p, md.list_r2)
    with pytest.raises(ValueError, match="multiple of 4"):
        cell_cuda3.build_partner_list3(*args, 10, static_cov=cov)
    wide = dataclasses.replace(p, cap=72)  # B4's bound at a capacity over the list's 64 slots
    grid = torch.full(wide.grid_shape, wide.sentinel)
    with pytest.raises(ValueError, match="slots below"):
        cell_cuda3.build_partner_list3(grid, grid, grid, wide, md.list_r2, 16)
    with pytest.raises(TypeError, match="full"):
        cell_cuda3.build_partner_list3(*args, 16, static_cov=cov, full=torch.zeros(()))
    plist, _ = cell_cuda3.build_partner_list3(*args, 16, static_cov=cov)
    with pytest.raises(ValueError, match="force-only"):
        cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, p, static_cov=cov, with_energy=True, plist=plist)
    with pytest.raises(ValueError, match="built for bound"):
        cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, p, gs.max_occ, plist=plist)


class _Run:
    def __init__(self, steps, counters):
        self.n, self.steps, self.counters = 1000, steps, counters


@pytest.mark.parametrize("steps,counters,want", [
    (200, {"cell_cuda3.LIST_LAUNCHES": 200, "cell_cuda3.LIST_BUILD_LAUNCHES": 34}, 100.0),
    (200, {"cell_cuda3.LIST_LAUNCHES": 0}, 0.0),
    (200, {"cell_cuda3.COUNTED_LAUNCHES": 200}, None),  # a program without the list form
    (0, {"cell_cuda3.LIST_LAUNCHES": 0}, None),
])
def test_list_force_pct_reader(steps, counters, want):
    path = Path(__file__).resolve().parent.parent / "port_bench" / "metrics" / "list_force_pct.py"
    spec = importlib.util.spec_from_file_location("port_bench_metrics_list_force_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(_Run(steps, counters)) == want


# -- on the card -------------------------------------------------------------

INLJ_2M = override(INLJ, n=2_048_000)


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inlj_states():
    """In.lj at 2,048,000 atoms on the card: the engine with the list off,
    its fcc start just binned, and the state one 200-step block later, just
    rebuilt."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    md = _engine(INLJ_2M, dev, partner_list=False)
    start = md.init(*_fcc(INLJ_2M, dev, seed=5600000079))
    block = md._rebuild_migrate(md.make_production_run_fixed(200, 6)(start))
    return md, {"fcc": start, "block": block}


def _entries_equal(a, b, occ):
    """The counts, and the entries up to the last group (all k where full),
    of each occupied target (``occ``) of two lists of one binning."""
    _, place = cell_cuda3._list_targets(occ, a.strip, a.stride)
    ca, cb = a.counts.reshape(-1)[place], b.counts.reshape(-1)[place]
    if not torch.equal(ca, cb):
        return False
    n = torch.where(ca == cell_cuda3.LIST_FULL, a.k, (ca + 3) // 4 * 4)
    used = torch.arange(a.k, device=ca.device)[None] < n[:, None]
    ea, eb = (x.entries.reshape(-1, x.k)[place] for x in (a, b))
    return torch.equal(torch.where(used, ea, 0), torch.where(used, eb, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("bound", ["B5", "B4", "B5 full"])
def test_card_build_matches_plain(cuda_device, bound):
    cfg = override(INLJ, n=8788, rho=0.8, kt=1.0)  # 13 fcc cells a side
    md = _engine(cfg, cuda_device, partner_list=False)
    gs = md._rebuild_migrate(md.make_production_run_fixed(60, 6)(md.init(*_fcc(cfg, cuda_device))))
    cov = None if bound == "B4" else md.static_cov
    k = 64 if bound == "B5 full" else md.list_cap
    strip = cell_cuda3.list_strip(md._params, cov, cuda_device)
    before = cell_cuda3.LIST_BUILD_LAUNCHES
    got, full = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, k, gs.max_occ, cov)
    b = int(gs.max_occ) if cov is None else cov
    want, n_full = cell_cuda3.build_partner_list3_reference(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, k, b,
                                                            cov or 0, strip)
    torch.cuda.synchronize()
    assert cell_cuda3.LIST_BUILD_LAUNCHES == before + 1
    occ = gs.xg.view(md.cps, md.cap, md.cps, md.cps)[:, :b] != md._params.sentinel
    assert _entries_equal(got, want, occ) and int(full) == int(n_full)
    assert (int(full) > 0) == (bound == "B5 full")


def _window_forces(md, gs, cov, plist):
    """Each step of a 6-step leapfrog window from ``gs``: the counted
    kernel's forces and the list form's, on the same positions."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog

    ax = md.AXES
    lf = Leapfrog([getattr(gs, f"v{a}g").clone() for a in ax], [getattr(gs, f"{a}g").clone() for a in ax],
                  [getattr(gs, f"disp{a}").clone() for a in ax],
                  [getattr(gs, f"cr{a}").clone() for a in ax], [getattr(gs, f"cv{a}").clone() for a in ax],
                  dt=md.dt)
    f = [getattr(gs, f"f{a}g") for a in ax]
    for _ in range(6):
        lf.step(f)
        f = cell_cuda3.grid_force3(*lf.pos, md._params, gs.max_occ, static_cov=cov)
        yield f, cell_cuda3.grid_force3(*lf.pos, md._params, gs.max_occ, static_cov=cov, plist=plist)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fcc", "block"])
@pytest.mark.parametrize("bound", ["B5", "B4", "B5 full"])
def test_card_list_form_matches_counted_every_step(cuda_device, inlj_states, which, bound):
    md, states = inlj_states
    gs = states[which]
    cov = None if bound == "B4" else 32
    assert md.static_cov == 32
    k = 64 if bound == "B5 full" else md.list_cap
    plist, full = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, k, gs.max_occ, cov)
    b = int(gs.max_occ) if cov is None else cov
    occ = gs.xg.view(md.cps, md.cap, md.cps, md.cps)[:, :b] != md._params.sentinel
    _, place = cell_cuda3._list_targets(occ, plist.strip, plist.stride)
    n_full = int((plist.counts.reshape(-1)[place] == cell_cuda3.LIST_FULL).sum())
    assert int(full) == n_full and (n_full > 0) == (bound == "B5 full")
    for step, (want, got) in enumerate(_window_forces(md, gs, cov, plist)):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"step {step + 1}"


@pytest.mark.cuda
def test_card_block_with_list_on_and_off(cuda_device, inlj_states):
    md, states = inlj_states
    gs = states["block"]
    on = _engine(INLJ_2M, cuda_device)
    assert on.partner_list and not md.partner_list
    counts = (cell_cuda3.LIST_LAUNCHES, cell_cuda3.LIST_BUILD_LAUNCHES)
    a = on.make_production_run_fixed(200, 6)(gs)
    b = md.make_production_run_fixed(200, 6)(gs)
    torch.cuda.synchronize()
    assert (cell_cuda3.LIST_LAUNCHES - counts[0], cell_cuda3.LIST_BUILD_LAUNCHES - counts[1]) == (200, 34)
    assert int(a.list_overflows) == 0 and not bool(a.overflow)
    assert all(torch.equal(getattr(a, g), getattr(b, g)) for g in GRIDS)


@pytest.mark.cuda
def test_card_list_form_keeps_its_profiled_name(cuda_device, inlj_states):
    """The list form is the counted kernel under its own symbol, which
    ``force_kernel_roofline`` reads; the build has a name of its own. The
    capture is ``utils.profiling.device_op_count``'s, which retakes one
    that came back without its first records."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import device_op_count
    from port_bench.counts.timing import kernel_name

    md, states = inlj_states
    gs = states["block"]
    plist, _ = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, md.list_cap,
                                              static_cov=32)
    ops = device_op_count(lambda: (
        cell_cuda3.grid_force3(gs.xg, gs.yg, gs.zg, md._params, static_cov=32, plist=plist),
        cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, md._params, md.list_r2, md.list_cap, static_cov=32)))
    names = {kernel_name(name) for name in ops}
    assert "cell_force3_counted_kernel<32, false>" in names
    assert "cell_list3_build_kernel<32>" in names
