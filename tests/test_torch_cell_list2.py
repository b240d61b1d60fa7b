"""The partner list of B3, the packed 2D force kernel, and its list form
(``cell_cuda_packed.build_partner_list2``, ``grid_force_packed(...,
plist=)``), with the list's lifecycle in the grid engines' shared core.

On the CPU: the list's plain version holds every pair within its radius in
the counted loop's order, keeps a pair whose partners then close in by
just under skin/2 each, marks and counts the targets over its capacity,
and the forces summed from it are the plain version's bits across the
engine's windows at R = 7 (``lj2d-n1m``'s packing) and at one block of all
rows (N=16,384's); a state of unknown binning and windows past the list's
lifetime run the counted loop; the 3D list's radius and capacity keep their
values; the ``list_force_2d_pct`` reader. On the card (``-m cuda``;
skipped without one): the build kernel against its plain version, the list
form against the counted kernel at every step of a window at ``lj2d-n1m``'s
start and after a block, a block with the list on and off, and the
profiled names. This file imports no jax, so on the card:

    python -m pytest tests/test_torch_cell_list2.py --noconftest -q
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3, cell_cuda_packed
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from port_bench.counts import lattice

# lj2d-n1m's fluid (rho 0.8, kT 1, dt 1e-3, cutoff 2.5, Kahan) at 3000
# particles: 21 cells a side, packed as N=1M is (R = 7); and at 2000: 17
# cells a side, all in one block (R = 17), as N=16,384 packs its 49 rows
LJ2D = override(MDConfig(), n=3000, dim=2, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, force_impl="grid",
                compensated=True, eq_steps=0, prod_steps=100, sample_every=100)
ONE_BLOCK = override(LJ2D, n=2000)
GRIDS = ("xg", "yg", "vxg", "vyg", "fxg", "fyg", "crx", "cry", "cvx", "cvy", "pid", "occ", "counts")


def _engine(cfg, device, rows_per_block, **kw):
    gf = lj_fluid._make_grid_md(cfg, "cpu").grid_fn
    return GridMD(gf, dt=cfg.dt, compensated=cfg.compensated, rows_per_block=rows_per_block, device=device, **kw)


def _start(cfg, device, seed=7):
    gen = torch.Generator(device=device).manual_seed(seed)
    return lattice.square_lattice(cfg.n, cfg.box_size, cfg.kt, gen)


def _liquid(cfg, rows_per_block):
    """The engine (list off) and its state 200 steps from the lattice, just
    rebuilt: coordinates wrapped, the binning fresh."""
    md = _engine(cfg, "cpu", rows_per_block)
    gs = md.make_production_run(200, 4, gate_frac=0.4)(md.init(*_start(cfg, "cpu")))
    return md, md._rebuild_migrate(gs)


@pytest.fixture(scope="module")
def liquid():
    return _liquid(LJ2D, 7)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, g), getattr(b, g)) for g in GRIDS)


def _decoded(plist, counts, cap):
    """Per occupied target (flat unpacked ``(cps, cap, cps)`` index), its
    entries as ``(offset, slot)`` pairs in list order, and its count."""
    flat, num, _ = cell_cuda_packed._targets(counts, plist, cap)
    out = {}
    for f, g in zip(flat.tolist(), num.tolist()):
        n = int(plist.counts[g])
        e = plist.entries[g, :n]
        out[f] = (list(zip((e >> cell_cuda_packed.LIST_SLOT_BITS).tolist(), (e & 127).tolist())), n)
    return out


def _partner_pid(md, pid_u, f, o, b):
    """The particle id in slot ``b`` of target ``f``'s neighbour cell at
    offset ``o``."""
    c = md.cps
    cx, cy = f // (md.cap * c), f % c
    return int(pid_u[(cx + o // 3 - 1) % c, b, (cy + o % 3 - 1) % c])


def test_list_holds_every_pair_within_radius_in_loop_order(liquid):
    md, gs = liquid
    p, r = md._params, md.rows_per_block
    plist, full = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, md.list_cap, md.n)
    assert int(full) == 0 and plist.stride == md.n  # 3000, a multiple of 4
    pid_u = cell_cuda_packed.unpack(gs.pid, r)
    lists = _decoded(plist, gs.counts, md.cap)
    assert len(lists) == md.n
    # the targets are numbered 0 .. n-1, cell by cell
    _, num, _ = cell_cuda_packed._targets(gs.counts, plist, md.cap)
    assert torch.equal(num.sort().values, torch.arange(md.n))
    # every pair by the minimum image in float64, from the binned positions
    pos = md.positions(gs).double()
    d = pos[:, None] - pos[None]
    d -= md.box * torch.round(d / md.box)
    dist = d.pow(2).sum(-1).sqrt()
    dist.fill_diagonal_(math.inf)
    r_list = math.sqrt(md.list_r2)
    for f, (entries, n) in lists.items():
        assert entries == sorted(entries) and len(set(entries)) == n, "not in the counted loop's order"
        i = int(pid_u.reshape(-1)[f])
        got = {_partner_pid(md, pid_u, f, o, b) for o, b in entries}
        assert len(got) == n and i not in got
        assert set(torch.nonzero(dist[i] < r_list - 1e-3).squeeze(1).tolist()) <= got
        assert got <= set(torch.nonzero(dist[i] < r_list + 1e-3).squeeze(1).tolist())
    # the mean partners near the capacity rule's mean (a uniform density's;
    # the melting lattice holds ~5% fewer within 2.9), no target near its
    # margin
    n = torch.tensor([v[1] for v in lists.values()], dtype=torch.float64)
    m = md.n / md.box**2 * math.pi * r_list**2
    assert abs(float(n.mean()) / m - 1.0) < 0.1 and int(n.max()) < md.list_cap
    # a partial last group is padded with the target itself
    g, f = 0, int(torch.nonzero(pid_u.reshape(-1) >= 0)[0])
    flat, num, _ = cell_cuda_packed._targets(gs.counts, plist, md.cap)
    g = int(num[flat == f])
    n_g = int(plist.counts[g])
    pad = plist.entries[g, n_g: (n_g + 3) // 4 * 4]
    assert torch.equal(pad, torch.full_like(pad, (4 << 7) | (f // md.cps) % md.cap))


def test_planted_pair_closing_by_half_skin_is_listed():
    """Two particles just inside cutoff + skin, each moved just under
    skin/2 toward the other after the list is built: they end inside the
    cutoff, the pair is on the list and the list form gives the counted
    loop's bits; a list whose radius leaves the pair out does not."""
    cfg = override(LJ2D, rho=0.1)
    md = _engine(cfg, "cpu", None)  # the default packing of its 59 cells a side
    p, r = md._params, md.rows_per_block
    gen = torch.Generator().manual_seed(11)
    pos = torch.rand((cfg.n, 2), generator=gen, dtype=torch.float32) * md.box
    rc, skin = cfg.cutoff, md.skin
    delta = 1e-4
    pos[0] = torch.tensor([0.5, 0.5]) * md.box
    pos[1] = pos[0] + torch.tensor([rc + skin - delta, 0.0])
    gs = md.init(pos, torch.zeros_like(pos))
    plist, _ = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, md.list_cap, md.n)
    short, _ = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, (rc + skin - 2 * delta) ** 2,
                                                    md.list_cap, md.n)
    step = skin / 2 - delta / 4
    xg = gs.xg.clone()
    i0, i1 = (torch.nonzero(gs.pid.reshape(-1) == k).item() for k in (0, 1))
    xg.view(-1)[i0] += step
    xg.view(-1)[i1] -= step
    gap = float(xg.view(-1)[i1] - xg.view(-1)[i0])
    assert gap**2 < p.cutoff2
    want = cell_cuda_packed.grid_force_packed(xg, gs.yg, gs.counts, p, r)
    got = cell_cuda_packed.grid_force_packed(xg, gs.yg, gs.counts, p, r, plist=plist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want[0].view(-1)[i0]) != 0.0
    missed = cell_cuda_packed.grid_force_packed(xg, gs.yg, gs.counts, p, r, plist=short)
    assert not torch.equal(missed[0], want[0])


def test_small_capacity_marks_full_and_counts(liquid):
    md, gs = liquid
    p, r = md._params, md.rows_per_block
    k = 20  # about the mean list (~21 partners a target)
    plist, full = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, k, md.n,
                                                       full=torch.tensor(7, dtype=torch.int32))
    n_full = int((plist.counts == cell_cuda3.LIST_FULL).sum())
    assert 0 < n_full < md.n and int(full) == 7 + n_full
    want = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r)
    got = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, plist=plist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a list without room for every target: those past it run the counted loop
    part, _ = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, md.list_cap, 1000)
    assert part.stride == 1000
    got = cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, plist=part)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the engine counts them in list_overflows and runs the same steps
    on = _engine(LJ2D, "cpu", 7, partner_list=True)
    on.list_cap = k
    a = on.make_production_run(24, 4, gate_frac=0.4)(gs)
    b = md.make_production_run(24, 4, gate_frac=0.4)(gs)
    assert int(a.list_overflows) > 0 and int(b.list_overflows) == 0
    assert _same(a, b)


@pytest.mark.parametrize("cfg,rows", [(LJ2D, 7), (ONE_BLOCK, 17)], ids=["R7", "one_block"])
def test_list_force_bit_equal_across_windows_and_blocks(cfg, rows):
    """Each of windows of 2 to 6 steps from a rebuilt state, and two whole
    blocks of the gated driver, with the list on and off: every grid
    equal, the list built once a binning."""
    off, gs = _liquid(cfg, rows)
    on = _engine(cfg, "cpu", rows, partner_list=True)
    for n in range(2, 7):
        a, b = on._window_for(gs, n)(gs), off._window_for(gs, n)(gs)
        assert a.plist is not None and b.plist is None and a.since_binning == n
        assert _same(a, b), n
    builds = []
    build = on._build_list
    on._build_list = lambda *a: builds.append(1) or build(*a)
    a, b = gs, gs
    for _ in range(2):
        a = on.make_production_run(100, 4, gate_frac=0.4)(a)
        b = off.make_production_run(100, 4, gate_frac=0.4)(b)
        assert _same(a, b)
    assert int(a.list_overflows) == 0 and a.plist is None and a.since_binning == 0
    assert 0 < len(builds) < 50


def test_window_uses_list_only_where_it_holds(liquid):
    """One-step windows build no list; a list is built only on a state
    fresh from its binning and serves at most ``LIST_STEPS`` steps; a
    rebuild and a window that is the last of its binning drop it; the
    list is off by default on the CPU and refused without B3."""
    md, gs = liquid
    on = _engine(LJ2D, "cpu", 7, partner_list=True)
    one = on._window_for(gs, 1)(gs)
    assert one.plist is None and one.since_binning == 1
    assert on._window_for(one, 2)(one).plist is None  # moved since the binning
    two = on._window_for(gs, 2)(gs)
    assert two.plist is not None
    late = two.replace(since_binning=cell_cuda3.LIST_STEPS - 1)
    calls = cell_cuda_packed.grid_force_packed_list_reference
    seen = []
    cell_cuda_packed.grid_force_packed_list_reference = lambda *a, **k: seen.append(1) or calls(*a, **k)
    try:
        on._window_for(late, 2)(late)
        assert not seen
        on._window_for(two, 2)(two)
        assert len(seen) == 2
    finally:
        cell_cuda_packed.grid_force_packed_list_reference = calls
    assert on._rebuild_migrate(two).plist is None and on._rebuild_migrate(two).since_binning == 0
    assert on._window_for(two, 2, last=True)(two).plist is None
    assert md.partner_list is False and on.partner_list is True
    with pytest.raises(ValueError, match="B3's"):
        _engine(LJ2D, "cpu", 1, partner_list=True)
    assert _engine(LJ2D, "cpu", 1).partner_list is False


def test_state_of_unknown_binning_runs_counted_loop(liquid, monkeypatch):
    """A state that neither init nor a rebuild made (here one carried in
    from the JAX package's leaves, 3 steps into its period, displacements
    not zero) does not know when it was binned: its windows build no list
    and run the counted loop, until a rebuild makes the binning fresh."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch import interop

    md, gs = liquid
    moved = md._window_for(gs, 3)(gs)
    names = ("xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "dispx", "dispy", "crx", "cry", "cvx", "cvy", "pid")
    leaves = {f: getattr(moved, f).numpy() for f in names}
    leaves.update({f: np.asarray(getattr(moved, f).numpy()) for f in ("dmax2", "overflow", "time")})
    on = _engine(LJ2D, "cpu", 7, partner_list=True)
    s = interop.grid_state_from_jax(leaves, on)
    assert s.since_binning is None and float(s.dispx.abs().max()) > 0
    builds, listed = [], []
    build, ref = on._build_list, cell_cuda_packed.grid_force_packed_list_reference
    monkeypatch.setattr(on, "_build_list", lambda *a: builds.append(1) or build(*a))
    monkeypatch.setattr(cell_cuda_packed, "grid_force_packed_list_reference",
                        lambda *a, **k: listed.append(1) or ref(*a, **k))
    a = on._window_for(s, 2)(s)
    assert not builds and not listed and a.plist is None and a.since_binning is None
    assert all(torch.equal(getattr(a, g), getattr(md._window_for(moved, 2)(moved), g)) for g in GRIDS)
    fresh = on._rebuild_migrate(a)
    assert fresh.since_binning == 0
    assert on._window_for(fresh, 2)(fresh).plist is not None and builds and listed


def test_list_rules():
    """The 3D radius and capacity keep their values (in.lj: 152 entries);
    in 2D the D-ball and the sqrt(2) margin give lj2d-n1m 56 entries
    within 2.9125."""
    r2 = cell_cuda3.list_radius2(2.5, 0.421, 134.37)
    assert r2 == 8.542980194091797 and cell_cuda3.list_capacity(2_048_000, 134.37, r2) == 152
    box = math.sqrt(1_000_000 / 0.8)
    r2d = cell_cuda3.list_radius2(2.5, 0.4, box, dim=2)
    assert torch.tensor(r2d, dtype=torch.float32).item() == r2d
    assert 2.9124 < math.sqrt(r2d) < 2.9125 and cell_cuda3.list_capacity(1_000_000, box, r2d, dim=2) == 56
    m = 0.8 * math.pi * r2d
    assert 56 - 8 < m + 6 * math.sqrt(m) <= 56
    # sqrt(2) in place of sqrt(3): the 2D margin is the 3D rule's on two axes
    r3 = cell_cuda3.list_radius2(2.5, 0.4, box)
    assert r2d < r3


def test_list_wrappers_reject_bad_inputs(liquid):
    md, gs = liquid
    p, r = md._params, md.rows_per_block
    args = (gs.xg, gs.yg, gs.counts, p, r, md.list_r2)
    with pytest.raises(ValueError, match="multiple of 4"):
        cell_cuda_packed.build_partner_list2(*args, 10, md.n)
    with pytest.raises(ValueError, match="room"):
        cell_cuda_packed.build_partner_list2(*args, 16, 0)
    wide = dataclasses.replace(p, cap=72)
    grid = torch.full((p.cps // r, 72, r * p.cps), p.sentinel)
    with pytest.raises(ValueError, match="slots"):
        cell_cuda_packed.build_partner_list2(grid, grid, gs.counts, wide, r, md.list_r2, 16, md.n)
    with pytest.raises(TypeError, match="full"):
        cell_cuda_packed.build_partner_list2(*args, 16, md.n, full=torch.zeros(()))
    plist, _ = cell_cuda_packed.build_partner_list2(*args, 16, md.n)
    with pytest.raises(ValueError, match="force-only"):
        cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, with_energy=True, plist=plist)
    other = dataclasses.replace(plist, cps=plist.cps + 1)
    with pytest.raises(ValueError, match="built for"):
        cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, plist=other)


class _Run:
    def __init__(self, steps, counters):
        self.n, self.steps, self.counters = 1000, steps, counters


@pytest.mark.parametrize("steps,counters,want", [
    (2000, {"cell_cuda_packed.LIST_LAUNCHES": 2000, "cell_cuda_packed.LIST_BUILD_LAUNCHES": 73}, 100.0),
    (2000, {"cell_cuda_packed.LIST_LAUNCHES": 1000}, 50.0),
    (2000, {"cell_cuda_packed.LAUNCHES": 2000}, None),  # a program without the list form
    (0, {"cell_cuda_packed.LIST_LAUNCHES": 0}, None),
])
def test_list_force_2d_pct_reader(steps, counters, want):
    path = Path(__file__).resolve().parent.parent / "port_bench" / "metrics" / "list_force_2d_pct.py"
    spec = importlib.util.spec_from_file_location("port_bench_metrics_list_force_2d_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(_Run(steps, counters)) == want


# -- on the card -------------------------------------------------------------

N1M = override(LJ2D, n=1_000_000)


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def n1m_states():
    """lj2d-n1m's geometry on the card (N=1M, 385 cells a side, R=7): the
    engine with the list off, its lattice start just binned, and the state
    one 2000-step block of the gated driver later, just rebuilt."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    md = lj_fluid._make_grid_md(N1M, dev)
    md.partner_list = False
    k, gate = lj_fluid._grid_inner_steps(N1M, md)
    start = md.init(*_start(N1M, dev, seed=5700000011))
    block = md._rebuild_migrate(md.make_production_run(2000, k, gate_frac=gate)(start))
    return md, k, gate, {"start": start, "block": block}


def _entries_equal(a, b, counts, cap):
    """Two lists of one binning, whatever order their strips were numbered
    in, hold each target's count, and its entries up to the last group
    (all k where full); each numbers the targets 0 .. n-1."""
    _, na, _ = cell_cuda_packed._targets(counts, a, cap)
    _, nb, _ = cell_cuda_packed._targets(counts, b, cap)
    dense = torch.arange(na.numel(), device=na.device)
    if not (torch.equal(na.sort().values, dense) and torch.equal(nb.sort().values, dense)):
        return False
    ca, cb = a.counts[na], b.counts[nb]
    if not torch.equal(ca, cb):
        return False
    n = torch.where(ca == cell_cuda3.LIST_FULL, a.k, (ca + 3) // 4 * 4)
    used = torch.arange(a.k, device=ca.device)[None] < n[:, None]
    return torch.equal(torch.where(used, a.entries[na], 0), torch.where(used, b.entries[nb], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n16k", "n16k full", "n1m"])
def test_card_build_matches_plain(cuda_device, n1m_states, case):
    if case == "n1m":
        md, _, _, states = n1m_states
        gs = states["block"]
    else:
        cfg = override(LJ2D, n=16_384)
        md = lj_fluid._make_grid_md(cfg, cuda_device)
        gs = md._rebuild_migrate(md.make_production_run(400, 4, gate_frac=0.4)(md.init(*_start(cfg, cuda_device))))
    p, r = md._params, md.rows_per_block
    k = 16 if case.endswith("full") else md.list_cap
    before = cell_cuda_packed.LIST_BUILD_LAUNCHES
    got, full = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, k, md.n)
    want, n_full = cell_cuda_packed.build_partner_list2_reference(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, k,
                                                                  got.stride, got.strip)
    torch.cuda.synchronize()
    assert cell_cuda_packed.LIST_BUILD_LAUNCHES == before + 1
    assert _entries_equal(got, want, gs.counts, md.cap) and int(full) == int(n_full)
    assert (int(full) > 0) == case.endswith("full")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["start", "block"])
@pytest.mark.parametrize("k", ["list_cap", "full"])
def test_card_list_form_matches_counted_every_step(cuda_device, n1m_states, which, k):
    """B3's list form torch.equal to the counted kernel at every step of a
    window of the cell's length, from the binned start and after a
    block; with k 16 (about half the targets full) as well."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog

    md, n_inner, _, states = n1m_states
    gs = states[which]
    p, r = md._params, md.rows_per_block
    kk = md.list_cap if k == "list_cap" else 16
    plist, full = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, kk, md.n)
    assert (int(full) > 0) == (k == "full")
    ax = md.AXES
    lf = Leapfrog([getattr(gs, f"v{a}g").clone() for a in ax], [getattr(gs, f"{a}g").clone() for a in ax],
                  [getattr(gs, f"disp{a}").clone() for a in ax],
                  [getattr(gs, f"cr{a}").clone() for a in ax], [getattr(gs, f"cv{a}").clone() for a in ax],
                  dt=md.dt)
    f = [getattr(gs, f"f{a}g") for a in ax]
    for step in range(max(n_inner, 4)):
        lf.step(f)
        f = cell_cuda_packed.grid_force_packed(*lf.pos, gs.counts, p, r)
        got = cell_cuda_packed.grid_force_packed(*lf.pos, gs.counts, p, r, plist=plist)
        assert all(torch.equal(a, b) for a, b in zip(got, f)), f"step {step + 1}"


@pytest.mark.cuda
def test_card_block_with_list_on_and_off(cuda_device, n1m_states):
    """A 2000-step block of the gated driver with the list on and off ends
    in equal states; the list form runs every step, one build a binning."""
    md, k, gate, states = n1m_states
    gs = states["block"]
    on = lj_fluid._make_grid_md(N1M, cuda_device)
    assert on.partner_list and not md.partner_list and on.list_cap == 56
    counts = (cell_cuda_packed.LIST_LAUNCHES, cell_cuda_packed.LIST_BUILD_LAUNCHES)
    a = on.make_production_run(2000, k, gate_frac=gate)(gs)
    b = md.make_production_run(2000, k, gate_frac=gate)(gs)
    torch.cuda.synchronize()
    lists, builds = cell_cuda_packed.LIST_LAUNCHES - counts[0], cell_cuda_packed.LIST_BUILD_LAUNCHES - counts[1]
    assert lists == 2000 and 0 < builds < 2000 // 8
    assert int(a.list_overflows) == 0 and not bool(a.overflow)
    assert _same(a, b)


@pytest.mark.cuda
def test_card_list_form_keeps_its_profiled_name(cuda_device, n1m_states):
    """The list form is B3 under its own symbol, which
    ``force_kernel_roofline`` reads; the build has a name of its own,
    which that metric's pattern does not take."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import device_op_count
    from port_bench.counts.timing import kernel_name
    from port_bench.metrics.force_kernel_roofline import KERNELS

    md, _, _, states = n1m_states
    gs = states["block"]
    p, r = md._params, md.rows_per_block
    plist, _ = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, md.list_cap, md.n)
    ops = device_op_count(lambda: (
        cell_cuda_packed.grid_force_packed(gs.xg, gs.yg, gs.counts, p, r, plist=plist),
        cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, gs.counts, p, r, md.list_r2, md.list_cap, md.n)))
    names = {kernel_name(name) for name in ops}
    assert "cell_force_counted_kernel<false>" in names
    assert "cell_list_build_kernel" in names
    assert not KERNELS.match("cell_list_build_kernel")
