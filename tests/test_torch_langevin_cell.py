"""The Langevin noise keyed by particle and step (``ops/kernels/noise_cuda.py``,
``csrc/noise.cu``), the global step that ``lj_fluid``'s phases hand on, and
the benchmark cell ``lj2d-nvt-n1m`` (the project's documented NVT run) at a
CPU size through the harness's own comparison with its plain reference
(``port_bench/reference/lj_baoab.py``).

On the CPU: Philox4x32-10's known answers and the reference's own words;
the normals' moments and correlations; the reference against itself (no
friction and no noise is velocity Verlet, no noise scales the momentum by
c1 a step); consecutive blocks and phases draw fresh noise, and a particle
keeps its noise across a rebuild that moves it to another slot; the cell
at N=1024 with a 100-step set-up and one 100-step block, sound on two
seeds, its three controls and three planted faults not correct; the
readers. Marked ``cuda`` (skipped without a card): the kernel's normals
against the plain version at N=1M's grid (so its Philox words are the
plain version's, whose known answers the CPU checks), its zeros, its launch
count, and one Langevin window on the card against the same window on the
CPU. Imports no jax. On the card:

    python -m pytest tests/test_torch_langevin_cell.py --noconftest -q
"""

import io
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(4)  # the plain reference and 200 engine steps at N=1024 a case

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # port_bench is a directory of the checkout, not a package
    sys.path.insert(0, str(ROOT))

from jax_tpus_benchmark_physics_simulation_tpu_torch import cli  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import grid_engine, noise_cuda  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.counts import lattice, noise  # noqa: E402
from port_bench.counts.timing import Trace, kernel_name  # noqa: E402
from port_bench.reference import lj_baoab, lj_nve  # noqa: E402

CELL = "lj2d-nvt-n1m"
SEEDS = (2**31 + 5, 5300000001)
TINY_N = 1024
M32 = 0xFFFFFFFF
KAT = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)  # Random123: counter 0, key 0


def _words(values):
    return torch.tensor(values, dtype=torch.int64)


# -- the noise ---------------------------------------------------------------------
def test_philox_known_answers():
    zero = _words([0])
    assert [int(w) for w in noise_cuda.philox4x32_10(zero, zero, zero, zero, 0, 0)] == list(KAT)
    ones = _words([M32])  # Random123's other two known answers
    assert [int(w) for w in noise_cuda.philox4x32_10(ones, ones, ones, ones, M32, M32)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    got = noise_cuda.philox4x32_10(_words([0x243F6A88]), _words([0x85A308D3]), _words([0x13198A2E]),
                                   _words([0x03707344]), 0xA4093822, 0x299F31D0)
    assert [int(w) for w in got] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


@pytest.mark.parametrize("seed", [0, 1, 24301, 2**31 + 5 + 24301, M32, 2**32, 2**63 + 12345, 2**64 - 1])
def test_program_and_reference_words_agree(seed):
    """The program's plain Philox and the reference's own, word for word,
    over steps about 2^32 and ids up to 2^24."""
    steps = [0, 1, 99, M32 - 1, M32, 2**32, 2**32 + 1, 2**40 + 7]
    ids = torch.tensor([0, 1, 2, 1000, 2**20 + 3, 2**24 - 1], dtype=torch.int64)
    k0, k1 = seed & M32, seed >> 32
    for t in steps:
        lo, hi = torch.full_like(ids, t & M32), torch.full_like(ids, t >> 32)
        mine = noise_cuda.philox4x32_10(lo, hi, ids, torch.zeros_like(ids), k0, k1)
        ref = lj_baoab.philox((lo, hi, ids, torch.zeros_like(ids)), (k0, k1))
        for a, b in zip(mine, ref):
            assert torch.equal(a, b), (seed, t)
            assert int(a.min()) >= 0 and int(a.max()) <= M32


@pytest.mark.parametrize("dim", [2, 3])
def test_reference_normals_are_the_programs(dim):
    """The reference's float64 transform of the same words and the
    program's plain version agree to the program's float32 rounding of u1
    and u2 (the axes, signs and pairs are the same)."""
    n = 50_000
    mine = noise_cuda.noise_reference(7 + 24301, 2**32 + 3, torch.arange(n, dtype=torch.int32), dim, torch.float64)
    ref = lj_baoab.noise(7 + 24301, 2**32 + 3, n, dim, "cpu").T
    assert float((mine - ref).abs().max()) < 1e-3
    assert float(((mine - ref).abs() / ref.abs().clamp(min=1.0)).median()) < 1e-7


def test_normals_have_unit_moments_and_no_correlation():
    n = 400_000
    z = noise_cuda.noise_reference(2**31 + 99, 123456, torch.arange(n, dtype=torch.int32), 3, torch.float64)
    tol = 5.0 / math.sqrt(n)
    for k in range(3):
        assert abs(float(z[k].mean())) < tol
        assert abs(float(z[k].var()) - 1.0) < tol
    corr = lambda a, b: float(((a - a.mean()) * (b - b.mean())).mean() / (a.std() * b.std()))  # noqa: E731
    assert abs(corr(z[0][:-1], z[0][1:])) < tol  # neighbouring ids
    assert abs(corr(z[0], z[1])) < tol and abs(corr(z[0], z[2])) < tol  # axes
    z_next = noise_cuda.noise_reference(2**31 + 99, 123457, torch.arange(n, dtype=torch.int32), 3, torch.float64)
    for k in range(3):
        assert abs(corr(z[k], z_next[k])) < tol  # consecutive steps
    other_seed = noise_cuda.noise_reference(2**31 + 100, 123456, torch.arange(n, dtype=torch.int32), 3, torch.float64)
    assert abs(corr(z[0], other_seed[0])) < tol


def test_noise_is_zero_in_empty_slots_and_the_wrapper_checks():
    pid = torch.tensor([[3, -1, 0], [-1, 7, 2]], dtype=torch.int32)
    z = noise_cuda.langevin_noise(5, 11, pid, 2)
    assert z.shape == (2, 2, 3) and z.dtype == torch.float32
    assert torch.equal(z[:, pid < 0], torch.zeros(2, 2))
    assert bool((z[:, pid >= 0] != 0).all())
    want = noise_cuda.noise_reference(5, 11, torch.tensor([3, 0, 7, 2], dtype=torch.int32), 2)
    assert torch.equal(z[:, pid >= 0], want)
    assert noise_cuda.langevin_noise(5, 11, pid, 2, torch.float64).dtype == torch.float64
    with pytest.raises(TypeError, match="int32"):
        noise_cuda.langevin_noise(5, 11, pid.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        noise_cuda.langevin_noise(5, 11, pid.T, 2)
    with pytest.raises(ValueError, match="dim"):
        noise_cuda.langevin_noise(5, 11, pid, 4)
    with pytest.raises(ValueError, match="step"):
        noise_cuda.langevin_noise(5, -1, pid, 2)


# -- the plain reference ---------------------------------------------------------------
def _start(n=256, seed=11):
    box = math.sqrt(n / 0.8)
    pos, vel = lattice.square_lattice(n, box, 1.0, torch.Generator().manual_seed(seed))
    return pos.double(), vel.double(), lj_nve.LJ(box=box, cutoff=2.5)


def test_reference_without_friction_is_velocity_verlet():
    r, v, p = _start()
    got = lj_baoab.run(r, v, p, 1e-3, 100, 0.0, 1.0, 3, 0)
    want = lj_nve.run(r, v, p, 1e-3, 100)
    assert float(lj_nve._min_image(got[0] - want[0], p.box).abs().max()) < 1e-10 * p.box
    assert float((got[1] - want[1]).abs().max()) < 1e-10 * float(want[1].abs().max())
    for a, b in zip(got[2:], want[2:]):
        assert abs(float(a) - float(b)) < 1e-10 * abs(float(b))


def test_reference_momentum_scales_by_c1_without_noise(monkeypatch):
    r, v, p = _start()
    v = v + torch.tensor([0.5, -0.25], dtype=torch.float64)
    monkeypatch.setattr(lj_baoab, "noise", lambda seed, step, n, dim, device: torch.zeros(n, dim, dtype=torch.float64))
    gamma, dt, steps = 2.0, 1e-3, 50
    _, v1, _, _ = lj_baoab.run(r, v, p, dt, steps, gamma, 1.0, 3, 0)
    want = v.sum(0) * math.exp(-gamma * dt) ** steps
    assert float((v1.sum(0) - want).abs().max()) < 1e-11 * float(v.sum(0).abs().max())


def test_reference_imports_neither_jax_nor_the_port():
    blocked = ("jax", "jax_tpus_benchmark_physics_simulation_tpu", "jax_tpus_benchmark_physics_simulation_tpu_torch")
    code = (f"import sys; sys.modules.update(dict.fromkeys({blocked!r})); "
            "from port_bench.reference import lj_baoab; from port_bench.counts import noise; "
            f"assert not [m for m in sys.modules if sys.modules[m] is not None and m.startswith({blocked!r})]")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


# -- the global step: fresh noise in every block, kept by the particle ---------------
def _record_noise(monkeypatch):
    """Every noise draw of the engines' windows: ``(step, noise in particle
    order)``."""
    calls = []
    draw = grid_engine.langevin_noise

    def recording(seed, step, pid, dim, dtype=torch.float32):
        z = draw(seed, step, pid, dim, dtype)
        occupied = pid >= 0
        by_particle = torch.zeros(dim, int(pid.max()) + 1, dtype=z.dtype)
        by_particle[:, pid[occupied].long()] = z[:, occupied]
        calls.append((step, by_particle, pid.clone()))
        return z

    monkeypatch.setattr(grid_engine, "langevin_noise", recording)
    return calls


def _nvt_cfg(n=1024):
    return MDConfig(n=n, dim=2, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, sample_every=20, eq_steps=40, prod_steps=40,
                    thermostat="langevin", gamma=1.0, force_impl="grid", seed=17)


def _lattice_state(cfg):
    pos, vel = lattice.square_lattice(cfg.n, cfg.box_size, cfg.kt, torch.Generator().manual_seed(3))
    return ParticleState.create(pos, vel)


def test_consecutive_blocks_and_phases_draw_fresh_noise(monkeypatch):
    """The fault this repairs: each phase re-armed the stream at counter 0,
    so every block replayed the same noise. Now equilibration, then two
    production blocks from one state, draw each step's noise at its own
    global step, and equal offsets into two blocks draw different noise."""
    cfg = _nvt_cfg()
    md = lj_fluid._make_grid_md(cfg, "cpu")
    calls = _record_noise(monkeypatch)
    s0, _ = lj_fluid.equilibrate(cfg, _lattice_state(cfg), md)
    assert s0.step == cfg.eq_steps
    s1, _, _ = lj_fluid.production(cfg, s0, None, md)
    s2, _, _ = lj_fluid.production(cfg, s1, None, md)
    assert (s1.step, s2.step) == (cfg.eq_steps + cfg.prod_steps, cfg.eq_steps + 2 * cfg.prod_steps)
    assert [c[0] for c in calls] == list(range(cfg.eq_steps + 2 * cfg.prod_steps))
    eq, b1, b2 = calls[: cfg.eq_steps], calls[cfg.eq_steps : cfg.eq_steps + 40], calls[cfg.eq_steps + 40 :]
    for k in (0, 7, 39):
        assert not torch.allclose(b1[k][1], b2[k][1])
        assert not torch.allclose(eq[k][1], b1[k][1])
    for step, z, _ in calls[::13]:  # each draw is the reference definition's, particle for particle
        want = noise_cuda.noise_reference(lj_fluid._grid_seed(cfg), step, torch.arange(cfg.n, dtype=torch.int32), 2)
        assert torch.equal(z, want)


def test_nve_phases_hand_on_the_step_too():
    cfg = override(_nvt_cfg(), thermostat="none")
    s0, _ = lj_fluid.equilibrate(cfg, _lattice_state(cfg))
    s1, _, _ = lj_fluid.production(cfg, s0)
    assert (s0.step, s1.step) == (40, 80)
    dense = override(cfg, n=64, force_impl="dense_xla", cutoff=None)
    d0, _ = lj_fluid.equilibrate(dense, _lattice_state(dense))
    assert lj_fluid.production(dense, d0)[0].step == 80


def test_a_particle_keeps_its_noise_across_a_rebuild(monkeypatch):
    """A Langevin window before and after a rebuild that moves particles to
    other slots: each particle draws the noise of its global step."""
    n = 1024
    box = math.sqrt(n / 0.8)
    md = GridMD(make_cell_grid_fn(box, 2.5, n, dim=2), dt=2e-3, compensated=True, device="cpu")
    pos, vel = lattice.square_lattice(n, box, 1.0, torch.Generator().manual_seed(5))
    calls = _record_noise(monkeypatch)
    window = md._make_window(md.force_kernel, 5, (1.0, 1.0))
    s = md.init(pos, vel * 20.0, seed=99, step=2**32 - 3)  # hot: particles change cells within a window
    s = window(s)
    rebuilt = md._rebuild_migrate(s)
    assert rebuilt.rng_counter == 2**32 + 2 and not torch.equal(rebuilt.pid, s.pid)
    window(rebuilt)
    assert [c[0] for c in calls] == [2**32 - 3 + k for k in range(10)]
    assert not torch.equal(calls[4][2], calls[5][2])  # the slots changed between the two windows
    ids = torch.arange(n, dtype=torch.int32)
    for step, z, _ in calls:
        assert torch.equal(z, noise_cuda.noise_reference(99, step, ids, 2))


# -- the cell through the harness, at a CPU size -------------------------------------
def _tiny_cell():
    cell = harness.load_cell(CELL)
    cell.traffic["md"]["n"] = TINY_N
    cell.traffic.update(eq_steps=100, block_steps=100)
    # kt_gap reads the kinetic temperature's scatter, sqrt(2 / (d N)): the
    # cell's limit at its N, scaled to this N
    cell.config["guarantees"]["kt_gap"] *= math.sqrt(cell.config["md"].get("n", 1_000_000) / TINY_N)
    return cell


def _tiny_run(seed: int = SEEDS[0], overrides=None):
    return harness.measure(_tiny_cell(), seed, 0.0, False, device="cpu", overrides=overrides, log=io.StringIO())


def test_cell_loads_with_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.config["md"]["thermostat"] == "langevin" and cell.config["reduced"] == []
    assert cell.config["noise"]["stream_seed_offset"] == 0x5EED
    assert (harness.HERE / cell.config["reference"]).exists()
    assert {m["name"] for m in cell.metrics["end_to_end"]} == {"psteps_per_s", "setup_s"}
    assert {m["name"] for m in cell.metrics["per_layer"]} == {
        "device_idle_pct", "device_ops_per_step", "steps_per_rebuild", "torch_ops_us_per_step",
        "force_kernel_roofline", "rebuild_kernel_roofline", "alloc_kernel_pct", "list_force_2d_pct",
        "noise_kernel_roofline", "noise_kernel_pct", "baoab_step_pct", "host_syncs_per_step",
        "idle_after_sync_us_per_step", "idle_in_rebuild_us_per_step", "idle_in_window_us_per_step"}
    assert harness.system_class(cell).__name__ == "System"
    assert "energy_drift" not in cell.config["guarantees"]
    assert set(cell.traffic["limits"]) == {"pos_gap", "pos_rms", "pos_median", "pe_gap"}


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    res = _tiny_run(seed)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["readings"]["overflow"] == 0.0


@pytest.mark.parametrize("control", ["noise_seed_off_by_one", "thermostat_off", "compensation_off"])
def test_controls_are_not_correct(control):
    overrides = {"noise_seed_off_by_one": {"seed": SEEDS[0] + 1}, "thermostat_off": {"thermostat": "none"},
                 "compensation_off": {"compensated": False}}[control]
    res = _tiny_run(overrides=overrides)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
    if control != "compensation_off":  # plain float32 reads pe_gap among the sound runs (PERF.md)
        assert res["checks"]["pe_gap"]["value"] > res["checks"]["pe_gap"]["limit"], res["checks"]


def _frozen_window(self, force_fn, n_inner, thermostat=None):
    return lambda s: s


def _half_force_window(self, s, n_inner, thermostat=None, last=False):
    def force(*args):
        out = self.force_kernel(*args)
        half = out[0].shape[-1] // 2
        return tuple(torch.cat([t[..., :half], torch.zeros_like(t[..., half:])], -1) for t in out)

    return self._make_window(force, n_inner, thermostat)


def _altered(method):
    def positions(self, s):
        out = method(self, s).clone()
        out[0, 0] += 1e-3
        return out

    return positions


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_particles_unforced", "answer_altered"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    """The three faults of ``port_bench/tests``, planted in the 2D engine
    that this cell's Langevin windows run on."""
    if fault == "state_unchanged":
        monkeypatch.setattr(GridMD, "_make_window", _frozen_window)
    elif fault == "half_the_particles_unforced":
        monkeypatch.setattr(GridMD, "_window_for", _half_force_window)
    else:
        monkeypatch.setattr(GridMD, "positions", _altered(GridMD.positions))
    res = _tiny_run()
    assert not res["correct"], res["checks"]


def test_the_nan_state_reads_nan(monkeypatch):
    """A state gone NaN keeps NaN in the window's worst readings."""
    monkeypatch.setattr(GridMD, "positions", lambda self, s: torch.full((self.n, 2), float("nan")))
    res = _tiny_run()
    assert not res["correct"]
    assert math.isnan(res["readings"]["pos_rms"]) and math.isnan(res["readings"]["pos_gap"])


# -- the readers and the count ----------------------------------------------------------
def test_noise_bound_and_kernel_names():
    least, by = noise.noise_bound(2, 55 * 16 * 2695)  # lj2d-nvt-n1m's grid
    assert by == "bytes" and round(least * 1e6, 2) == 8.50
    assert noise.PHILOX_OPS == 98
    assert kernel_name("_ZN12_GLOBAL__N_121langevin_noise_kernelILi2EEEvPKiPfx5uint2jj") == "langevin_noise_kernel<2>"
    assert kernel_name("void (anonymous namespace)::langevin_noise_kernel<3>(int const*, float*, long long, uint2, "
                       "unsigned int, unsigned int)") == "langevin_noise_kernel<3>"


def test_noise_readers():
    roof = harness._module(harness.HERE / "metrics" / "noise_kernel_roofline.py").read
    pct = harness._module(harness.HERE / "metrics" / "noise_kernel_pct.py").read
    slots = 55 * 16 * 2695
    us = noise.noise_bound(2, slots)[0] * 1e6
    trace = Trace(window_s=1.0, device=[
        ("langevin_noise_kernel<2>", 0.0, 2.0 * us, "x"),
        ("cell_force_counted_kernel<false>", 10.0 * us, 20.0 * us, "x"),
        ("langevin_noise_kernel<2>", 30.0 * us, 32.0 * us, "x"),
    ])
    geo = {"dim": 2, "grid_slots": slots}
    assert roof(harness.Run(n=10**6, trace=trace, geometry=geo)) == pytest.approx(50.0)
    assert roof(harness.Run(n=10**6, trace=Trace(window_s=1.0), geometry=geo)) is None
    assert roof(harness.Run(n=10**6, geometry=geo)) is None
    assert pct(harness.Run(n=1, steps=2000, counters={"noise_cuda.LAUNCHES": 2000})) == 100.0
    assert pct(harness.Run(n=1, steps=2000, counters={"migrate_cuda.PACKED_LAUNCHES": 74})) is None
    assert pct(harness.Run(n=1, steps=0, counters={"noise_cuda.LAUNCHES": 0})) is None


def test_cli_md_langevin_prints_the_noise_launches(capsys):
    rc = cli.main(["md", "--N", "400", "--rho", "0.5", "--cutoff", "2.5", "--force-impl", "grid",
                   "--init", "lattice", "--eq_steps", "20", "--prod_steps", "20", "--sample_every", "20",
                   "--thermostat", "langevin", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "noise kernel launches 0 (one a Langevin step, the warm-up's included; the CPU runs its plain " \
           "version)" in out


# -- the card --------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _n1m_pid(device, seed=4):
    """A pid grid of ``lj2d-nvt-n1m``'s shape (55, 16, 2695): 1M ids in
    random slots, -1 elsewhere."""
    shape = (55, 16, 2695)
    gen = torch.Generator().manual_seed(seed)
    slots = torch.randperm(math.prod(shape), generator=gen)[:1_000_000]
    pid = torch.full((math.prod(shape),), -1, dtype=torch.int32)
    pid[slots] = torch.randperm(1_000_000, generator=gen).to(torch.int32)
    return pid.view(shape).to(device)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 values as integers in their order (-0 and +0 both 0): the
    difference of two is their distance in ulps."""
    bits = x.contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("step", [0, 2**32 + 5])
def test_card_normals_within_4_ulps_and_zeros_on_empty_slots(cuda_device, dim, step):
    pid = _n1m_pid(cuda_device)
    seed = 2**31 + 5 + 0x5EED
    before = noise_cuda.LAUNCHES
    got = noise_cuda.langevin_noise(seed, step, pid, dim)
    assert noise_cuda.LAUNCHES == before + 1 and got.shape == (dim,) + tuple(pid.shape)
    want = noise_cuda.noise_reference(seed, step, pid, dim)
    empty = pid < 0
    assert bool((got[:, empty] == 0).all()) and bool((want[:, empty] == 0).all())
    ulps = (_ordered(got) - _ordered(want)).abs()
    assert int(ulps.max()) <= 4, int(ulps.max())
    z = got[:, ~empty].double()
    assert abs(float(z.mean())) < 5e-3 and abs(float(z.var()) - 1.0) < 5e-3


@pytest.mark.cuda
def test_card_window_agrees_with_the_cpu_window(cuda_device):
    """One 8-step Langevin window of the same state on the card and on the
    CPU: the positions agree to float32 rounding (their RMS gap in box *
    2^-24 units under 1), which the per-window generators never gave."""
    n = 16_384
    box = math.sqrt(n / 0.8)
    pos, vel = lattice.square_lattice(n, box, 1.0, torch.Generator().manual_seed(6))
    out = {}
    for device in ("cpu", cuda_device):
        md = GridMD(make_cell_grid_fn(box, 2.5, n, dim=2), dt=1e-3, compensated=True, device=device)
        s = md.init(pos, vel, seed=2**31 + 5 + 0x5EED, step=2**32 - 4)
        before = noise_cuda.LAUNCHES
        s = md._make_window(md.force_kernel, 8, (1.0, 1.0))(s)
        out[str(device)] = (md.positions(s).cpu().double(), noise_cuda.LAUNCHES - before, s.rng_counter)
    (cpu, cpu_launches, cpu_step), (card, card_launches, card_step) = out["cpu"], out[str(cuda_device)]
    assert (cpu_launches, card_launches) == (0, 8) and cpu_step == card_step == 2**32 + 4
    d = lj_nve._min_image(card - cpu, box)
    rms = float(d.pow(2).mean().sqrt()) / (box * 2.0**-24)
    assert rms < 1.0, rms
