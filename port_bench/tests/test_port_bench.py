"""CPU tests of the port's benchmark: its files, its yardstick, its refusal
to run without a card, and the comparison that decides ``correct``, which
must pass sound runs and fail the control and the planted faults.

    python -m pytest port_bench/tests -q

from the root of the repository. The runs here are tiny: on the CPU the
port's kernels run their plain PyTorch versions."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.counts import lattice, roofline
from port_bench.counts.timing import Trace, kernel_name, spread

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    names = {m["name"] for m in c.metrics["end_to_end"]}
    assert {"setup_s", "psteps_per_s"} <= names
    reported = names - {"setup_s"}
    assert c.metrics["per_layer"] and all(m["moves"] in reported for m in c.metrics["per_layer"])
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics[kind]:
            assert callable(harness._module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    assert harness.system_class(c).__name__ == "System"
    assert (harness.HERE / c.config["reference"]).exists()
    for name, limit in {**c.config["guarantees"], **c.traffic["limits"]}.items():
        assert limit >= 0, name


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] and data["source"] == c["source"]
    layers = {m["name"]: m["layer"] for m in BENCH["per_layer"]}
    assert layers["device_ops_per_step"] == layers["steps_per_rebuild"]
    assert all(m["moves"] == "psteps_per_s" for m in BENCH["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_fcc_lattice_is_lammps_in_lj_at_64_replicas():
    gen = torch.Generator().manual_seed(2**31 + 11)
    pos, vel, box = lattice.fcc_lattice(2_048_000, 0.8442, 1.44, gen)
    assert pos.shape == (2_048_000, 3) and lattice.fcc_cells(2_048_000) == 80
    assert abs(box - 134.37) < 0.005
    assert abs(2_048_000 / box**3 - 0.8442) < 1e-9
    assert float(pos.min()) >= 0 and float(pos.max()) < box
    assert float(vel.double().sum(0).abs().max()) < 1e-2
    kt = float((vel.double() ** 2).sum()) / (3 * 2_048_000 - 3)
    assert abs(kt - 1.44) < 1e-5


def test_square_lattice_is_bench_py_start():
    gen = torch.Generator().manual_seed(7)
    box = math.sqrt(100_000 / 0.8)
    pos, vel = lattice.square_lattice(100_000, box, 1.0, gen)
    assert pos.shape == vel.shape == (100_000, 2)
    assert float(pos.min()) >= 0 and float(pos.max()) < box
    again, _ = lattice.square_lattice(100_000, box, 1.0, torch.Generator().manual_seed(7))
    assert torch.equal(pos, again)
    # the jitter is clipped at 3 of its 0.05 sigma: no seed draws a closer pair
    per = math.ceil(math.sqrt(100_000))
    g = (torch.arange(per, dtype=torch.float64) + 0.5) * (box / per)
    sites = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)[:100_000]
    off = pos.double() - sites
    off = off - box * torch.round(off / box)
    assert 0.14 < float(off.abs().max()) <= 0.15 + 1e-4


@pytest.mark.parametrize("n, cps, rows, cap, want_ms, want_migrate_ms", [
    (100_000, 121, 1, 16, 0.00112, 0.00467),  # B1 and B2: PERF.md's kernel table
    (1_000_000, 385, 7, 16, 0.01150, 0.04712),  # B3 and packed B2 at N=1M
])
def test_bounds_reproduce_the_kernel_table(n, cps, rows, cap, want_ms, want_migrate_ms):
    box = math.sqrt(n / 0.8)
    pos, _ = lattice.square_lattice(n, box, 1.0, torch.Generator().manual_seed(1))
    census = roofline.pair_census(pos, box, cps, 2.5)
    slots = (cps // rows) * cap * (rows * cps)
    extra = roofline.WORD * cps * cps if rows > 1 else 0
    least, by = roofline.force_bound(census, 2, slots, extra)
    assert by == "bytes" and round(least * 1e3, 5) == want_ms
    least, by = roofline.migrate_bound(11, slots, n)
    assert by == "bytes" and round(least * 1e3, 5) == want_migrate_ms


def test_census_counts_candidates_and_pairs():
    # cells of 5 sigma, 4 a side: 0 and 1 share cell (0, 0), 2 lies in its
    # periodic neighbour (3, 0), 3 in (2, 2), a neighbour of neither
    pos = torch.tensor([[1.0, 1.0], [2.0, 1.0], [19.5, 1.0], [11.0, 11.0]])
    candidates, in_cut = roofline.pair_census(pos, 20.0, 4, 2.5)
    assert candidates == 6
    assert in_cut == 4  # 0-1 at 1.0 and 0-2 at 1.5, each on both partners; 1-2 at 2.5 is outside


def test_kernel_names_and_metric_matches():
    assert kernel_name("_ZN12_GLOBAL__N_122cell_force_tile_kernelILb0EEEv4RowsS1_PfS2_S2_S2_11TileParamsii") \
        == "cell_force_tile_kernel<false>"
    assert kernel_name("void (anonymous namespace)::cell_force3_counted_kernel<0, false>(float const*)") \
        == "cell_force3_counted_kernel<0, false>"
    assert kernel_name("void (anonymous namespace)::migrate3_kernel<(bool)0>(int const*, Planes)") \
        == "migrate3_kernel<false>"
    force = harness._module(harness.HERE / "metrics" / "force_kernel_roofline.py").KERNELS
    assert force.match("cell_force3_counted_kernel<32, false>") and force.match("cell_force_counted_kernel<false>")
    assert not force.match("cell_force_tile_kernel<true>") and not force.match("cell_force3_counted_kernel<32, true>")
    torch_ops = harness._module(harness.HERE / "metrics" / "torch_ops_us_per_step.py").TORCH
    assert torch_ops.search("at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>")
    assert torch_ops.search("Memcpy DtoH (Device -> Pageable)")
    assert not torch_ops.search("migrate_kernel<false>") and not torch_ops.search("cell_force_tile_kernel<false>")


def test_trace_reduction_and_readers():
    trace = Trace(window_s=1.0, device=[
        ("cell_force_tile_kernel<false>", 0.0, 100.0, "aten::empty"),
        ("at::native::add", 50.0, 150.0, "aten::add"),  # overlaps the first
        ("migrate_kernel<false>", 400.0, 450.0, "aten::empty"),
        ("Memset (Device)", 1000.0, 1010.0, "aten::zero_"),
    ])
    assert trace.busy_s == pytest.approx(210e-6)
    assert trace.idle_gaps() == [["before aten::zero_", pytest.approx(550e-6)],
                                 ["before aten::empty", pytest.approx(250e-6)]]
    run = harness.Run(n=1000, steps=200, window_s=0.5, trace=trace, trace_steps=10, untraced_s=420e-6,
                      counters={"migrate_cuda.LAUNCHES": 8, "cell_cuda.LAUNCHES": 200})
    read = {m: harness._module(harness.HERE / "metrics" / f"{m}.py").read for m in (
        "psteps_per_s", "device_idle_pct", "device_ops_per_step", "steps_per_rebuild", "torch_ops_us_per_step")}
    assert read["psteps_per_s"](run) == pytest.approx(4e5)
    assert read["device_idle_pct"](run) == pytest.approx(50.0)
    assert read["device_ops_per_step"](run) == pytest.approx(0.4)
    assert read["steps_per_rebuild"](run) == pytest.approx(25.0)
    assert read["torch_ops_us_per_step"](run) == pytest.approx(11.0)
    assert read["steps_per_rebuild"](harness.Run(n=1)) is None
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_harness_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['jax_tpus_benchmark_physics_simulation_tpu'] = None; "
            "from port_bench import harness, readings, sets; import port_bench.run; "
            "from port_bench.reference import lj_nve; "
            "[harness._module(p) for d in ('metrics', 'systems') for p in (harness.HERE / d).glob('*.py')]; "
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m] is not None)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_run_without_a_card_fails_loudly(tmp_path):
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "lj2d-n1m", "--seed", "3000000019",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "lj2d-n1m", "--seed", "1",
                           "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "No module named 'jax_tpus_benchmark_physics_simulation_tpu_torch'" in proc.stderr


# -- the comparison that decides `correct`, on tiny runs of each cell ----------

TINY = {"lj2d-n1m": 4096, "lj3d-inlj-2m": 4000}
# cells whose files are kept while the cell stays out of BENCHMARK.json
# (PERF.md, Open questions): their traffic's name and configuration's file
HELD_OUT = {"lj3d-inlj-2m": "lj3d-lammps-inlj"}


def load(name):
    if name not in HELD_OUT:
        return harness.load_cell(name)
    config = json.loads((harness.HERE / "configs" / f"{HELD_OUT[name]}.json").read_text())
    traffic = json.loads((harness.HERE / "workloads" / f"{name}.json").read_text())
    return harness.Cell(name, 1, config, traffic, {"end_to_end": [], "per_layer": []})


def test_held_out_cells_stay_out():
    assert not set(HELD_OUT) & {w["name"] for w in BENCH["workloads"]}
    for name in HELD_OUT:
        c = load(name)
        assert (harness.HERE / c.config["reference"]).exists() and c.traffic["limits"]


def tiny_cell(name):
    """The cell at a CPU size: its own configuration, limits and block
    structure, with N, the set-up and the block cut to 100 steps (one
    sample)."""
    c = load(name)
    md = c.config["md"] if "n" in c.config["md"] else c.traffic["md"]
    md["n"] = TINY[name]
    c.traffic.update(eq_steps=100, block_steps=100)
    return c


def tiny_run(name, seed=2**31 + 5, overrides=None):
    import io

    return harness.measure(tiny_cell(name), seed, 0.0, False, device="cpu", overrides=overrides, log=io.StringIO())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct_and_the_control_is_not(cell):
    sound = tiny_run(cell)
    assert sound["correct"], sound["checks"]
    control = tiny_run(cell, overrides={"compensated": False})  # plain float32 integration
    assert not control["correct"], control["checks"]
    assert control["failed"] >= 1


def _frozen_window(self, force_fn, n_inner, thermostat=None):
    return lambda s: s


def _half_force_window(self, s, n_inner, thermostat=None):
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
@pytest.mark.parametrize("cell", ["lj2d-n1m", "lj3d-inlj-2m"])
def test_planted_faults_are_not_correct(cell, fault, monkeypatch):
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3

    for cls in (GridMD, GridMD3):
        if fault == "state_unchanged":
            monkeypatch.setattr(cls, "_make_window", _frozen_window)
        elif fault == "half_the_particles_unforced":
            monkeypatch.setattr(cls, "_window_for", _half_force_window)
        else:
            monkeypatch.setattr(cls, "positions", _altered(cls.positions))
    res = tiny_run(cell)
    assert not res["correct"], res["checks"]
