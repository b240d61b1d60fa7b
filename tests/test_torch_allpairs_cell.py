"""The benchmark cell ``lj2d-allpairs-n16k`` (the reference script's own
all-pairs LJ) at a CPU size, through the harness's own comparison with its
plain reference (``port_bench/reference/lj_allpairs.py``): N=1024 (32^2), a
100-step set-up and one 100-step block, as ``tests/test_torch_inlj_cell.py``
cuts its cell. B8 runs its plain version. Sound runs are correct; the two
controls (B8 fed positions rounded to bfloat16, and the tail beyond a 2.5
cutoff left out) and three planted faults are not. The reference holds to
its own equations. Imports no jax."""

import io
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(4)  # 300 all-pairs steps at N=1024 a case

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # port_bench is a directory of the checkout, not a package
    sys.path.insert(0, str(ROOT))

from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops import integrators  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.counts import lattice, pairwise  # noqa: E402
from port_bench.counts.timing import Trace, kernel_name  # noqa: E402
from port_bench.reference import lj_allpairs  # noqa: E402

CELL = "lj2d-allpairs-n16k"
SEEDS = (2**31 + 5, 5300000001)


def _tiny_run(seed: int = SEEDS[0], overrides=None):
    cell = harness.load_cell(CELL)
    cell.config["md"]["n"] = 1024
    cell.traffic.update(eq_steps=100, block_steps=100)
    return harness.measure(cell, seed, 0.0, False, device="cpu", overrides=overrides, log=io.StringIO())


def test_cell_loads_with_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.config["md"]["cutoff"] is None
    assert cell.config["md"]["force_impl"] == "dense_pallas" and cell.config["reduced"] == []
    assert (harness.HERE / cell.config["reference"]).exists()
    assert {m["name"] for m in cell.metrics["end_to_end"]} == {"psteps_per_s", "setup_s"}
    assert {m["name"] for m in cell.metrics["per_layer"]} == {
        "device_idle_pct", "device_ops_per_step", "torch_ops_us_per_step", "pairwise_kernel_roofline",
        "idle_in_window_us_per_step"}
    assert harness.system_class(cell).__name__ == "System"


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    res = _tiny_run(seed)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["readings"]["overflow"] == 0.0


def test_bfloat16_positions_control_is_not_correct(monkeypatch):
    force = pairwise_cuda.lj_force_pairwise

    def rounded(position, p, with_energy=False):
        return force(position.to(torch.bfloat16).float(), p, with_energy)

    monkeypatch.setattr(pairwise_cuda, "lj_force_pairwise", rounded)
    res = _tiny_run()
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_cutoff_control_is_not_correct():
    """The program with a 2.5 cutoff, shifted as the grid paths shift it;
    the reference keeps every pair: the tail left out shows."""
    res = _tiny_run(overrides={"cutoff": 2.5})
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def _frozen_verlet(force_fn, dt, wrap_fn=None):
    init_fn, _ = integrators.velocity_verlet(force_fn, dt, wrap_fn)
    return init_fn, lambda state: state


def _half_unforced(make):
    def make_force_fn(cfg, device="cuda"):
        force_fn = make(cfg, device)

        def half(position):
            f = force_fn(position).clone()
            f[f.shape[0] // 2 :] = 0.0
            return f

        return half

    return make_force_fn


def _blown_up(make):
    def make_force_fn(cfg, device="cuda"):
        force_fn = make(cfg, device)

        def nan(position):
            f = force_fn(position).clone()
            f[0, 0] = float("nan")
            return f

        return nan

    return make_force_fn


def _altered(run):
    def run_trajectory(*args, **kw):
        final, (r_hist, ke_hist, pe_hist) = run(*args, **kw)
        r_hist = r_hist.clone()
        r_hist[:, 0, 0] += 1e-3
        return final, (r_hist, ke_hist, pe_hist)

    return run_trajectory


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_particles_unforced", "answer_altered",
                                   "state_blown_up"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    """The three faults of ``port_bench/tests``, and a state gone NaN (as
    the bfloat16 control leaves it on the card), whose readings must not
    drop out of the window's worst."""
    if fault == "state_unchanged":
        monkeypatch.setattr(lj_fluid, "velocity_verlet", _frozen_verlet)
    elif fault == "half_the_particles_unforced":
        monkeypatch.setattr(lj_fluid, "make_force_fn", _half_unforced(lj_fluid.make_force_fn))
    elif fault == "state_blown_up":
        monkeypatch.setattr(lj_fluid, "make_force_fn", _blown_up(lj_fluid.make_force_fn))
    else:
        monkeypatch.setattr(lj_fluid, "run_trajectory", _altered(lj_fluid.run_trajectory))
    res = _tiny_run()
    assert not res["correct"], res["checks"]


def _start(n=256, seed=11):
    box = math.sqrt(n / 0.8)
    pos, vel = lattice.square_lattice(n, box, 1.0, torch.Generator().manual_seed(seed))
    return pos.double(), vel.double(), lj_allpairs.LJ(box=box)


def test_reference_force_is_minus_the_gradient_of_its_energy(monkeypatch):
    monkeypatch.setattr(lj_allpairs, "ROW_CHUNK", 100)  # several chunks, one ragged
    r, _, p = _start()
    r.requires_grad_(True)
    f, pe = lj_allpairs.forces(r, p, with_energy=True)
    (grad,) = torch.autograd.grad(pe, r)
    assert f.dtype == torch.float64 and float(pe.detach()) < 0
    assert float((f.detach() + grad).norm() / f.detach().norm()) < 1e-10


def test_reference_keeps_momentum_and_energy():
    r, v, p = _start()
    v = v - v.mean(0)
    r1, v1, ke, pe = lj_allpairs.run(r, v, p, 1e-3, 100)
    assert float(v1.sum(0).abs().max()) < 1e-10
    _, pe0 = lj_allpairs.forces(r, p, with_energy=True)
    e0 = float(0.5 * (v * v).sum() + pe0)
    assert abs(float(ke + pe) - e0) < 1e-5 * abs(e0)
    assert float(r1.min()) >= 0 and float(r1.max()) < p.box


def test_reference_imports_neither_jax_nor_the_port():
    blocked = ("jax", "jax_tpus_benchmark_physics_simulation_tpu", "jax_tpus_benchmark_physics_simulation_tpu_torch")
    code = (f"import sys; sys.modules.update(dict.fromkeys({blocked!r})); "
            "from port_bench.reference import lj_allpairs; from port_bench.counts import pairwise; "
            f"assert not [m for m in sys.modules if sys.modules[m] is not None and m.startswith({blocked!r})]")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_b8_bound_and_kernel_names():
    least, by = pairwise.force_bound(16384, 2)
    assert by == "operations" and round(least * 1e3, 5) == 0.08013  # PERF.md's kernel table
    assert kernel_name("_ZN12_GLOBAL__N_118pairwise_lj_kernelILi2ELb0ELb1ELb0EEEvPKfPfi5Consts") \
        == "pairwise_lj_kernel<2, false, true, false>"
    assert kernel_name("void (anonymous namespace)::pairwise_reduce_kernel<2, false>(float const*, float*)") \
        == "pairwise_reduce_kernel<2, false>"


def test_roofline_reader_takes_force_calls_only():
    read = harness._module(harness.HERE / "metrics" / "pairwise_kernel_roofline.py").read
    least, _ = pairwise.force_bound(16384, 2)
    us = least * 1e6
    trace = Trace(window_s=1.0, device=[
        ("pairwise_lj_kernel<2, false, true, false>", 0.0, 3.0 * us, "x"),
        ("pairwise_reduce_kernel<2, false>", 10.0 * us, 11.0 * us, "x"),
        ("pairwise_lj_kernel<2, false, true, false>", 20.0 * us, 23.0 * us, "x"),
        ("pairwise_reduce_kernel<2, false>", 30.0 * us, 31.0 * us, "x"),
        ("pairwise_lj_kernel<2, true, true, false>", 40.0 * us, 50.0 * us, "x"),  # the energy variant
        ("pairwise_reduce_kernel<2, true>", 50.0 * us, 51.0 * us, "x"),
        ("at::native::vectorized_elementwise_kernel<4, add>", 60.0 * us, 61.0 * us, "x"),
    ])
    geo = {"dim": 2, "n": 16384, "row_blocks": 32, "slices": 32, "slice_len": 512}
    run = harness.Run(n=16384, trace=trace, geometry=geo)
    assert read(run) == pytest.approx(25.0)  # 4 bound's worth a call
    assert read(harness.Run(n=16384, geometry=geo)) is None
    assert read(harness.Run(n=16384, trace=trace, geometry={"dim": 2, "n": 16384, "force_impl": "dense_xla"})) is None
    assert read(harness.Run(n=16384, trace=Trace(window_s=1.0), geometry=geo)) is None
