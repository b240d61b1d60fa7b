"""The benchmark cell ``lj3d-inlj-2m`` (LAMMPS's ``bench/in.lj``) at a CPU
size, through the harness's own comparison with the plain reference
(``port_bench/reference/lj_nve.py``): N=4000, a 100-step set-up and one
100-step block, as ``port_bench/tests/test_port_bench.py``'s ``tiny_cell``
cuts it. From in.lj's fcc start the first rebuilds find more than the 3D
engine's k_mov = 16 movers in a cell on seed 5300000001; B6 moves them all,
so the run is correct and reads no ``overflow`` (it read 1 while the mover
flag fed it). The plain-float32 control (``compensated`` off) is not
correct. Imports no jax; the port's kernels run their plain versions."""

import io
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(4)  # 300 steps of the plain 3D force a case

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # port_bench is a directory of the checkout, not a package
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

SEEDS = (5300000001, 5500000007)


def _tiny_run(seed: int, overrides=None):
    cell = harness.load_cell("lj3d-inlj-2m")
    cell.config["md"]["n"] = 4000
    cell.traffic.update(eq_steps=100, block_steps=100)
    return harness.measure(cell, seed, 0.0, False, device="cpu", overrides=overrides, log=io.StringIO())


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct_with_no_overflow(seed):
    res = _tiny_run(seed)
    assert res["correct"], res["checks"]
    assert res["readings"]["overflow"] == 0.0 and res["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_float32_control_is_not_correct(seed):
    res = _tiny_run(seed, overrides={"compensated": False})
    assert not res["correct"], res["checks"]
    assert res["readings"]["overflow"] == 0.0 and res["failed"] >= 1
