"""The port's scaling sweep (``parallel/scaling.py``), the ``mdscale``
CLI, and the row-sharded engine picked by ``lj_fluid`` in a process group,
against the JAX package's rules: the rounded N of every sweep point and
the 3D skin rounded to the device count equal JAX's; ``mdscale`` on 2 gloo
processes runs with trajectory parity; ``lj_fluid.run`` on 2 gloo ranks
picks ``ShardedGridMD`` and reports what the one-process run reports."""

import csv

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig as JaxMDConfig
from jax_tpus_benchmark_physics_simulation_tpu.core.config import override as jax_override
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid as jax_lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.parallel import scaling as jax_scaling
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling
from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.spawn import run_ranks
from tests import torch_sharded as ts

DEVICE_SETS = ([1], [1, 2], [1, 2, 4], [1, 2, 4, 8], [3], [1, 2, 3])


def _cfgs(**kw):
    kw = dict(dict(rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, init="lattice"), **kw)
    return jax_override(JaxMDConfig(), **kw), override(MDConfig(), **kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_round_to_divisible_n_matches_jax(dim):
    for n in (2_000, 20_000, 100_000, 1_000_000):
        jc, tc = _cfgs(n=n, dim=dim)
        for devices in DEVICE_SETS:
            try:
                expected = jax_scaling._round_to_divisible_n(n, jc, devices)
            except ValueError:
                with pytest.raises(ValueError):
                    scaling._round_to_divisible_n(n, tc, devices)
                continue
            assert scaling._round_to_divisible_n(n, tc, devices) == expected, (n, devices)
    # the sizes of the sharded runs on the card: 2D for devices [1, 2, 4]
    # (cps 120) and 3D for [1, 2] (cps 18, skin 0.2778: N stays 100,000)
    if dim == 2:
        assert scaling._round_to_divisible_n(100_000, _cfgs(n=100_000, dim=2)[1], [1, 2, 4]) == 97_044
    else:
        assert scaling._round_to_divisible_n(100_000, _cfgs(n=100_000, dim=3)[1], [1, 2]) == 100_000


def test_3d_skin_rounds_to_devices_as_jax():
    for n in (20_000, 100_000):
        jc, tc = _cfgs(n=n, dim=3, force_impl="grid")
        for d in (1, 2, 3, 4, 8):
            assert lj_fluid.resolve_skin(tc, "grid", n_devices=d) == jax_lj_fluid.resolve_skin(jc, "grid", n_devices=d)
    assert scaling.default_devices(1) == [1] and scaling.default_devices(6) == [1, 2, 4, 6]


def test_mdscale_on_two_gloo_processes(tmp_path, capsys):
    out_csv = tmp_path / "scale.csv"
    rc = cli.main(["mdscale", "--device", "cpu", "--virtual", "2", "--N", "2000", "--steps", "20",
                   "--parity-steps", "10", "--csv", str(out_csv)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "devices=2" in text and "parity_ok=True" in text
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    assert [r["devices"] for r in rows] == ["1", "2"]
    assert rows[1]["parity_ok"] == "True" and float(rows[1]["ms_per_step"]) > 0
    assert int(rows[0]["n"]) == int(rows[1]["n"]) <= 2000


def test_mdscale_refusals(capsys):
    assert cli.main(["mdscale", "--device", "cuda", "--virtual", "2"]) == 2
    assert cli.main(["mdscale", "--device", "cpu", "--manifest", "m.json"]) == 2
    assert "not supported yet" in capsys.readouterr().err


def test_lj_fluid_run_shards_over_two_ranks():
    """``lj_fluid.run`` (2D, N = 4096, cutoff 2.5) in a process group of 2
    builds ``ShardedGridMD`` and returns the one-process run's trajectory
    and energies: the halo kernels' plain versions are bit-equal to the
    whole-grid ones, so only the rank sums (energies, rtol 1e-5) differ.
    At N = 4300 (25 cells per side) the group of 2 refuses to build the
    grid engine rather than run the whole grid on each rank."""
    cfg = override(MDConfig(), n=4096, cutoff=2.5, init="lattice", eq_steps=100, prod_steps=100,
                   sample_every=50)
    one = ts.lj_fluid_run(cfg)
    two = run_ranks(ts.lj_fluid_run, 2, cfg, override(cfg, n=4300))[0]
    assert (one["engine"], two["engine"]) == ("GridMD", "ShardedGridMD")
    assert "2 ranks do not divide the 25 cells per side at N=4300" in two["refused"], two["refused"]
    np.testing.assert_array_equal(two["positions"], one["positions"])
    for name in ("ke", "pe", "pressure"):
        np.testing.assert_allclose(two[name], one[name], rtol=1e-5, err_msg=name)
    assert two["overflow"] is one["overflow"] is False
    assert np.isfinite(two["drift"]) and two["drift"] < 1e-3
