"""The port's op benchmark suite (``bench/*``, ``report/export.write_csv``,
the ``bench`` and ``devices`` CLI) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the ops' matmuls, convolutions and transcendentals run in two
libraries with their own summation orders, so float32 outputs agree at
rtol 1e-5 (atol 1e-5 x max |out|); the FFT ops return a reconstruction
error that is itself float32 roundoff (~1e-11 here), so both are held
below 1e-8 and to each other at that scale. The copy is bit-equal.
"""

import csv

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.bench import flops as jax_flops
from jax_tpus_benchmark_physics_simulation_tpu.bench import ops as jax_ops
from jax_tpus_benchmark_physics_simulation_tpu.bench.runners import (
    compute_core_candidates as jax_core_candidates,
)
from jax_tpus_benchmark_physics_simulation_tpu.bench.runners import run_sweep as jax_run_sweep
from jax_tpus_benchmark_physics_simulation_tpu.core.config import BenchConfig as JaxBenchConfig
from jax_tpus_benchmark_physics_simulation_tpu.report.export import write_csv as jax_write_csv
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench import flops, ops, runners
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.isolate import run_sweep_isolated
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.runners import (
    compute_core_candidates,
    run_sweep,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sysinfo import device_rows, system_info
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import BenchConfig
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import copy_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.report.export import write_csv

RTOL = 1e-5
TINY = dict(warmup=1, repeats=1, steps=2, matrix_size=64, matrix_depth=2, conv_size=16, batch_size=2,
            conv_cin=3, conv_cout=8, max_cores=1)


@pytest.mark.parametrize("n", [1, 2, 64, 1000, 4096])
def test_flops_formulas_equal_jax(n):
    assert flops.matmul_chain_flops(n) == jax_flops.matmul_chain_flops(n)
    assert flops.fft2d_flops(n) == jax_flops.fft2d_flops(n)
    assert flops.fft3d_flops(n, 6) == jax_flops.fft3d_flops(n, 6)
    assert flops.conv_flops(8, n, 3, 3, 3, 64) == jax_flops.conv_flops(8, n, 3, 3, 3, 64)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, JAX op, port op, input shapes); the FFT ops take the precision too
OPS = [
    ("2D", jax_ops.op_2d, ops.op_2d, [(64, 64), (64, 64)]),
    ("3D", jax_ops.op_3d, ops.op_3d, [(2, 64, 64), (2, 64, 64)]),
    ("Conv", jax_ops.op_conv, ops.op_conv, [(2, 16, 16, 3), (3, 3, 3, 8)]),
    ("2D_FFT", jax_ops.op_fft_2d, ops.op_fft_2d, [(64, 64)]),
    ("3D_FFT", jax_ops.op_fft_3d, ops.op_fft_3d, [(2, 64, 64)]),
]


def _call(name, fn, args, precision):
    return fn(*args, precision) if "FFT" in name else fn(*args)


@pytest.mark.parametrize("name,jax_fn,port_fn,shapes", OPS, ids=[o[0] for o in OPS])
def test_op_matches_jax_float32(name, jax_fn, port_fn, shapes):
    arrays = [_normal(i + 1, *s) for i, s in enumerate(shapes)]
    want = np.asarray(_call(name, jax_fn, [jnp.asarray(a) for a in arrays], jnp.float32))
    got = _call(name, port_fn, [torch.from_numpy(a) for a in arrays], torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if "FFT" in name:
        assert 0.0 <= float(got) < 1e-8 and 0.0 <= float(want) < 1e-8
        np.testing.assert_allclose(float(got), float(want), atol=1e-8)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name,jax_fn,port_fn,shapes", OPS, ids=[o[0] for o in OPS])
def test_op_bfloat16_output_dtype_equals_jax(name, jax_fn, port_fn, shapes):
    """bf16 in: bf16 out for the matmul and conv ops; float32 out for the
    FFT ops (JAX computes them in complex64, the port casts to float32)."""
    arrays = [_normal(i + 1, *s) for i, s in enumerate(shapes)]
    want = _call(name, jax_fn, [jnp.asarray(a, jnp.bfloat16) for a in arrays], jnp.bfloat16)
    got = _call(name, port_fn, [torch.from_numpy(a).bfloat16() for a in arrays], torch.bfloat16)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bandwidth_ops_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # stream: four independent x + 1 passes; 4099 elements -> 1024 a stream
    sj, st = jax_ops.make_bandwidth_op(4099, dtype=jdt), ops.make_bandwidth_op(4099, dtype=tdt)
    for attr in ("n_elems", "n_streams", "per_stream", "bytes_per_call"):
        assert getattr(st, attr) == getattr(sj, attr)
    xs = [_normal(20 + i, st.per_stream) for i in range(st.n_streams)]
    outs_j = sj(tuple(jnp.asarray(x, jdt) for x in xs))
    outs_t = st(tuple(torch.from_numpy(x).to(tdt) for x in xs))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    # pallas_copy: 4196 elements truncated to four whole chunks of 1024; the
    # op copies the first n_elems of a longer input, bit for bit
    cj = jax_ops.make_bandwidth_op(4196, dtype=jdt, mode="pallas_copy", chunk=1024)
    ct = ops.make_bandwidth_op(4196, dtype=tdt, mode="pallas_copy", chunk=1024)
    assert ct.n_elems == cj.n_elems == 4096 and ct.bytes_per_call == cj.bytes_per_call
    x = _normal(30, 4196)
    out_j = np.asarray(cj(jnp.asarray(x, jdt)).astype(jnp.float32))
    out_t = ct(torch.from_numpy(x).to(tdt))
    assert out_t.dtype == tdt and out_t.shape == (4096,)
    np.testing.assert_array_equal(out_t.float().numpy(), out_j)


def test_bandwidth_op_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown bandwidth mode"):
        ops.make_bandwidth_op(4096, mode="dma")


def test_chunked_copy_checks_inputs_and_counts_no_cpu_launch():
    before = copy_cuda.COPY_LAUNCHES
    src = torch.arange(10, dtype=torch.float32)
    np.testing.assert_array_equal(copy_cuda.chunked_copy(src).numpy(), np.arange(10))
    assert copy_cuda.chunked_copy(src).data_ptr() != src.data_ptr()
    with pytest.raises(TypeError):
        copy_cuda.chunked_copy(src.double())
    with pytest.raises(ValueError, match="1-D"):
        copy_cuda.chunked_copy(src.reshape(2, 5))
    with pytest.raises(ValueError, match="contiguous"):
        copy_cuda.chunked_copy(torch.zeros(20)[::2])
    # the factory owns the truncation to whole chunks, and an input shorter
    # than its n_elems is refused
    op = ops.make_bandwidth_op(10, mode="pallas_copy", chunk=4)
    np.testing.assert_array_equal(op(src).numpy(), np.arange(8))
    with pytest.raises(ValueError, match="fewer than"):
        ops.make_bandwidth_op(16, mode="pallas_copy", chunk=16)(src)
    assert copy_cuda.COPY_LAUNCHES == before


@pytest.mark.parametrize("max_cores,available", [(8, 8), (6, 8), (1, 8), (16, 8), (0, 1), (3, 1)])
def test_core_candidates_equal_jax(max_cores, available):
    assert compute_core_candidates(max_cores, available) == jax_core_candidates(max_cores, available)


def test_sweep_rows_have_jax_keys_less_xla():
    """Every op once at tiny sizes in both packages: the port's rows carry
    the JAX rows' keys without the compiler-cost columns ``xla_*``."""
    rows_j = jax_run_sweep(JaxBenchConfig(**TINY), log=lambda m: None)
    msgs = []
    rows_t = run_sweep(BenchConfig(**TINY), log=msgs.append, device="cpu")
    assert [r["test"] for r in rows_t] == [name for name, _ in runners.ALL_BENCHMARKS]
    keys_j = {r["test"]: {k for k in r if not k.startswith("xla_")} for r in rows_j}
    for r in rows_t:
        assert set(r) == keys_j[r["test"]], r["test"]
        assert r["cores"] == 1 and r["avg_ms"] > 0
        assert all(np.isfinite(v) for k, v in r.items() if k not in ("test", "cores"))
    assert any("Bandwidth" in m and "GiB/s" in m for m in msgs)


def test_sweep_ops_filter_and_limits():
    rows = run_sweep(BenchConfig(**{**TINY, "max_cores": 0}, ops=("2d", "Conv")), log=lambda m: None,
                     device="cpu")
    assert [r["test"] for r in rows] == ["2D", "Conv"]
    with pytest.raises(ValueError, match="unknown ops"):
        run_sweep(BenchConfig(**TINY, ops=("4D",)), log=lambda m: None, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device"):
        run_sweep(BenchConfig(**{**TINY, "max_cores": 2}), log=lambda m: None, device="cpu")


def test_sysinfo_on_cpu():
    info = system_info("cpu")
    assert info["backend"] == "cpu" and info["device_count"] == 1
    assert info["torch"] == torch.__version__ and info["float32_matmul_precision"] == "highest"
    assert info["conv_tf32"] is False
    rows = device_rows("cpu")
    assert len(rows) == 1 and rows[0]["platform"] == "cpu"


def test_isolated_sweep_survives_a_worker_crash(monkeypatch):
    """Kill the worker at the start of Conv: a loud failure row for Conv, a
    respawned worker, and the 2D_FFT row still produced."""
    monkeypatch.setenv("JTPS_BENCH_CRASH_OP", "Conv")
    msgs = []
    rows, sysinfo, devrows = run_sweep_isolated(BenchConfig(**TINY, ops=("2D", "Conv", "2D_FFT")),
                                                log=msgs.append, device="cpu")
    by_test = {r["test"]: r for r in rows}
    assert set(by_test) == {"2D", "Conv", "2D_FFT"}
    assert "crashed" in by_test["Conv"]["error"]
    assert "avg_ms" in by_test["2D"] and "avg_ms" in by_test["2D_FFT"]
    assert any("DIED" in m for m in msgs)
    assert sysinfo["backend"] == "cpu" and devrows[0]["platform"] == "cpu"


def _read_csv(path):
    with open(path, newline="") as f:
        return f.read()


def test_write_csv_matches_jax(tmp_path):
    """Union-of-keys header, blanks for missing keys, and append under the
    existing header: byte-equal files from both packages."""
    first = [{"test": "2D", "cores": 1, "avg_ms": 1.5, "tflops": 3.0},
             {"test": "Bandwidth", "cores": 1, "avg_ms": 2.0, "bandwidth_gbs": 900.0}]
    second = [{"test": "Conv", "cores": 1, "error": "worker process crashed (exit 139)", "extra": 1}]
    paths = {}
    for tag, fn in (("port", write_csv), ("jax", jax_write_csv)):
        path = str(tmp_path / f"{tag}.csv")
        fn(first, path)
        fn(second, path, append=True)
        fn([], path)  # nothing to write: the file stays
        paths[tag] = path
    assert _read_csv(paths["port"]) == _read_csv(paths["jax"])
    with open(paths["port"], newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["test"] for r in rows] == ["2D", "Bandwidth", "Conv"]
    assert rows[0]["bandwidth_gbs"] == "" and "extra" not in rows[2]


def test_bench_and_devices_cli_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "bench.csv")
    args = ["bench", "--device", "cpu", "-m", "1", "-r", "1", "-mxs", "64", "-md", "2", "-c", "16",
            "-b", "2", "--ops", "2D,2D_FFT", "--csv", path]
    assert cli.main(args) == 0  # the crash-isolated worker
    assert cli.main(args[:-2] + ["--no-isolate", "--precision", "bfloat16"]) == 0
    out = capsys.readouterr().out
    assert out.count("Benchmark results:") == 2 and "test=2D_FFT" in out and "tflops=" in out
    with open(path, newline="") as f:
        assert [r["test"] for r in csv.DictReader(f)] == ["2D", "2D_FFT"]
    assert cli.main(["bench", "--device", "cpu", "--max_cores", "2"]) == 2
    assert cli.main(["devices", "--device", "cpu"]) == 0
    assert "platform=cpu" in capsys.readouterr().out
