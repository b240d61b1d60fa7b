"""The port's spans and host-read counter (``utils/trace.py``) on the grid
MD path and the dense paths: free when off, bit-neutral when on, nested as
the path is, the counter equal to the drivers' gate reads, and the
attribution of a profiler's device time and idle gaps to spans. Imports no jax: on the card,

    python -m pytest tests/test_torch_trace.py --noconftest -q

also runs the ``cuda`` case, which checks that the spans and the device's
events share the profiler's clock."""

import json
import time
import types

import pytest
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import trace

torch.set_num_threads(2)

# 12 cells a side packed R=6 (B3's layout); 4 samples of 50 steps, each in
# 5-step windows at gate 0.35
SLICE2 = dict(n=1024, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice",
              eq_steps=40, prod_steps=200, sample_every=50, dt=1e-3)
# box 12, 4 cells a side, hybrid B5/B4 with one max_occ read a rebuild
SLICE3 = dict(n=216, rho=0.125, dim=3, cutoff=2.5, force_impl="grid", init="lattice",
              eq_steps=20, prod_steps=40, sample_every=20, dt=1e-3)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _block(slice_, cadence=None, state=None):
    cfg = override(MDConfig(), **slice_)
    state = lj_fluid.init_state(cfg, "cpu") if state is None else state
    return lj_fluid.production(cfg, state, cadence, md=lj_fluid._make_grid_md(cfg, "cpu"))


def _names(spans):
    return [sp.name for sp in spans]


def test_off_is_one_null_context_no_clock_no_recorder(monkeypatch):
    a, b = trace.span("md.x"), trace.span("md.y", new_block=True)
    assert a is b
    with a:
        pass
    assert trace.SPANS == []

    def boom(*_):
        raise AssertionError("the tracer did work while off")

    # off, a whole block reads no clock, makes no span, opens no annotation
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(trace, "_Recorder", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    before = trace.SYNCS
    _block(SLICE2)
    assert trace.SPANS == [] and trace.SYNCS > before


def test_profiler_sees_md_events_only_when_on():
    from torch.profiler import ProfilerActivity, profile

    one_sample = dict(SLICE2, prod_steps=50)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        _block(one_sample)
    assert not [e.name for e in off.events() if e.name.startswith("md.")]
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as on:
        _block(one_sample)
    seen = {e.name for e in on.events() if e.name.startswith("md.")}
    assert seen == {"md.block", "md.block.init", "md.window", "md.rebuild", "md.alloc", "md.sync", "md.sample"}
    assert sum(e.name == "md.sync" for e in on.events()) == _names(trace.SPANS).count("md.sync")


def test_on_and_off_give_bit_equal_blocks():
    final_off, hist_off, of_off = _block(SLICE2)
    trace.enable()
    final_on, hist_on, of_on = _block(SLICE2)
    assert torch.equal(final_on.position, final_off.position)
    assert torch.equal(final_on.velocity, final_off.velocity)
    for got, want in zip(hist_on, hist_off):
        assert torch.equal(got, want)
    assert bool(of_on) == bool(of_off) is False
    assert trace.SPANS


def test_spans_nest_as_the_path_does():
    trace.enable()
    first, _, _ = _block(SLICE2)
    _block(SLICE2, state=first)
    spans = trace.SPANS
    blocks = [i for i, sp in enumerate(spans) if sp.name == "md.block"]
    assert [spans[i].block for i in blocks] == [0, 1]
    assert all(spans[i].parent == -1 for i in blocks)
    for i, sp in enumerate(spans):
        assert sp.end_ns is not None and sp.start_ns <= sp.end_ns
        if sp.name == "md.block":
            continue
        # init, sample, window, rebuild and the gate's reads sit directly in
        # their block: the drivers open no span of their own; a rebuild's
        # allocation sits in its rebuild
        parent = spans[sp.parent]
        assert parent.name == ("md.rebuild" if sp.name == "md.alloc" else "md.block"), (i, sp.name)
        assert sp.block == parent.block, (i, sp.name)
        assert parent.start_ns <= sp.start_ns and sp.end_ns <= parent.end_ns
    inner = [sp.name for sp in spans if sp.block == 0 and sp.name != "md.block"]
    assert inner[0] == "md.block.init" and inner.count("md.sample") == 4
    # a window's span closes before the next span opens
    for a, b in zip(spans, spans[1:]):
        if a.name == "md.window":
            assert a.end_ns <= b.start_ns
    assert _names(spans).count("md.alloc") == _names(spans).count("md.rebuild") > 0
    rows = trace.summary()
    assert rows["md.alloc"]["total_ns"] < rows["md.rebuild"]["total_ns"]
    assert rows["md.block"]["calls"] == 2 and rows["md.block"]["syncs"] == rows["md.sync"]["calls"]
    assert rows["md.window"]["self_ns"] == rows["md.window"]["total_ns"]
    assert rows["md.block"]["self_ns"] < rows["md.block"]["total_ns"]
    assert "md.window" in trace.table(400)


def test_syncs_are_the_2d_gate_reads():
    """The gated driver reads ``dmax2`` before each window and before each
    rebuild the gate trips; each sample's run ends with one more rebuild
    that no read decided."""
    before = trace.SYNCS
    _block(SLICE2)
    off = trace.SYNCS - before
    trace.enable()
    before = trace.SYNCS
    _block(SLICE2)
    on = trace.SYNCS - before
    names = _names(trace.SPANS)
    windows, rebuilds, runs = names.count("md.window"), names.count("md.rebuild"), names.count("md.sample")
    assert rebuilds > runs  # the gate tripped inside the runs
    assert off == on == windows + rebuilds - runs == names.count("md.sync")


def test_syncs_are_the_3d_max_occ_reads():
    """The fixed-cadence driver reads no gate; the hybrid engine reads
    ``max_occ`` once a rebuild period to pick B5 or B4."""
    cfg = override(MDConfig(), **SLICE3)
    md = lj_fluid._make_grid_md(cfg, "cpu")
    assert md._hybrid
    trace.enable()
    before = trace.SYNCS
    lj_fluid.production(cfg, lj_fluid.init_state(cfg, "cpu"), 5, md=md)
    names = _names(trace.SPANS)
    assert names.count("md.rebuild") == names.count("md.window") == names.count("md.alloc") == 8
    assert all(trace.SPANS[sp.parent].name == "md.rebuild" for sp in trace.SPANS if sp.name == "md.alloc")
    assert trace.SYNCS - before == names.count("md.sync") == 8


# all pairs at N=256 (16 x 16 lattice, box 17.9), no cutoff: 3 samples of 20
# steps
DENSE = dict(n=256, rho=0.8, cutoff=None, init="lattice", eq_steps=0, prod_steps=60, sample_every=20, dt=1e-3)


def _dense_block(impl, state=None, **kw):
    cfg = override(MDConfig(), **{**DENSE, "force_impl": impl, **kw})
    state = lj_fluid.init_state(cfg, "cpu") if state is None else state
    return lj_fluid.production(cfg, state)


@pytest.mark.parametrize("impl", ["dense_pallas", "dense_xla"])
def test_dense_paths_open_block_window_and_sample_spans(impl):
    trace.enable()
    first, _, _ = _dense_block(impl)
    _dense_block(impl, state=first, prod_steps=70)  # an unsampled 10-step tail
    spans = trace.SPANS
    blocks = [i for i, sp in enumerate(spans) if sp.name == "md.block"]
    assert [spans[i].block for i in blocks] == [0, 1]
    assert all(spans[i].parent == -1 for i in blocks)
    for sp in spans:
        assert sp.end_ns is not None and sp.start_ns <= sp.end_ns
        if sp.name == "md.block":
            continue
        parent = spans[sp.parent]
        assert parent.name == "md.block" and sp.block == parent.block, sp.name
        assert parent.start_ns <= sp.start_ns and sp.end_ns <= parent.end_ns
    # prod_steps / sample_every windows, each followed by its sample; the
    # tail is one more window
    inner = [[sp.name for sp in spans if sp.block == b and sp.name != "md.block"] for b in (0, 1)]
    assert inner[0] == ["md.window", "md.sample"] * 3
    assert inner[1] == ["md.window", "md.sample"] * 3 + ["md.window"]
    for a, b in zip(spans, spans[1:]):
        if a.name in ("md.window", "md.sample"):
            assert a.end_ns <= b.start_ns
    rows = trace.summary()
    assert rows["md.block"]["calls"] == 2 and rows["md.window"]["calls"] == 7 and rows["md.sample"]["calls"] == 6
    assert rows["md.block"]["syncs"] == 0


@pytest.mark.parametrize("impl", ["dense_pallas", "dense_xla"])
def test_dense_paths_on_and_off_give_bit_equal_blocks(impl):
    final_off, hist_off, of_off = _dense_block(impl, prod_steps=70)
    assert trace.SPANS == []
    trace.enable()
    final_on, hist_on, of_on = _dense_block(impl, prod_steps=70)
    assert torch.equal(final_on.position, final_off.position)
    assert torch.equal(final_on.velocity, final_off.velocity)
    assert torch.equal(final_on.force, final_off.force)
    for got, want in zip(hist_on, hist_off):
        assert got.shape[0] == 3 and torch.equal(got, want)
    assert bool(of_on) == bool(of_off) is False
    assert trace.SPANS


def test_attribute_splits_busy_and_idle_by_span():
    spans = [("md.block", 0.0, 96.5), ("md.window", 10.0, 40.0), ("md.sync", 40.0, 60.0),
             ("md.rebuild", 60.0, 70.0)]
    device = [
        (15.0, 30.0, 12.0),  # launched in the window
        (25.0, 45.0, 20.0),  # overlaps the first: only 30-45 is its own
        (50.0, 55.0, 41.0),  # launched in the sync; the gap 45-50 began in the sync
        (90.0, 95.0, 65.0),  # the rebuild's; the gap 55-90 began in the sync too
        (96.0, 97.0, 80.0),  # launched in the block's own time; gap 95-96 in the block
        (130.0, 140.0, None),  # no launch record; gap 97-130 outside spans
        (150.0, 151.0, 120.0),  # launched outside; gap 140-150 outside
    ]
    busy, idle = trace.attribute(spans, device)
    assert busy == pytest.approx({"md.window": 30e-6, "md.sync": 5e-6, "md.rebuild": 5e-6, "md.block": 1e-6,
                                  trace.UNLAUNCHED: 10e-6, trace.OUTSIDE: 1e-6})
    assert idle == pytest.approx({"md.sync": 40e-6, "md.block": 1e-6, trace.OUTSIDE: 43e-6})
    # busy time is the union of the device intervals; idle the gaps in it
    assert sum(busy.values()) == pytest.approx((151 - 15 - 84) * 1e-6)
    assert sum(busy.values()) + sum(idle.values()) == pytest.approx((151 - 15) * 1e-6)


def test_by_span_reads_a_chrome_trace(tmp_path):
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [
        x("user_annotation", "md.window", 0.0, 25.0),
        x("user_annotation", "other", 0.0, 200.0),  # not a span of the path
        x("cpu_op", "aten::add", 5.0, 4.0),
        x("cuda_runtime", "cudaLaunchKernel", 6.0, 2.0, correlation=7),
        x("cuda_driver", "cuLaunchKernel", 20.0, 2.0, correlation=8),
        x("user_annotation", "md.sync", 30.0, 40.0),
        x("cuda_runtime", "cudaMemcpyAsync", 31.0, 30.0, correlation=9),
        x("kernel", "add", 10.0, 10.0, correlation=7),
        x("kernel", "migrate_kernel<false>", 22.0, 8.0, correlation=8),
        x("gpu_memcpy", "Memcpy DtoH", 40.0, 2.0, correlation=9),
        x("gpu_user_annotation", "md.window", 10.0, 30.0),  # the profiler's copy on the device row
        x("kernel", "orphan", 100.0, 5.0, correlation=99),
        {"ph": "i", "name": "Record Window End", "ts": 300.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, idle = trace.by_span(str(path))
    assert busy == pytest.approx({"md.window": 18e-6, "md.sync": 2e-6, trace.UNLAUNCHED: 5e-6})
    assert idle == pytest.approx({"md.window": 2e-6, "md.sync": 10e-6 + 58e-6})


@pytest.mark.cuda
def test_spans_share_the_profiler_clock_on_the_card(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's events come from CUPTI")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("md.probe"):
            torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
            flag = (x > 0).all()
        assert trace.host_read(flag, bool)
        time.sleep(0.01)  # the card stays idle: the gap began in md.sync
        x.add_(1.0)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    busy, idle = trace.by_span(path)
    assert busy.get("md.probe", 0.0) > 5e-3, busy  # the sleep was launched in its span
    assert idle.get("md.sync", 0.0) > 5e-3, idle  # and the read saw the card run dry
    assert idle["md.sync"] == max(idle.values())
