"""The port's spans and host-read counter (``utils/trace.py``) on the grid
MD path and the dense paths: free when off, recorded under a profiler with
the tracer off and on the profiler's clock, bit-neutral when on, nested as
the path is, the counter equal to the drivers' gate reads, the attribution
of a profiler's device time and idle gaps to spans, and the benchmark's
readers of the spans (``port_bench/counts/spans.py`` and the four
``port_bench/metrics/*`` that use it). Imports no jax: on the card,

    python -m pytest tests/test_torch_trace.py --noconftest -q

also runs the ``cuda`` case, which checks that the spans and the device's
events share the profiler's clock."""

import json
import random
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # port_bench is a directory of the checkout, not a package
    sys.path.insert(0, str(ROOT))

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import profiling, trace  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.counts import spans as bench_spans  # noqa: E402
from port_bench.counts.timing import Trace  # noqa: E402

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

    # off and unprofiled, a whole block reads no clock, makes no span,
    # opens no annotation
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=boom, perf_counter_ns=boom))
    monkeypatch.setattr(trace, "_Recorder", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    before = trace.SYNCS
    _block(SLICE2)
    assert trace.SPANS == [] and trace.SYNCS > before


def test_profiler_sees_md_events_only_when_on():
    """Under a profiler the spans record with the tracer off, as
    ``record_function`` does, and leave no event among the profiler's: they
    share its clock instead (the next test)."""
    from torch.profiler import ProfilerActivity, profile

    one_sample = dict(SLICE2, prod_steps=50)
    before = trace.SYNCS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _block(one_sample)
    assert not [e.name for e in prof.events() if e.name.startswith("md.")]
    names = _names(trace.SPANS)
    assert set(names) == {"md.block", "md.block.init", "md.window", "md.rebuild", "md.alloc", "md.sync", "md.sample"}
    assert all(sp.end_ns is not None for sp in trace.SPANS)
    assert names.count("md.sync") == trace.SYNCS - before > 0
    # the profiler gone, nothing more records
    _block(one_sample)
    assert _names(trace.SPANS) == names


def test_a_span_holds_its_aten_op_on_the_profilers_clock():
    """A span around an aten op contains the op's ``[start_ns, end_ns]`` as
    the profiler's records give it, within 5 us."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x.mul(2.0)  # the profiler's first op is recorded late
        for _ in range(5):
            with trace.span("md.probe"):
                x.add(1.0)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events() if e.name() == "aten::add")
    probes = [(sp.start_ns, sp.end_ns) for sp in trace.SPANS if sp.name == "md.probe"]
    assert len(ops) == len(probes) == 5
    for (start, end), (a, b) in zip(ops, probes):
        assert a - 5_000 <= start <= end <= b + 5_000, (a - start, b - end)


def test_recording_allocates_nothing_the_collector_tracks():
    """``SPANS`` keeps its columns in lists of strs and ints: kept span
    objects would count toward the collector's threshold and set off
    collections inside the (profiled) window the spans record."""
    import gc

    flag = torch.zeros((), dtype=torch.bool)
    trace.enable()
    gc.disable()
    try:
        before = gc.get_count()[0]
        for _ in range(1000):
            with trace.span("md.window"):
                trace.host_read(flag, bool)
        grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert len(trace.SPANS) == 2000 and grown == 0
    spans = trace.SPANS
    assert [sp.name for sp in spans[:2]] == ["md.window", "md.sync"] and spans[1].parent == 0
    assert all(sp.end_ns is not None for sp in spans)


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


BASE_NS = 1_790_000_000_000_000_000  # a Unix time in ns, as the profiler's clock reads


def _span(name, start_us, end_us):
    sp = trace.Span(name, BASE_NS + round(start_us * 1e3), -1, None)
    sp.end_ns = BASE_NS + round(end_us * 1e3)
    return sp


def test_by_span_reads_a_chrome_trace(tmp_path):
    """The device's ops and their launches from the trace, shifted by its
    ``baseTimeNanoseconds``; the spans from ``SPANS``. An annotation in the
    trace is no span, whatever its name."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    origin_us = 1000.0  # the trace's base lies 1 ms before the spans' clock reads 0 here
    events = [
        x("user_annotation", "md.window", 50.0, 500.0),  # not a span: spans come from SPANS
        x("user_annotation", "other", 0.0, 200.0),
        x("cpu_op", "aten::add", 1005.0, 4.0),
        x("cuda_runtime", "cudaLaunchKernel", 1006.0, 2.0, correlation=7),
        x("cuda_driver", "cuLaunchKernel", 1020.0, 2.0, correlation=8),
        x("cuda_runtime", "cudaMemcpyAsync", 1031.0, 30.0, correlation=9),
        x("kernel", "add", 1010.0, 10.0, correlation=7),
        x("kernel", "migrate_kernel<false>", 1022.0, 8.0, correlation=8),
        x("gpu_memcpy", "Memcpy DtoH", 1040.0, 2.0, correlation=9),
        x("gpu_user_annotation", "md.window", 1010.0, 30.0),  # a device-row copy: no device op
        x("kernel", "orphan", 1100.0, 5.0, correlation=99),
        {"ph": "i", "name": "Record Window End", "ts": 1300.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE_NS - round(origin_us * 1e3), "traceEvents": events}))
    trace.SPANS.extend([_span("md.window", 0.0, 25.0), _span("md.sync", 30.0, 70.0)])
    busy, idle = trace.by_span(str(path))
    assert busy == pytest.approx({"md.window": 18e-6, "md.sync": 2e-6, trace.UNLAUNCHED: 5e-6})
    assert idle == pytest.approx({"md.window": 2e-6, "md.sync": 10e-6 + 58e-6})
    # spans passed in place of SPANS; an open span is left out
    open_span = trace.Span("md.rebuild", BASE_NS, -1, None)
    assert trace.by_span(str(path), trace.SPANS + [open_span]) == (busy, idle)


@pytest.mark.cuda
def test_spans_share_the_profiler_clock_on_the_card(tmp_path):
    """With the tracer off, a profiled run's spans and its device events
    meet on one clock: the card's sleep lies in the span it was launched
    from, and the idle after a host read begins in ``md.sync``."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's events come from CUPTI")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # after other profiler sessions in the process a session can come
        # back without its first device records: markers go first, as
        # utils/profiling queues them
        for _ in range(profiling._PAD):
            torch.cuda._sleep(1)
        with trace.span("md.probe"):
            torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
            flag = (x > 0).all()
        assert trace.host_read(flag, bool)
        time.sleep(0.01)  # the card stays idle: the gap began in md.sync
        x.add_(1.0)
        torch.cuda.synchronize()
    assert _names(trace.SPANS) == ["md.probe", "md.sync"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    busy, idle = trace.by_span(path)
    assert busy.get("md.probe", 0.0) > 5e-3, busy  # the sleep was launched in its span
    assert idle.get("md.sync", 0.0) > 5e-3, idle  # and the read saw the card run dry
    assert idle["md.sync"] == max(idle.values())
    # the profiler's device row holds no copy of a span
    assert not [e.name for e in prof.events() if e.name.startswith("md.")]


# -- the benchmark's readers of the spans ---------------------------------------

READERS = ("host_syncs_per_step", "idle_after_sync_us_per_step", "idle_in_rebuild_us_per_step",
           "idle_in_window_us_per_step")


def _read(name, run):
    return harness._module(harness.HERE / "metrics" / f"{name}.py").read(run)


def _device(intervals_us):
    """``Trace.device`` rows on the profiler's clock (us)."""
    return [("k", BASE_NS * 1e-3 + s, BASE_NS * 1e-3 + e, "unknown") for s, e in intervals_us]


# spans (us after BASE_NS): a block holding windows, reads, a rebuild with
# its allocation and a partner list's build
SYNTH_SPANS = [("md.block", 0, 1000), ("md.window", 10, 40), ("md.sync", 40, 60), ("md.rebuild", 60, 90),
               ("md.alloc", 62, 70), ("md.list", 90, 95), ("md.window", 95, 130), ("md.sync", 135, 138)]
# device ops (us): each gap begins where the comment says
SYNTH_OPS = [(12, 30), (26, 34), (30, 38),  # overlapping: one busy stretch
             (45, 50),  # gap 38-45 began in md.window: 7
             (64, 66),  # gap 50-64 in md.sync: 14
             (72, 80),  # gap 66-72 in md.alloc: 6
             (92, 93),  # gap 80-92 in md.rebuild, after md.alloc: 12
             (100, 120),  # gap 93-100 in md.list: 7
             (125, 130),  # gap 120-125 in md.window: 5
             (140, 150),  # gap 130-140 began as md.window ended, before md.sync opened: md.block
             (1200, 1210),  # gap 150-1200 in md.block
             (1300, 1310)]  # gap 1210-1300 outside every span
SYNTH_IDLE_US = {"md.window": 12, "md.sync": 14, "md.alloc": 6, "md.rebuild": 12, "md.list": 7,
                 "md.block": 10 + 1050, bench_spans.OUTSIDE: 90}


def _synthetic_run(steps=10):
    trace.SPANS.extend(_span(name, a, b) for name, a, b in SYNTH_SPANS)  # the readers need no parents
    return harness.Run(n=1, trace=Trace(window_s=1.31e-3, device=_device(SYNTH_OPS)), trace_steps=steps)


def test_readers_split_a_synthetic_window():
    run = _synthetic_run()
    got = {name: _read(name, run) for name in READERS}
    assert got == pytest.approx({"host_syncs_per_step": 0.2, "idle_after_sync_us_per_step": 1.4,
                                 "idle_in_rebuild_us_per_step": 2.5, "idle_in_window_us_per_step": 1.2})
    spans = bench_spans.recorded(run)
    idle = bench_spans.idle_by_span(spans, [(s, e) for _, s, e, _ in run.trace.device])
    assert idle == pytest.approx({k: v * 1e-6 for k, v in SYNTH_IDLE_US.items()})
    # every gap counted once: the window's span less its busy time
    first = min(s for _, s, _, _ in run.trace.device)
    last = max(e for _, _, e, _ in run.trace.device)
    assert sum(idle.values()) == pytest.approx((last - first) * 1e-6 - run.trace.busy_s)


def test_readers_read_nothing_without_a_trace_or_spans():
    run = _synthetic_run()
    untraced = harness.Run(n=1)
    assert all(_read(name, untraced) is None for name in READERS)
    trace.reset()  # a program that recorded no spans in the traced window
    assert all(_read(name, run) is None for name in READERS)
    trace.SPANS.append(trace.Span("md.window", BASE_NS, -1, None))  # still open: not a span yet
    assert all(_read(name, run) is None for name in READERS)


def _nested_spans(rng, a, b, depth, out):
    """Random spans nested inside ``[a, b)``, some sharing an end point."""
    t = a
    while depth and t < b:
        start = t + rng.choice([0, rng.randrange(1, 20)])
        end = min(b, start + rng.randrange(0, 80))
        if start >= b:
            break
        out.append((rng.choice(["md.window", "md.sync", "md.rebuild", "md.alloc", "md.list", "md.block"]),
                    start, end))
        _nested_spans(rng, start, end, depth - 1, out)
        t = end + rng.choice([0, rng.randrange(1, 10)])
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_benchmark_idle_split_is_the_programs(seed):
    """``counts/spans.idle_by_span`` and ``trace.attribute``'s idle agree on
    the synthetic window and on random nested spans and device ops."""
    rng = random.Random(seed)
    cases = [(SYNTH_SPANS, SYNTH_OPS)]
    for _ in range(20):
        spans = _nested_spans(rng, 0, 2000, 3, [])
        ops = []
        for _ in range(rng.randrange(1, 60)):
            s = rng.randrange(-50, 2050)
            ops.append((s, s + rng.randrange(0, 40)))
        cases.append((spans, ops))
    for spans, ops in cases:
        _, want = trace.attribute(spans, [(s, e, None) for s, e in ops])
        got = bench_spans.idle_by_span(spans, ops)
        assert got.keys() == want.keys()
        assert got == pytest.approx(want, abs=1e-12)


def test_host_syncs_reader_counts_the_reads_of_a_profiled_block():
    """A CPU grid block under the profiler: ``host_syncs_per_step`` times the
    steps is the ``trace.SYNCS`` difference; with no device events the idle
    readers read 0."""
    from torch.profiler import ProfilerActivity, profile

    before = trace.SYNCS
    with profile(activities=[ProfilerActivity.CPU]):
        _block(SLICE2)
    syncs = trace.SYNCS - before
    steps = SLICE2["prod_steps"]
    run = harness.Run(n=SLICE2["n"], trace=Trace(window_s=1.0), trace_steps=steps)
    assert syncs > 0 and _read("host_syncs_per_step", run) * steps == pytest.approx(syncs)
    assert [_read(name, run) for name in READERS[1:]] == [0.0, 0.0, 0.0]
