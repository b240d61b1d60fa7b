"""Device-time measurement with ``torch.profiler`` (CUPTI).

:func:`profile_device` runs a function under the profiler and sums the time
the card spent in kernels, memcpys and memsets. Divided by the same work's
wall time measured *without* the profiler (whose host overhead would
inflate the wall time), it gives the card's busy share; one minus it is the
idle share. :func:`device_op_count` counts that work by name.
:func:`window_sync_cost` times the host sync that the gated
drivers make once per window, :func:`rebuild_read_cost` the host read of
``max_occ`` that the 3D engine's hybrid kernel choice makes once per
rebuild period. :func:`cuda_ms` times a call on the card with CUDA events,
:func:`interleaved_ms` several calls in turns, :func:`spread` prints one
of its results, :func:`host_us` times a call on the host's clock.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Tuple

import torch


def profile_device(fn: Callable[[], object], trace_path: str) -> Tuple[float, str, Dict[str, float]]:
    """Runs ``fn()`` once under the profiler. Returns ``(device_s, table,
    by_name)``: the summed device time of all work on the card, the
    per-kernel table sorted by device time, and the device seconds of each
    kernel name. Writes a chrome trace to ``trace_path``. Needs a CUDA
    device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_device measures the card: no CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total * 1e-6
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    prof.export_chrome_trace(trace_path)
    return sum(by_name.values()), table, by_name


def device_op_count(fn: Callable[[], object]) -> Dict[str, int]:
    """``{name: count}`` of the work ``fn()`` puts on the card (kernels,
    memcpys, memsets), from ``torch.profiler``. Needs a CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts: Dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def cuda_ms(fn: Callable[[], object], reps: int, lead: bool = False) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, from
    CUDA events, after a warm call. A second untimed call is still running
    when the start event is recorded, so the card does not sit idle while
    the host prepares the first timed call (a wrapper's host time, up to
    tens of us, would otherwise count once in every ``reps`` calls). With
    ``lead``, the card first spins for about 5 ms, long enough for the host
    to queue every timed call: a kernel shorter than its wrapper's host time
    then runs back to back and is timed alone, not the host."""
    fn()
    torch.cuda.synchronize()
    if lead:
        torch.cuda._sleep(10_000_000)  # clock cycles: ~5 ms at the H100's ~1.98 GHz
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(
    fns: Dict[str, Callable[[], object]], repeats: int = 7, reps: int = 20, lead: bool = False
) -> Dict[str, Tuple[float, float, float]]:
    """``{name: (median, min, max)}`` of each function's mean device ms over
    ``reps`` calls (:func:`cuda_ms`, ``lead`` passed on), in ``repeats``
    rounds that take the functions in turn, so that a drift of the card's
    clock falls on all."""
    runs: Dict[str, list] = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(cuda_ms(fn, reps, lead))
    return {name: (statistics.median(v), min(v), max(v)) for name, v in runs.items()}


def spread(t: Tuple[float, float, float]) -> str:
    """A ``(median, min, max)`` triple of :func:`interleaved_ms` as text."""
    return f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})"


def host_us(fn: Callable[[], object], reps: int = 200) -> float:
    """Host microseconds a call of ``fn()``, work on the card included:
    ``reps`` calls after one warm call, ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def _paired_medians(timed: Callable[[bool], float], repeats: int) -> Tuple[float, float]:
    """Medians of ``timed(True)`` and ``timed(False)`` over ``repeats``
    alternating runs, after one warm run of each."""
    timed(True)
    timed(False)
    on, off = [], []
    for _ in range(repeats):
        on.append(timed(True))
        off.append(timed(False))
    return statistics.median(on), statistics.median(off)


def window_sync_cost(md, gs, n_inner: int, n_windows: int = 25, repeats: int = 5) -> Tuple[float, float]:
    """Wall ms per step of ``n_windows`` leapfrog windows of ``md`` from
    state ``gs``: with the host read of ``dmax2`` after every window that
    the gated drivers make, and with one synchronize at the end. Their
    difference is what the per-window sync costs."""
    window = md._window_for(gs, n_inner)

    def timed(sync_each: bool) -> float:
        s = gs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_windows):
            s = window(s)
            if sync_each:
                bool(md._needs_rebuild(s))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n_windows * n_inner)

    return _paired_medians(timed, repeats)


def rebuild_read_cost(md, gs, cadence: int, n_blocks: int = 25, repeats: int = 5) -> Tuple[float, float]:
    """Wall ms per step of ``n_blocks`` blocks of the 3D fixed-cadence
    driver (a rebuild, then a ``cadence``-step window) from state ``gs``:
    with the host read of ``max_occ`` after every rebuild that picks the
    window's kernel (B5 or B4), and with the kernel picked once before the
    run. Their difference is what the read costs; the second run is exact
    only while no rebuild changes the pick."""
    window = md._window_for(gs, cadence)

    def timed(read_each: bool) -> float:
        s = gs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            s = md._rebuild_migrate(s)
            s = (md._window_for(s, cadence) if read_each else window)(s)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n_blocks * cadence)

    return _paired_medians(timed, repeats)
