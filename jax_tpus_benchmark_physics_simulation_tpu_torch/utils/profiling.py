"""Device-time measurement with ``torch.profiler`` (CUPTI).

:func:`profile_device` runs a function under the profiler and sums the time
the card spent in kernels, memcpys and memsets. Divided by the same work's
wall time measured *without* the profiler (whose host overhead would
inflate the wall time), it gives the card's busy share; one minus it is the
idle share. :func:`device_op_count` counts that work by name. The host
time of the MD path's layers and its host reads are spans
(``utils/trace.py``). :func:`cuda_ms` times a call on the card with CUDA events,
:func:`interleaved_ms` several calls in turns, :func:`spread` prints one
of its results, :func:`host_us` times a call on the host's clock.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Tuple

import torch

# On the H100 a profiler session has come back without its first device
# records (a rebuild's first launches missing from a capture of one
# rebuild), or with none, after other sessions in the same process. A
# capture therefore queues _PAD marker launches (``torch.cuda._sleep``'s
# spin kernel, a few cycles each) before ``fn`` and one after it; the
# markers are left out of what it reports.
_MARKER = "spin_kernel"
_PAD = 64
_TRIES = 4


def _capture(fn: Callable[[], object]):
    """``(prof, events, complete)``: a profiler session of ``fn()``
    between the markers, its device events (kernels, memcpys, memsets)
    without them, and whether the capture holds all of ``fn``'s: a leading
    marker and the trailing one (the last to start) both in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("the profiler measures the card: no CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_PAD):
            torch.cuda._sleep(1)
        fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    work = [e for e in events if _MARKER not in e.name]
    last = max(events, key=lambda e: e.time_range.start, default=None)
    complete = len(events) - len(work) >= 2 and last is not None and _MARKER in last.name
    return prof, work, complete


def profile_device(fn: Callable[[], object], trace_path: str) -> Tuple[float, str, Dict[str, float]]:
    """Runs ``fn()`` once under the profiler. Returns ``(device_s, table,
    by_name)``: the summed device time of all work on the card, the
    per-kernel table sorted by device time, and the device seconds of each
    kernel name. Writes a chrome trace to ``trace_path``. Needs a CUDA
    device. The program's spans (``utils/trace.py``) record into
    ``trace.SPANS`` on the profiler's clock and open no profiler range; a
    caller's own ``record_function`` range has a copy on the device's
    timeline, which is no work and is not counted."""
    prof, events, _ = _capture(fn)
    by_name: Dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total * 1e-6
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    prof.export_chrome_trace(trace_path)
    return sum(by_name.values()), table, by_name


def device_op_count(fn: Callable[[], object]) -> Dict[str, int]:
    """``{name: count}`` of the work ``fn()`` puts on the card (kernels,
    memcpys, memsets), from ``torch.profiler``; a capture that came back
    incomplete is made again (``fn`` runs again), at most ``_TRIES``
    times. Needs a CUDA device."""
    for _ in range(_TRIES):
        _, events, complete = _capture(fn)
        if complete:
            counts: Dict[str, int] = {}
            for e in events:
                counts[e.name] = counts.get(e.name, 0) + 1
            return counts
    raise RuntimeError(f"the profiler lost device records in {_TRIES} captures in a row")


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

