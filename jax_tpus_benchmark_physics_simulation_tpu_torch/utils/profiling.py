"""Device-time measurement with ``torch.profiler`` (CUPTI).

:func:`profile_device` runs a function under the profiler and sums the time
the card spent in kernels, memcpys and memsets. Divided by the same work's
wall time measured *without* the profiler (whose host overhead would
inflate the wall time), it gives the card's busy share; one minus it is the
idle share. :func:`window_sync_cost` times the host sync that the gated
drivers make once per window, :func:`rebuild_read_cost` the host read of
``max_occ`` that the 3D engine's hybrid kernel choice makes once per
rebuild period.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Tuple

import torch


def profile_device(fn: Callable[[], object], trace_path: str) -> Tuple[float, str]:
    """Runs ``fn()`` once under the profiler. Returns ``(device_s, table)``:
    the summed device time of all work on the card, and the per-kernel
    table sorted by device time. Writes a chrome trace to ``trace_path``.
    Needs a CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_device measures the card: no CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    prof.export_chrome_trace(trace_path)
    return device_us * 1e-6, table


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
