"""Device-time measurement with ``torch.profiler`` (CUPTI).

:func:`profile_device` runs a function under the profiler and sums the time
the card spent in kernels, memcpys and memsets. Divided by the same work's
wall time measured *without* the profiler (whose host overhead would
inflate the wall time), it gives the card's busy share; one minus it is the
idle share. :func:`window_sync_cost` times the host sync that the gated
production driver makes once per window.
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


def window_sync_cost(md, gs, n_inner: int, n_windows: int = 25, repeats: int = 5) -> Tuple[float, float]:
    """Wall ms per step of ``n_windows`` leapfrog windows of ``md`` from
    state ``gs``: with the host read of ``dmax2`` after every window that
    the gated driver makes, and with one synchronize at the end. Their
    difference is what the per-window sync costs. Medians over ``repeats``
    alternating runs, after one warm run of each."""
    window = md._make_window(md.force_kernel, n_inner)

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

    timed(True)
    timed(False)
    synced, unsynced = [], []
    for _ in range(repeats):
        synced.append(timed(True))
        unsynced.append(timed(False))
    return statistics.median(synced), statistics.median(unsynced)
