"""The program's spans in the traced window, and the card's idle split by
the span open on the host when each gap began.

Whenever a ``torch.profiler`` run is active, the program records its
spans (``utils/trace.py``'s ``SPANS``, named ``md.*``) on the profiler's
clock, Unix nanoseconds. The harness profiles only the traced window, so
the spans in memory after a run are exactly that window's, on the clock of
``Trace.device``'s microseconds. A program that records no spans there
leaves none, and the readers of this file then read nothing.

The arithmetic is the benchmark's own: a gap between device operations
(where no operation runs, ``Trace.busy_s``'s union) is given to the
innermost span open at the gap's first instant, a span being open at t when
``start <= t < end``.
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

TRACE_MODULE = "jax_tpus_benchmark_physics_simulation_tpu_torch.utils.trace"
OUTSIDE = "(outside spans)"  # the key of gaps that begin where no span is open

Record = Tuple[str, float, float]  # name, start us, end us


def recorded(run) -> Optional[List[Record]]:
    """The program's finished spans as ``(name, start us, end us)``, or
    None where the run has no trace or the program recorded no span."""
    if run.trace is None or not run.trace_steps:
        return None
    mod = sys.modules.get(TRACE_MODULE)
    spans = getattr(mod, "SPANS", None) or []
    out = [(sp.name, sp.start_ns * 1e-3, sp.end_ns * 1e-3) for sp in spans if sp.end_ns is not None]
    return out or None


def gaps(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The ``(start, end)`` stretches between the first and the last device
    interval in which none runs."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def idle_by_span(spans: Sequence[Record], intervals: Sequence[Tuple[float, float]]) -> Dict[str, float]:
    """``{span name: idle seconds}``: each gap of :func:`gaps` under the
    innermost span open when it began (:data:`OUTSIDE` where none is).

    Spans nest, so every span open at t encloses the last span to start at
    or before t: the innermost open one is that span or its nearest
    enclosing span that has not ended by t."""
    order = sorted(spans, key=lambda sp: (sp[1], -sp[2]))  # an enclosing span before what it encloses
    starts = [sp[1] for sp in order]
    parent, stack = [], []
    for i, (_, s, _) in enumerate(order):
        while stack and order[stack[-1]][2] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    idle: Dict[str, float] = {}
    for a, b in gaps(intervals):
        i = bisect_right(starts, a) - 1
        while i >= 0 and order[i][2] <= a:
            i = parent[i]
        key = order[i][0] if i >= 0 else OUTSIDE
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    return idle


def idle_us_per_step(run, names: Sequence[str]) -> Optional[float]:
    """Device idle microseconds a traced step in gaps that began inside a
    span named in ``names``; None without a trace or spans."""
    spans = recorded(run)
    if spans is None:
        return None
    idle = idle_by_span(spans, [(s, e) for _, s, e, _ in run.trace.device])
    return 1e6 * sum(idle.get(name, 0.0) for name in names) / run.trace_steps
