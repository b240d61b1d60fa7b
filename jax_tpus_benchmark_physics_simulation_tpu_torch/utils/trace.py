"""Spans and a host-read counter on the MD paths.

Spans record while the tracer is on (:func:`enable`) or while a
``torch.profiler`` run is active, as ``record_function`` records only
under a profiler. Otherwise :func:`span` returns one shared null context:
no clock read, no allocation, one check of the profiler's flag. Each
recorded span keeps its name, its start and end, the index of the span
open around it (its parent, -1 at the top) and the production block it
belongs to, in memory (:data:`SPANS`, in start order, in columns that the
garbage collector does not track).

The clock is the profiler's: ``time.time_ns()``, Unix nanoseconds, which
is what ``torch.profiler``'s event records give as ``start_ns()`` (a
chrome trace's ``ts`` is microseconds after its ``baseTimeNanoseconds``).
So a profiled run's spans line up with its device events with no
``record_function`` copy among them: the profiler's event lists and
device row carry none of the program's spans. :func:`by_span` reads the
device's ops from an exported chrome trace and the spans from
:data:`SPANS`.

:func:`host_read` is the path's one way of reading a device value on the
host. The read waits for the card to reach it, so it runs in an
``md.sync`` span, and it adds one to :data:`SYNCS` whether spans record or
not.

The spans, each where its work happens (named ``md.*``):

- ``md.block``: one ``lj_fluid.production`` call, on every force path;
  each opens a new block id, which the spans inside it carry;
- ``md.block.init``: the grid block's binning of its particles
  (``md.init``);
- ``md.sample``: one sample's positions, kinetic and potential energy (on
  the dense paths B8's energy variant or ``LennardJones.energy``);
- ``md.window``: on the grid engines one leapfrog window
  (``GridEngine._make_window``, which the 2D, 3D and row-sharded engines
  share); on the dense and list paths one run of ``sample_every``
  velocity-Verlet steps, or the unsampled tail after the last sample
  (``lj_fluid._stepped_production``);
- ``md.rebuild``: one sort-free rebuild (``_rebuild_migrate``): the
  allocation and the permutation kernel (B2 or B6);
- ``md.alloc``: inside ``md.rebuild``, its allocation (``_migration_dest``:
  on the card the three kernel passes of ``alloc_cuda``; in 3D also the new
  ``max_occ``), so that ``md.rebuild``'s own time is the permutation's;
- ``md.list``: a partner-list build (B3's list in 2D, B5's in 3D), once a
  binning, at the first window of 2 or more steps after it
  (``GridEngine._listed_window``): the rest of the rebuild's work;
- ``md.sync``: one host read (:func:`host_read`): the gated drivers'
  ``dmax2`` and the 3D engine's ``max_occ``.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SYNCS = 0  # host reads of a device value (host_read), counted on or off

OUTSIDE = "(outside spans)"  # the key of time that no md.* span covers
UNLAUNCHED = "(no launch record)"  # a device op whose host launch the trace lacks


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "block")

    def __init__(self, name: str, start_ns: int, parent: int, block: Optional[int]):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None  # None while open
        self.parent = parent
        self.block = block


class _Spans:
    """The recorded spans in start order, kept column by column, read as
    :class:`Span` copies. Recording one adds a str and ints to lists and
    so allocates no object that Python's garbage collector tracks: kept
    :class:`Span` objects would trigger collections inside the window they
    record (60-240 ms each on the card's host, in half the profiled
    2000-step blocks of ``lj2d-n1m`` and ``lj2d-nvt-n1m``)."""

    __slots__ = Span.__slots__

    def __init__(self):
        self.name: List[str] = []
        self.start_ns: List[int] = []
        self.end_ns: List[Optional[int]] = []
        self.parent: List[int] = []
        self.block: List[Optional[int]] = []

    def append(self, sp: Span) -> None:
        for col in self.__slots__:
            getattr(self, col).append(getattr(sp, col))

    def extend(self, spans) -> None:
        for sp in spans:
            self.append(sp)

    def clear(self) -> None:
        for col in self.__slots__:
            getattr(self, col).clear()

    def __len__(self) -> int:
        return len(self.name)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        sp = Span(self.name[i], self.start_ns[i], self.parent[i], self.block[i])
        sp.end_ns = self.end_ns[i]
        return sp

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __add__(self, other) -> List[Span]:
        return list(self) + list(other)

    def __eq__(self, other) -> bool:
        return list(self) == list(other)


SPANS = _Spans()
_open: List[int] = []  # indices into SPANS of the spans open now, innermost last
_on = False
_blocks = 0  # block ids handed out since the last reset
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled  # a torch.profiler run is active


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forgets the recorded spans and restarts the block ids. :data:`SYNCS`
    keeps counting: readers take its difference over a run."""
    global _blocks
    SPANS.clear()
    _open.clear()
    _blocks = 0


class _Recorder:
    __slots__ = ("name", "new_block", "index")

    def __init__(self, name: str, new_block: bool):
        self.name = name
        self.new_block = new_block

    def __enter__(self):
        global _blocks
        parent = _open[-1] if _open else -1
        if self.new_block:
            block, _blocks = _blocks, _blocks + 1
        else:
            block = SPANS.block[parent] if parent >= 0 else None
        self.index = len(SPANS)
        _open.append(self.index)
        SPANS.name.append(self.name)
        SPANS.start_ns.append(time.time_ns())
        SPANS.end_ns.append(None)
        SPANS.parent.append(parent)
        SPANS.block.append(block)
        return self

    def __exit__(self, *exc):
        SPANS.end_ns[self.index] = time.time_ns()
        _open.pop()
        return False


def span(name: str, new_block: bool = False):
    """A context manager: while spans record (tracer on or a profiler
    active), the span ``name`` (a new block id with ``new_block``);
    otherwise a shared null context."""
    if not _on and not _profiling():
        return _NULL
    return _Recorder(name, new_block)


def host_read(t: torch.Tensor, kind: Callable):
    """``kind(t)`` (``bool`` or ``int``) of a device tensor, which waits for
    the card: counted in :data:`SYNCS`, and an ``md.sync`` span while spans
    record."""
    global SYNCS
    SYNCS += 1
    if not _on and not _profiling():
        return kind(t)
    with _Recorder("md.sync", False):
        return kind(t)


# -- reading the spans ---------------------------------------------------------

def summary(spans: Sequence[Span] = SPANS) -> Dict[str, Dict[str, float]]:
    """``{name: {calls, total_ns, self_ns, syncs}}`` of finished spans: a
    span's self time is its duration less its children's; ``syncs`` counts
    the ``md.sync`` spans directly inside it."""
    out: Dict[str, Dict[str, float]] = {}
    child_ns = [0] * len(spans)
    syncs = [0] * len(spans)
    for sp in spans:
        if sp.parent >= 0 and sp.end_ns is not None:
            child_ns[sp.parent] += sp.end_ns - sp.start_ns
            syncs[sp.parent] += sp.name == "md.sync"
    for i, sp in enumerate(spans):
        if sp.end_ns is None:
            continue
        row = out.setdefault(sp.name, {"calls": 0, "total_ns": 0, "self_ns": 0, "syncs": 0})
        row["calls"] += 1
        row["total_ns"] += sp.end_ns - sp.start_ns
        row["self_ns"] += sp.end_ns - sp.start_ns - child_ns[i]
        row["syncs"] += syncs[i]
    return out


def table(steps: int, spans: Sequence[Span] = SPANS) -> str:
    """:func:`summary` as text, a step being one of ``steps``."""
    lines = [f"{'span':<16}{'calls':>8}{'total ms/step':>15}{'self ms/step':>14}{'syncs/step':>12}"]
    for name, r in sorted(summary(spans).items(), key=lambda kv: -kv[1]["total_ns"]):
        lines.append(f"{name:<16}{r['calls']:>8}{r['total_ns'] * 1e-6 / steps:>15.4f}"
                     f"{r['self_ns'] * 1e-6 / steps:>14.4f}{r['syncs'] / steps:>12.4f}")
    return "\n".join(lines)


def attribute(spans: Sequence[Tuple[str, float, float]],
              device: Sequence[Tuple[float, float, Optional[float]]]) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(busy, idle)`` seconds by span, from the host's spans ``(name,
    start, end)`` and the device's ops ``(start, end, launch)``, all in us
    on one clock (``launch`` None where it is unknown).

    ``busy``: the union of the device intervals, each op's share of it (the
    part no earlier op covers) given to the innermost span open at its
    launch. ``idle``: each gap between device ops given to the innermost
    span open on the host at the instant the gap begins: what the host was
    doing when the card ran dry. So ``busy`` sums to the device's busy
    time and ``idle`` to the gaps between its first and last op."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))

    def innermost(times):
        """The innermost span open at each time (spans nest: a sweep)."""
        out: Dict[int, str] = {}
        stack: List[Tuple[str, float, float]] = []
        i = 0
        for k in sorted(range(len(times)), key=lambda k: times[k]):
            t = times[k]
            while i < len(spans) and spans[i][1] <= t:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            out[k] = stack[-1][0] if stack else OUTSIDE
        return out

    ops = sorted(device, key=lambda op: (op[0], op[1]))
    launched = [k for k, op in enumerate(ops) if op[2] is not None]
    at_launch = innermost([ops[k][2] for k in launched])
    owner = [UNLAUNCHED] * len(ops)
    for j, k in enumerate(launched):
        owner[k] = at_launch[j]
    busy: Dict[str, float] = {}
    gaps: List[Tuple[float, float]] = []
    end = None
    for k, (s, e, _) in enumerate(ops):
        if end is not None and s > end:
            gaps.append((end, s))
        ext = e - s if end is None else max(0.0, e - max(s, end))
        busy[owner[k]] = busy.get(owner[k], 0.0) + ext * 1e-6
        end = e if end is None else max(end, e)
    at_gap = innermost([g[0] for g in gaps])
    idle: Dict[str, float] = {}
    for j, (a, b) in enumerate(gaps):
        idle[at_gap[j]] = idle.get(at_gap[j], 0.0) + (b - a) * 1e-6
    return busy, idle


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def by_span(chrome_trace: str, spans: Sequence[Span] = SPANS) -> Tuple[Dict[str, float], Dict[str, float]]:
    """:func:`attribute` of the finished ``spans`` (those the profiled run
    recorded) and the device ops of the chrome trace that ``torch.profiler``
    exported from that run, a device op's launch being the runtime call of
    the same ``correlation``. The trace's times, microseconds after its
    ``baseTimeNanoseconds``, and the spans' meet on that origin."""
    with open(chrome_trace) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    launch, ops = {}, []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat"), float(e["ts"])
        if cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ts
        elif cat in _DEVICE_CATS:
            ops.append((ts, ts + float(e["dur"]), e.get("args", {}).get("correlation")))
    host = [(sp.name, (sp.start_ns - base) * 1e-3, (sp.end_ns - base) * 1e-3)
            for sp in spans if sp.end_ns is not None]
    return attribute(host, [(s, e, launch.get(c)) for s, e, c in ops])
