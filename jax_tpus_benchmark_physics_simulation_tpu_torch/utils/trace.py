"""Spans and a host-read counter on the grid MD path.

The tracer is off unless :func:`enable` turns it on. Off, :func:`span`
returns one shared null context: no clock read, no torch call, no
allocation. On, each span records its name, its start and end on the
host's clock (``time.perf_counter_ns``), the index of the span open around
it (its parent, -1 at the top) and the production block it belongs to, in
memory (:data:`SPANS`, in start order). While a ``torch.profiler`` run is
active, a span also opens ``torch.profiler.record_function(name)``: it then
lies among the profiler's CPU events, on the clock of the device's events,
and :func:`by_span` reads it back from the profiler's chrome trace.

:func:`host_read` is the path's one way of reading a device value on the
host. The read waits for the card to reach it, so it runs in an
``md.sync`` span, and it adds one to :data:`SYNCS` whether tracing is on or
off.

The spans, each where its work happens (the prefix ``md.`` keeps them
apart from the aten ops among the profiler's events):

- ``md.block``: one ``lj_fluid.production`` call; each opens a new block id,
  which the spans inside it carry;
- ``md.block.init``: the block's binning of its particles (``md.init``);
- ``md.sample``: one sample's positions, kinetic and potential energy;
- ``md.window``: one leapfrog window (``GridEngine._make_window``, which
  the 2D, 3D and row-sharded engines share);
- ``md.rebuild``: one sort-free rebuild (``_rebuild_migrate``): the
  allocation and the permutation kernel (B2 or B6);
- ``md.alloc``: inside ``md.rebuild``, its allocation in plain PyTorch
  (``_migration_dest``; in 3D also the new ``max_occ``), so that ``md.rebuild``'s own time is the permutation's;
- ``md.list``: the 3D engine's partner-list build, once a binning, at the
  first window of 2 or more steps after it (``GridMD3._window_for``): the
  rest of the rebuild's work, launched just after ``md.rebuild`` in the
  fixed-cadence driver;
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


SPANS: List[Span] = []
_open: List[int] = []  # indices into SPANS of the spans open now, innermost last
_on = False
_blocks = 0  # block ids handed out since the last reset
_NULL = contextlib.nullcontext()


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
    __slots__ = ("name", "new_block", "index", "annotation")

    def __init__(self, name: str, new_block: bool):
        self.name = name
        self.new_block = new_block

    def __enter__(self):
        global _blocks
        parent = _open[-1] if _open else -1
        if self.new_block:
            block, _blocks = _blocks, _blocks + 1
        else:
            block = SPANS[parent].block if parent >= 0 else None
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(SPANS)
        _open.append(self.index)
        SPANS.append(Span(self.name, time.perf_counter_ns(), parent, block))
        return self

    def __exit__(self, *exc):
        SPANS[self.index].end_ns = time.perf_counter_ns()
        _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, new_block: bool = False):
    """A context manager: with tracing on, the span ``name`` (a new block id
    with ``new_block``); off, a shared null context."""
    if not _on:
        return _NULL
    return _Recorder(name, new_block)


def host_read(t: torch.Tensor, kind: Callable):
    """``kind(t)`` (``bool`` or ``int``) of a device tensor, which waits for
    the card: counted in :data:`SYNCS`, and an ``md.sync`` span when on."""
    global SYNCS
    SYNCS += 1
    if not _on:
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


def by_span(chrome_trace: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """:func:`attribute` of a chrome trace that ``torch.profiler`` exported
    while tracing was on: the ``md.*`` annotations are the spans, a device
    op's launch is the runtime call of the same ``correlation``."""
    with open(chrome_trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, launch, ops = [], {}, []
    for e in events:
        cat, ts = e.get("cat"), float(e["ts"])
        if cat == "user_annotation" and e["name"].startswith("md."):
            spans.append((e["name"], ts, ts + float(e["dur"])))
        elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ts
        elif cat in _DEVICE_CATS:
            ops.append((ts, ts + float(e["dur"]), e.get("args", {}).get("correlation")))
    return attribute(spans, [(s, e, launch.get(c)) for s, e, c in ops])
