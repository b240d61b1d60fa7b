"""The timing arithmetic: spreads of repeated runs, and the reduction of a
profiler trace to device time, device operations and idle gaps.

A device event's name is normalised by :func:`kernel_name`: CUPTI hands
the profiler either a demangled name (``void (anonymous
namespace)::migrate_kernel<false>(...)``) or a mangled one
(``_ZN12_GLOBAL__N_114migrate_kernelILb0EEEv...``); both become
``migrate_kernel<false>``. Other names keep their first 96 characters.
"""

from __future__ import annotations

import re
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def _mangled(name: str) -> Optional[str]:
    """``kernel<args>`` of a mangled template in an anonymous namespace
    (``_ZN<n><namespace><n><name>I...E``), else None."""
    m = re.match(r"_ZN(\d+)", name)
    n = re.match(r"(\d+)", name[m.end() + int(m.group(1)):]) if m else None
    if not n:
        return None
    start = m.end() + int(m.group(1)) + n.end()
    end = start + int(n.group(1))
    tail = name[end:]
    args = re.findall(r"L([bi])(\d+)E", tail[: tail.find("Ev")]) if tail.startswith("I") else []
    shown = ["true" if a == ("b", "1") else "false" if a == ("b", "0") else a[1] for a in args]
    return name[start:end] + (f"<{', '.join(shown)}>" if shown else "")


def kernel_name(name: str) -> str:
    """``kernel<args>`` for a kernel of the program's anonymous namespaces,
    mangled or demangled; the first 96 characters of any other name."""
    got = _mangled(name)
    if got is not None:
        return got
    m = re.search(r"\(anonymous namespace\)::(\w+)(<.*?>)?\(", name)
    if m:
        args = (m.group(2) or "").replace("(bool)1", "true").replace("(bool)0", "false").replace(" ", "")
        return m.group(1) + args.replace(",", ", ")
    return name.removeprefix("void ")[:96]


@dataclass
class Trace:
    """What a traced window left: its device events and its host ops."""

    window_s: float
    # (normalised name, start us, end us, host op that launched it)
    device: List[Tuple[str, float, float, str]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device intervals)."""
        busy, end = 0.0, float("-inf")
        for _, s, e, _ in sorted(self.device, key=lambda t: t[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy * 1e-6

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """``{name: (device seconds, calls)}``."""
        out: Dict[str, Tuple[float, int]] = {}
        for name, s, e, _ in self.device:
            t, c = out.get(name, (0.0, 0))
            out[name] = (t + (e - s) * 1e-6, c + 1)
        return out

    def top_ops(self, k: int = 10) -> List[List]:
        ranked = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])
        return [[name, t] for name, (t, _) in ranked[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The idle time between device operations, summed by what the host
        was doing: the host op whose launch ended the gap."""
        gaps: Dict[str, float] = {}
        end = None
        for _, s, e, host in sorted(self.device, key=lambda t: t[1]):
            if end is not None and s > end:
                key = f"before {host}"
                gaps[key] = gaps.get(key, 0.0) + (s - end) * 1e-6
            end = e if end is None else max(end, e)
        ranked = sorted(gaps.items(), key=lambda kv: -kv[1])
        return [[name, t] for name, t in ranked[:k]]


def reduce_profile(prof, window_s: float) -> Trace:
    """The device events of a finished ``torch.profiler.profile`` run, each
    with the host op it was launched from (read from the profiler's own
    event records, which skips building its Python event tree)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e.name() for e in events
            if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0}
    out = Trace(window_s=window_s)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns() * 1e-3
            out.device.append((kernel_name(e.name()), start, start + e.duration_ns() * 1e-3,
                               host.get(e.linked_correlation_id(), "unknown")))
    return out
