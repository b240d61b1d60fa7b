"""Microseconds a traced step that the card idled in gaps that began inside
an ``md.sync`` span: the queue drained by a gate or ``max_occ`` read, the
round trip before a rebuild's first launch included. A reading of the
profiled window, which the profiler's host cost raises."""

from port_bench.counts import spans


def read(run):
    return spans.idle_us_per_step(run, ("md.sync",))
