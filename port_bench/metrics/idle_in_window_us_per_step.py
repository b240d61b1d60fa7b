"""Microseconds a traced step that the card idled in gaps that began inside
``md.window``: the window's launches fell behind the card. A reading of the
profiled window, which the profiler's host cost raises."""

from port_bench.counts import spans


def read(run):
    return spans.idle_us_per_step(run, ("md.window",))
