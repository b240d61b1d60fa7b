"""Microseconds a traced step that the card idled in gaps that began inside
``md.rebuild``, ``md.alloc`` or ``md.list``: the rebuild's own launches (the
allocation, the permutation, a partner list's build) could not keep the
card fed. A reading of the profiled window, which the profiler's host cost
raises."""

from port_bench.counts import spans


def read(run):
    return spans.idle_us_per_step(run, ("md.rebuild", "md.alloc", "md.list"))
