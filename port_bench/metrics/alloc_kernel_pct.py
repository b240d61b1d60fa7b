"""Share of the window's rebuilds whose allocation ran as the hand-written
kernel passes on the card, counted by ``alloc_cuda.LAUNCHES`` (one an
allocation) over the rebuilds that ``steps_per_rebuild``'s counters count
(one migrate launch a rebuild). A program without that counter reads
nothing."""

from port_bench.metrics.steps_per_rebuild import REBUILD_COUNTERS

COUNTER = "alloc_cuda.LAUNCHES"


def read(run):
    rebuilds = sum(run.counters.get(k, 0) for k in REBUILD_COUNTERS)
    if COUNTER not in run.counters or not rebuilds:
        return None
    return 100.0 * run.counters[COUNTER] / rebuilds
