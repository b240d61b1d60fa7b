"""Steps in the window over the rebuilds in it, counted by the launch
counters of the rebuild's permutation kernels (B2 in both layouts, B6 and
B7)."""

REBUILD_COUNTERS = ("migrate_cuda.LAUNCHES", "migrate_cuda.PACKED_LAUNCHES",
                    "migrate_cuda3.LAUNCHES", "migrate_cuda3.FLAT_LAUNCHES")


def read(run):
    rebuilds = sum(run.counters.get(k, 0) for k in REBUILD_COUNTERS)
    return run.steps / rebuilds if rebuilds else None
