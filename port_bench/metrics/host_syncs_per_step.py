"""Host reads of a device value a traced step: the program's ``md.sync``
spans (one a ``trace.host_read``: the gated drivers' ``dmax2`` and the 3D
engine's ``max_occ``) in the traced window over its steps. A program that
records no spans under the profiler reads nothing."""

from port_bench.counts import spans


def read(run):
    recorded = spans.recorded(run)
    if recorded is None:
        return None
    return sum(name == "md.sync" for name, _, _ in recorded) / run.trace_steps
