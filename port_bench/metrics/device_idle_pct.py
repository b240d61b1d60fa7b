"""The share of the traced blocks' untraced wall time in which no operation
ran on the card: 100 (1 - device busy time in the trace / wall time of the
same blocks run without the profiler)."""


def read(run):
    if run.trace is None or run.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.untraced_s)
