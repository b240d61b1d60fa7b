"""Operations on the card (kernels, copies, sets) a step in the traced
blocks."""


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    return len(run.trace.device) / run.trace_steps
