"""Share of the window's steps whose BAOAB Langevin updates ran as one
fused kernel launch, counted by ``baoab_cuda.STEP_LAUNCHES`` (one a step of
a Langevin window on the card). A program without that counter reads
nothing."""

COUNTER = "baoab_cuda.STEP_LAUNCHES"


def read(run):
    if COUNTER not in run.counters or not run.steps:
        return None
    return 100.0 * run.counters[COUNTER] / run.steps
