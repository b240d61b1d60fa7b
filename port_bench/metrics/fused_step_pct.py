"""Share of the window's steps whose leapfrog updates ran as one fused
kernel launch, counted by ``leapfrog_cuda.STEP_LAUNCHES`` (one a step of
an NVE window on the card). A program without that counter reads
nothing."""

COUNTER = "leapfrog_cuda.STEP_LAUNCHES"


def read(run):
    if COUNTER not in run.counters or not run.steps:
        return None
    return 100.0 * run.counters[COUNTER] / run.steps
