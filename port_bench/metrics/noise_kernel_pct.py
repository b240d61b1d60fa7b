"""Share of the window's steps whose Langevin noise came from one launch of
the counter-based noise kernel, counted by ``noise_cuda.LAUNCHES`` (one a
Langevin step on the card). A program without that counter reads
nothing."""

COUNTER = "noise_cuda.LAUNCHES"


def read(run):
    if COUNTER not in run.counters or not run.steps:
        return None
    return 100.0 * run.counters[COUNTER] / run.steps
