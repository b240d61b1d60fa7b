"""Share of the window's steps whose force call was the list form of B3,
the packed 2D force kernel (the partner list of the binning walked in
place of every staged candidate), counted by
``cell_cuda_packed.LIST_LAUNCHES`` (one a step of a window of 2 or more
steps on the card). A program without that counter reads nothing."""

COUNTER = "cell_cuda_packed.LIST_LAUNCHES"


def read(run):
    if COUNTER not in run.counters or not run.steps:
        return None
    return 100.0 * run.counters[COUNTER] / run.steps
