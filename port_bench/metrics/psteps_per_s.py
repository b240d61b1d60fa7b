"""Particle-steps a second: N times the steps completed in the window, over
the window's whole wall time (rebuilds, gate reads and sampling inside)."""


def read(run):
    return run.n * run.steps / run.window_s
