"""Seconds of set-up: imports, the start state, the engine with its kernel
library (built on a checkout's first run), equilibration and the warm-up
block."""


def read(run):
    return run.setup_s
