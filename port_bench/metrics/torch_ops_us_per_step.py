"""Device microseconds a step of every operation that is PyTorch's and not
one of the program's own kernels: the leapfrog and Kahan updates, the
displacement max, the rebuild's allocation, the samples' reductions and
gathers, copies and sets. PyTorch's kernels are named in its namespaces
(``at::``, ``at_cuda_detail::``, ``cub::``, ``c10::``) or are copies and
sets."""

import re

TORCH = re.compile(r"(^|[^\w:])(at|at_cuda_detail|cub|c10)::|^Memcpy|^Memset")


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    us = sum(e - s for name, s, e, _ in run.trace.device if TORCH.search(name))
    return us / run.trace_steps
