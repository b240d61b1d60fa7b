"""The all-pairs force kernel's share of its roofline: the least time one
force call could take on the card (``counts/pairwise.force_bound``) over
B8's device time a force call in the trace. A force call is one
``pairwise_lj_kernel<d, false, ...>`` launch and its
``pairwise_reduce_kernel<d, false>`` launch, which sums the j slices; the
energy variant at the samples is left out."""

import re

from port_bench.counts import pairwise


def read(run):
    if run.trace is None or "slices" not in run.geometry:
        return None
    dim = run.geometry["dim"]
    force = re.compile(rf"^pairwise_lj_kernel<{dim}, false, (true|false), (true|false)>$")
    reduce = f"pairwise_reduce_kernel<{dim}, false>"
    calls, seconds = 0, 0.0
    for name, s, e, _ in run.trace.device:
        if force.match(name):
            calls += 1
            seconds += (e - s) * 1e-6
        elif name == reduce:
            seconds += (e - s) * 1e-6
    if not calls:
        return None
    least, _ = pairwise.force_bound(run.n, dim)
    return 100.0 * least / (seconds / calls)
