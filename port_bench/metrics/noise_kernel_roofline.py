"""The Langevin noise kernel's share of its roofline: the least time its
bytes could take on the card (``counts/noise.noise_bound``: the particle-id
plane in, D noise planes out) over its device time a launch in the trace.
A program without the kernel reads nothing."""

import re

from port_bench.counts import noise

KERNEL = re.compile(r"^langevin_noise_kernel<[23]>$")


def read(run):
    if run.trace is None:
        return None
    calls = [(e - s) * 1e-6 for name, s, e, _ in run.trace.device if KERNEL.match(name)]
    if not calls:
        return None
    least, _ = noise.noise_bound(run.geometry["dim"], run.geometry["grid_slots"])
    return 100.0 * least / (sum(calls) / len(calls))
