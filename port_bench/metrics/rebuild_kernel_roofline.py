"""The rebuild's permutation kernel's share of its roofline: the least time
moving every particle's fields could take (``counts/roofline.migrate_bound``,
from the grid's shape and N) over its device time a call in the trace.
The kernels: B2 (both layouts) and B6/B7, without their halo forms. The
fields are the d positions, d velocities, d forces and the particle id,
and with Kahan compensation d position and d velocity residuals."""

import re

from port_bench.counts import roofline

KERNELS = re.compile(r"^(migrate_kernel|migrate3_kernel)<false>$")


def read(run):
    if run.trace is None:
        return None
    calls = [(e - s) * 1e-6 for name, s, e, _ in run.trace.device if KERNELS.match(name)]
    if not calls:
        return None
    geo = run.geometry
    d = geo["dim"]
    fields = 3 * d + 1 + (2 * d if geo["compensated"] else 0)
    least, _ = roofline.migrate_bound(fields, geo["grid_slots"], geo["n"])
    return 100.0 * least / (sum(calls) / len(calls))
