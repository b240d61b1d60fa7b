"""The force-only cell-list kernel's share of its roofline: the least time
its work could take on the card (``counts/roofline.force_bound`` over the
pair census of the state the traced blocks start at) over its device time
a call in the trace. The kernels: B1 (the tile kernel), B3 (the packed
counted kernel, which also reads the ``cps^2`` int32 count grid) and the 3D
counted kernel (B5 and B4), each without its energy variant."""

import re

from port_bench.counts import roofline

KERNELS = re.compile(
    r"^(cell_force_tile_kernel|cell_force_counted_kernel)<false>$"  # B1, B3
    r"|^cell_force3_counted_kernel<\d+, false>$"  # B5 (its bound) and B4 (0)
)


def read(run):
    if run.trace is None or run.census is None:
        return None
    calls = [(e - s) * 1e-6 for name, s, e, _ in run.trace.device if KERNELS.match(name)]
    if not calls:
        return None
    geo = run.geometry
    packed = geo["dim"] == 2 and geo.get("rows_per_block", 1) > 1
    extra = roofline.WORD * geo["cells_per_side"] ** 2 if packed else 0
    least, _ = roofline.force_bound(run.census, geo["dim"], geo["grid_slots"], extra)
    return 100.0 * least / (sum(calls) / len(calls))
