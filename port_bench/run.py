"""Runs one cell of the port's benchmark on the card.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the result as the last line of stdout.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 1.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the program stay in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".port_bench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    harness.system_class(cell)  # imports the program: a checkout without it stops here
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
