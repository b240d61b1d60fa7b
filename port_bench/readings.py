"""Readings that the limits of the compared numbers are set from: sound runs
of a cell on many seeds, and its control, all in one process on the card.

    python3 port_bench/readings.py --workload NAME --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 [--out OUT.jsonl]

Each seed is a whole run of the cell (set-up, a short window at the cell's
load, the comparison with the reference). The control is the program with
its own lower-precision path switched on: ``compensated`` off, plain
float32 integration in place of the Kahan-compensated one the
configuration states. Prints, for each number, the largest sound reading
(the lower) and the smallest control reading (the upper).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROL = {"compensated": False}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed, control in runs:
        res = harness.measure(cell, seed, args.seconds, False, overrides=CONTROL if control else None)
        row = {"workload": cell.name, "seed": seed, "control": control, "correct": res["correct"],
               "failed": res["failed"], "readings": res["readings"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    for name in rows[0]["readings"]:
        sound = [r["readings"][name] for r in rows if not r["control"]]
        ctrl = [r["readings"][name] for r in rows if r["control"]]
        low = max(sound)
        up = min(ctrl) if ctrl else float("nan")
        print(f"{cell.name} {name}: lower {low!r} (sound, {len(sound)} seeds), upper {up!r} "
              f"(control, {len(ctrl)} seeds), ratio {up / low if low else float('inf'):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
