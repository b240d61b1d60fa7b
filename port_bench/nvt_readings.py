"""Readings that the limits of an NVT cell's compared numbers are set from:
sound runs on many seeds and three controls, all in one process on the
card.

    python3 port_bench/nvt_readings.py --workload NAME --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 10 [--controls a,b] [--out OUT.jsonl]

Each seed is a whole run of the cell (set-up, a window at the cell's load,
the comparison with the reference). The controls change the program and
never the reference: ``noise_seed`` runs the program's noise stream from
the seed one past the run's; ``thermostat_off`` runs NVE from the same
start; ``compensation_off`` runs plain float32 positions in place of the
Kahan-compensated ones the configuration states; ``--controls`` runs only
those named (all three by default). Prints, for each number
and control, the largest sound reading (the lower) and the control's
smallest (the upper).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROLS = {
    "noise_seed": lambda seed: {"seed": seed + 1},
    "thermostat_off": lambda seed: {"thermostat": "none"},
    "compensation_off": lambda seed: {"compensated": False},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("nvt_readings: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    controls = [c for c in args.controls.split(",") if c]
    unknown = set(controls) - set(CONTROLS)
    if unknown:
        ap.error(f"unknown controls {sorted(unknown)}; known: {', '.join(CONTROLS)}")
    runs += [(int(s), c) for c in controls for s in args.control_seeds.split(",") if s]
    rows = []
    for seed, control in runs:
        res = harness.measure(cell, seed, args.seconds, False, overrides=CONTROLS[control](seed) if control else None)
        row = {"workload": cell.name, "seed": seed, "control": control, "correct": res["correct"],
               "failed": res["failed"], "attempted": res["attempted"], "readings": res["readings"],
               "psteps_per_s": res["metrics"].get("psteps_per_s", {}).get("value")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    for name in rows[0]["readings"]:
        low = max(r["readings"][name] for r in rows if r["control"] is None)
        ups = {c: min((r["readings"][name] for r in rows if r["control"] == c), default=float("nan"))
               for c in controls}
        print(f"{cell.name} {name}: lower {low!r} (sound); upper " + ", ".join(f"{c} {v!r}" for c, v in ups.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
