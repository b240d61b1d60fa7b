"""Sets of runs of one cell, each run in a process of its own, and the
spread of each end-to-end metric.

    python3 port_bench/sets.py --workload NAME --seeds 1,2,3,4,5,6 --sets 2 \
        --seconds 10 [--trace-seeds 7,8] [--out OUT.jsonl]

A first run (one second, not counted) builds the kernel library, as a
checkout's first run does. Then ``--sets`` sets of runs over the same
seeds, then one ``--trace 1`` run for each trace seed. The spread is the
distance between the first and third quartiles over the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.counts.timing import spread  # noqa: E402


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        res = {"correct": None}
    res.update(seed=seed, trace=trace, rc=proc.returncode)
    if proc.returncode or not res.get("correct"):
        res["stderr_tail"] = proc.stderr[-3000:]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def keep(res):
        rows.append(res)
        short = {k: v for k, v in res.items() if k not in ("stderr_tail", "checks")}
        print(json.dumps(short), flush=True)
        if "stderr_tail" in res:
            print(res["stderr_tail"], file=sys.stderr, flush=True)

    keep({**one(args.workload, seeds[0], 1, 0), "build": True})
    for k in range(args.sets):
        for s in seeds:
            keep({**one(args.workload, s, args.seconds, 0), "set": k})
    for s in [int(x) for x in args.trace_seeds.split(",") if x]:
        keep(one(args.workload, s, args.seconds, 1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps({"workload": args.workload, **r}) + "\n" for r in rows)
    for k in range(args.sets):
        got = [r for r in rows if r.get("set") == k and r.get("metrics")]
        for name in sorted({m for r in got for m in r["metrics"]}):
            vals = [r["metrics"][name]["value"] for r in got if name in r["metrics"]]
            if len(vals) >= 2:
                print(f"{args.workload} set {k} {name}: median {statistics.median(vals)!r}, spread "
                      f"{spread(vals)!r}, n {len(vals)}, values {vals}", flush=True)
    bad = [r["seed"] for r in rows if not r.get("correct")]
    print(f"{args.workload}: {len(rows)} runs, not correct: {bad}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
