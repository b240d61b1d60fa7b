"""Crash-isolated benchmark sweep: parent side.

Runs the whole sweep in one subprocess (``bench/sweep_worker.py``) and
parses its line protocol. If the worker process dies mid-op, the parent:

1. records a loud failure row ``{test, cores, error}`` for the op that was
   running (it appears in the results and the CSV);
2. adds that (cores, op) pair to the skip set;
3. respawns a fresh worker for everything that has not run yet.

The parent process never initializes CUDA (it imports no device code); the
device travels to the worker in the payload. Port of the JAX package's
``bench/isolate.py`` (reference behaviour generalized: tpus_benchmark...
:221-235 per-op try/except and :696-703 KeyboardInterrupt salvage survive
Python-level failures in-process; a worker-process crash there loses the
sweep).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import asdict
from typing import Callable, List, Optional, Tuple

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import BenchConfig

_WORKER_MOD = "jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sweep_worker"
# the directory that holds the package, so a worker can import it from a
# checkout started in any working directory
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _worker_env() -> dict:
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    if _PKG_PARENT not in pp.split(os.pathsep):
        env["PYTHONPATH"] = _PKG_PARENT + (os.pathsep + pp if pp else "")
    return env


def run_sweep_isolated(
    cfg: BenchConfig,
    log: Callable[[str], None] = print,
    max_respawns: int = 16,
    device: str = "cuda",
) -> Tuple[List[dict], dict, List[dict]]:
    """Returns ``(results, system_info, device_rows)``. Results include
    loud ``error`` rows for ops whose worker process died."""
    skip: List[Tuple[int, str]] = []
    results: List[dict] = []
    sysinfo: dict = {}
    devrows: List[dict] = []
    respawns = 0

    while True:
        payload = json.dumps({"cfg": asdict(cfg), "skip": skip, "device": str(device)})
        proc = subprocess.Popen(
            [sys.executable, "-m", _WORKER_MOD],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,  # the worker's human logs pass through
            text=True,
            env=_worker_env(),
        )
        proc.stdin.write(payload)
        proc.stdin.close()
        current: Optional[Tuple[int, str]] = None
        done = False
        for line in proc.stdout:
            if not line.startswith("@@BENCH "):
                if line.strip():
                    log(line.rstrip())
                continue
            msg = json.loads(line[len("@@BENCH "):])
            kind = msg["kind"]
            if kind == "sysinfo":
                sysinfo = msg["info"]
            elif kind == "devices":
                devrows = msg["rows"]
            elif kind == "begin":
                current = (int(msg["cores"]), str(msg["op"]))
            elif kind == "result":
                results.append(msg["row"])
                skip.append((int(msg["cores"]), str(msg["op"])))
                current = None
            elif kind == "skipped":
                skip.append((int(msg["cores"]), str(msg["op"])))
                current = None
            elif kind == "done":
                done = True
        rc = proc.wait()
        if done and rc == 0:
            return results, sysinfo, devrows
        if current is None:
            # died outside any op (device init, a config error, repeated
            # instant crashes): surface loudly and stop
            log(
                f"[bench] worker process died (exit {rc}) outside any op — "
                "aborting the sweep with partial results"
            )
            return results, sysinfo, devrows
        cores, op = current
        log(
            f"[bench] worker process DIED (exit {rc}) while running "
            f"{op} @ {cores} device(s) — recording failure row, respawning "
            "for the remaining ops"
        )
        results.append({"test": op, "cores": cores, "error": f"worker process crashed (exit {rc})"})
        skip.append(current)
        respawns += 1
        if respawns >= max_respawns:
            log(f"[bench] {respawns} worker crashes — giving up on the rest")
            return results, sysinfo, devrows
