"""Subprocess entry point for the crash-isolated benchmark sweep.

The ``bench`` CLI's default mode runs the whole sweep here, never in its
own process, and this process streams a line protocol on stdout that the
parent (``bench/isolate.py``) reads. If an op kills this process (a
device fault that ends the process), the parent records a loud failure row for
the op that was running and respawns a fresh worker for the remaining
(cores, op) pairs. Port of the JAX package's ``bench/sweep_worker.py``,
with the device in the payload.

Protocol (stdout, one JSON per line, prefix ``@@BENCH ``):
  {"kind": "sysinfo",  "info": {...}}
  {"kind": "devices",  "rows": [...]}
  {"kind": "begin",    "cores": C, "op": NAME}
  {"kind": "result",   "cores": C, "op": NAME, "row": {...}}
  {"kind": "skipped",  "cores": C, "op": NAME}
  {"kind": "done"}
Human-readable progress goes to stderr (inherited by the parent's tty).

Usage: python -m jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sweep_worker
       (config JSON, skip list and device on stdin; see isolate.run_sweep_isolated)
"""

from __future__ import annotations

import json
import os
import sys


def _emit(kind: str, payload: dict | None = None) -> None:
    msg = {"kind": kind, **(payload or {})}
    sys.stdout.write("@@BENCH " + json.dumps(msg) + "\n")
    sys.stdout.flush()
    if kind == "begin":
        # test hook: simulate a worker death at the start of an op (the
        # tests exercise the parent's respawn path with it)
        crash = os.environ.get("JTPS_BENCH_CRASH_OP", "")
        if crash and msg.get("op") == crash:
            os._exit(139)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    payload = json.loads(sys.stdin.read())

    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.runners import run_sweep
    from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sysinfo import device_rows, system_info
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import BenchConfig

    cfg_d = dict(payload["cfg"])
    if cfg_d.get("ops") is not None:
        cfg_d["ops"] = tuple(cfg_d["ops"])
    cfg = BenchConfig(**cfg_d)
    skip = {(int(c), str(o)) for c, o in payload.get("skip", [])}
    device = payload.get("device", "cuda")

    _emit("sysinfo", {"info": system_info(device)})
    _emit("devices", {"rows": device_rows(device)})
    run_sweep(cfg, log=_log, emit=_emit, skip=skip, device=device)
    _emit("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
