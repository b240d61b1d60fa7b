"""The benchmark of the PyTorch and CUDA port, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration's file (``configs/<config>.json``) gives the system's
parameters, its start, the adapter under ``systems/`` that drives the
program and the guarantees it states; the traffic's file
(``workloads/<traffic>.json``) gives the size, the set-up's steps, the
block length and the limits of the compared numbers. Each metric is read by
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None.

A run:

1. set-up (counted in ``setup_s``): imports, the start state on the device
   from the seed, the engine, its equilibration and one block of warm-up;
2. the window: blocks, each carrying the state of the one before, until
   ``seconds`` have passed, ended by a synchronize at the first block
   boundary after that;
3. with ``trace``: from the state the window ended at, the blocks of the
   traced window once without and once under the profiler, and the pair
   census of that state;
4. ``memory_peak_bytes``, then the program's state freed and the kept
   blocks compared with the plain reference.

The result is one JSON line on stdout; the card's facts come first on
stderr, and each compared number with its limit comes last there.
"""

from __future__ import annotations

import importlib.util
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    metrics: Dict[str, List[Dict]]  # "end_to_end" / "per_layer": this cell's entries


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration's and
    traffic's files and the metrics it reports."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    metrics = {
        kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
        for kind in ("end_to_end", "per_layer")
    }
    return Cell(name, w["chips"], _load_json(root / config["file"]),
                _load_json(HERE / "workloads" / f"{w['traffic']}.json"), metrics)


def _module(path: Path) -> ModuleType:
    name = f"port_bench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_class(cell: Cell):
    return _module(HERE / "systems" / f"{cell.config['system']}.py").System


@dataclass
class Run:
    """What the metric readers read."""

    n: int
    setup_s: float = 0.0
    steps: int = 0  # in the window
    window_s: float = 0.0
    counters: Dict[str, int] = field(default_factory=dict)  # launches in the window
    geometry: Dict = field(default_factory=dict)
    trace: Optional[object] = None  # counts.timing.Trace of the traced window
    trace_steps: int = 0
    untraced_s: float = 0.0  # the traced window's blocks, run without the profiler
    census: Optional[tuple] = None  # (candidates, in_cutoff) where the traced window starts


def launch_counters() -> Dict[str, int]:
    """Every ``*LAUNCHES`` counter of the program's kernel wrappers."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels."):
            short = name.rsplit(".", 1)[1]
            for attr, v in vars(mod).items():
                if attr.endswith("LAUNCHES") and isinstance(v, int):
                    out[f"{short}.{attr}"] = v
    return out


def card_facts(torch) -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi: n/a"
    return f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: Optional[float] = None,
            overrides: Optional[Dict] = None, log=sys.stderr) -> Dict:
    """One run of ``cell``; returns the result object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        print(card_facts(torch), file=log, flush=True)
    t_sim = time.perf_counter()
    sim = system_class(cell)(cell.config, cell.traffic, seed, device, overrides)
    _sync(torch, device)
    run = Run(n=sim.n, setup_s=time.perf_counter() - t_start, geometry=sim.geometry())
    mem = f"; memory after set-up {torch.cuda.max_memory_allocated()} bytes" if on_card else ""
    print(f"engine: {json.dumps(run.geometry)}{mem}", file=log, flush=True)
    print(f"set-up: {run.setup_s:.3f} s, of which before the system {t_sim - t_start:.3f} s, "
          + ", ".join(f"{k} {v:.3f}" for k, v in sim.phases.items()), file=log, flush=True)

    # the window
    limits = {**cell.config.get("guarantees", {}), **cell.traffic.get("limits", {})}
    pick = random.Random(seed)
    n_keep = cell.traffic["compare_blocks"]
    blocks, kept, ends = [], [], []
    state = sim.start
    before = launch_counters()
    t0 = time.perf_counter()
    while True:
        start = state
        state, out = sim.block(state)
        i = len(blocks)
        slot = i if i < n_keep else pick.randrange(i + 1)  # a uniform sample of the window's blocks
        if slot < n_keep:
            out.sample = out.sample.clone()
            if slot < len(kept):
                kept[slot][2].sample = None
                kept[slot] = (i, start, out)
            else:
                kept.append((i, start, out))
        else:
            out.sample = None  # only the kept blocks' positions are compared
        blocks.append(out)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    _sync(torch, device)
    run.window_s = time.perf_counter() - t0
    run.steps = len(blocks) * sim.steps_per_block
    after = launch_counters()
    run.counters = {k: after[k] - before.get(k, 0) for k in after}
    per_block = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"window: {len(blocks)} blocks of {sim.steps_per_block} steps in {run.window_s:.3f} s; a block's host "
          f"seconds: min {per_block[0]:.4f}, median {per_block[len(per_block) // 2]:.4f}, max {per_block[-1]:.4f}",
          file=log, flush=True)

    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                     "count": cell.chips}
    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from port_bench.counts.timing import reduce_profile

        n_trace = cell.traffic["trace_blocks"]

        def traced_window():
            s = state
            for _ in range(n_trace):
                s, _ = sim.block(s)

        _sync(torch, device)
        t = time.perf_counter()
        traced_window()
        _sync(torch, device)
        run.untraced_s = time.perf_counter() - t
        run.trace_steps = n_trace * sim.steps_per_block
        run.census = sim.census(state)
        if on_card:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                traced_window()
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t
            run.trace = reduce_profile(prof, traced_s)
            del prof
            result_device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    if on_card:
        result_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    # the comparison, with the program's state freed
    state = sim.start = None
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values, failed = sim.checks(blocks, kept, limits)
    print(f"reference: {len(kept)} blocks compared in {time.perf_counter() - t:.3f} s; readings "
          + json.dumps(values), file=log, flush=True)
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        v = _module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(blocks), "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = values
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=log, flush=True)
    return result

