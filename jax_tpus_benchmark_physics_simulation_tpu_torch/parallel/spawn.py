"""Runs one function on every rank of a fresh process group.

The JAX package checks its sharding in one process, on virtual CPU devices
(``xla_force_host_platform_device_count``). ``torch.distributed`` has one
process per rank, so the port's counterpart starts ``world_size`` fresh
processes (the ``spawn`` start method), joins them in a process group
through a file store in a temporary directory (no network address), calls
``fn(*args)`` on each and returns the ranks' results in rank order.

``mdscale --virtual D`` runs its sweep this way on D gloo processes, and the
tests run their sharded checks this way. ``fn`` must be importable by name
(a module-level function) and its result picklable. If a rank fails, the
others are stopped and its traceback is raised; no process outlives the
call.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List

# the directory that holds the package, so a worker can import it from a
# checkout started in any working directory
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _worker(fn, rank: int, world_size: int, backend: str, threads: int, tmp: str, args) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        with open(os.path.join(tmp, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    # The result is on disk: skip the interpreter's teardown, in which the
    # destruction of the process group's threads now and then aborts the
    # process ("terminate called without an active exception") after its
    # work is done.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    *args,
    backend: str = "gloo",
    threads: int = 1,
    timeout: float = 600.0,
) -> List[Any]:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    fresh process in one process group (``backend`` gloo on the CPU, NCCL
    with one card a rank), with ``threads`` torch threads each. Raises
    ``RuntimeError`` with the first failed rank's traceback, and
    ``TimeoutError`` after ``timeout`` seconds."""
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    ctx = multiprocessing.get_context("spawn")
    if _PKG_PARENT not in sys.path:
        sys.path.insert(0, _PKG_PARENT)  # the children inherit sys.path
    with tempfile.TemporaryDirectory(prefix="jtps_ranks_") as tmp:
        procs = [
            ctx.Process(target=_worker, args=(fn, r, world_size, backend, threads, tmp, args), daemon=True)
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world_size} ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = [os.path.join(tmp, f"{r}.err") for r in range(world_size)]
        errs = sorted((os.path.getmtime(e), r, e) for r, e in enumerate(errs) if os.path.exists(e))
        if errs:  # the first rank to fail; its peers fail in turn
            _, r, err = errs[0]
            with open(err) as f:
                raise RuntimeError(f"rank {r} of {world_size} failed:\n{f.read()}")
        codes = [p.exitcode for p in procs]
        if any(codes):  # the ranks stopped after the first failure show -15
            raise RuntimeError(f"a rank of {world_size} exited without a result: exit codes {codes}")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
