"""The fused leapfrog kernel (``ops/kernels/csrc/leapfrog.cu``) beside the
design it replaced, the NVE window's eager elementwise passes, on the card
at the benchmark's 2D shapes (N=1M: 55 x 16 x 2695 slots, R = 7, Kahan):

1. the fused window torch.equal to the eager window
   (``tests/torch_window_eager.py``) over 4 steps from a state 200 steps
   into a run;
2. device ms of one step launch, the first step's launch (with the
   window's allocation and the scalar's reset) and the closing launch,
   beside the eager passes of the same updates, in 7 interleaved repeats of
   20 calls (``utils.profiling.interleaved_ms``, the card spinning first so
   that no wrapper's host time is timed), with the byte bound of each;
3. a 4-step window, fused and eager, force kernel included: device ms, host
   us a window to enqueue it behind a busy card, device operations a window.

    python tests/torch_leapfrog_designs.py [N]

Prints one ``kernels`` JSON line last."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import leapfrog_cuda  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import roofline  # noqa: E402
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import (  # noqa: E402
    device_op_count,
    interleaved_ms,
    spread,
)
from torch_window_eager import _kadd, _sumsq, assert_states_equal, eager_window  # noqa: E402


def enqueue_us(fn, reps: int = 5) -> float:
    """Host us a call of ``fn()`` spends queuing its work while the card is
    busy (spinning ~0.2 s), so that no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def plane_counts(dim: int, compensated: bool) -> dict:
    """Planes each launch reads or writes once: a step reads f and the
    fields (v, pos, disp, with Kahan also cr, cv) and writes the fields;
    the first step leaves cv alone, the close touches f, v and cv alone.
    22, 18 and 10 planes in 2D with Kahan."""
    fields = 5 if compensated else 3
    return {"step": dim * (1 + 2 * fields), "first": dim * (1 + 2 * (fields - int(compensated))),
            "close": dim * (1 + 2 * (1 + int(compensated)))}


def launch_times(md, s):
    """Each launch of a window on the state ``s`` of the engine ``md``
    beside the eager passes of the same updates: ``(t, bounds, ops)``, with
    ``t[name]`` and ``t["eager_" + name]`` median, min and max device ms of
    ``name`` in ("step", "first", "close") over 7 interleaved repeats of 20
    calls (``lead``: the card spins first, so no wrapper's host time is
    timed), ``bounds[name]`` its ``roofline.bound`` over the planes of
    :func:`plane_counts` at the state's slot count, and ``ops`` device
    operations a call of the step and the close."""
    axes = md.AXES
    dt = md.dt
    comp = bool(md.compensated)
    v = [getattr(s, f"v{a}g") for a in axes]
    pos = [getattr(s, f"{a}g") for a in axes]
    disp = [getattr(s, f"disp{a}") for a in axes]
    cr = [getattr(s, f"cr{a}") for a in axes] if comp else None
    cv = [getattr(s, f"cv{a}") for a in axes] if comp else None
    f = [getattr(s, f"f{a}g") for a in axes]

    def new_window():
        return leapfrog_cuda.Leapfrog(v, pos, disp, cr, cv, dt=dt)

    lf = new_window()
    lf.step(f)

    def first():
        new_window().step(f)

    def step():
        lf.step(f)

    def close():
        lf._launch(leapfrog_cuda._CLOSE, f)

    def kick(x, c, inc):
        return _kadd(x, c, inc) if comp else (x + inc, c)

    dm = _sumsq(disp)
    res = cr if comp else [None] * len(axes)
    resv = cv if comp else [None] * len(axes)

    def eager_step():
        vh, cvv, p, c, d = list(v), list(resv), list(pos), list(res), list(disp)
        for j in range(len(axes)):
            vh[j], cvv[j] = kick(vh[j], cvv[j], dt * f[j])
        inc = [dt * x for x in vh]
        for j in range(len(axes)):
            p[j], c[j] = kick(p[j], c[j], inc[j])
            d[j] = d[j] + inc[j]
        return torch.maximum(dm, _sumsq(d))

    def eager_first():
        vh = [x + 0.5 * dt * fa for x, fa in zip(v, f)]
        inc = [dt * x for x in vh]
        p, c, d = list(pos), list(res), list(disp)
        for j in range(len(axes)):
            p[j], c[j] = kick(p[j], c[j], inc[j])
            d[j] = d[j] + inc[j]
        return torch.maximum(_sumsq(disp), _sumsq(d))

    def eager_close():
        out = []
        for j in range(len(axes)):
            vh, _ = kick(v[j], resv[j], dt * f[j])
            out.append(vh - 0.5 * dt * f[j])
        return out

    ops = {name: sum(device_op_count(fn).values()) for name, fn in
           (("step", step), ("eager_step", eager_step), ("close", close), ("eager_close", eager_close))}
    t = interleaved_ms({"step": step, "eager_step": eager_step, "first": first, "eager_first": eager_first,
                        "close": close, "eager_close": eager_close}, lead=True)
    n_slots = s.xg.numel()
    bounds = {name: roofline.bound(0.0, 4 * n * n_slots) for name, n in plane_counts(len(axes), comp).items()}
    return t, bounds, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_leapfrog_designs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = override(MDConfig(), n=n, rho=0.8, cutoff=2.5, force_impl="grid", init="lattice")
    md = lj_fluid._make_grid_md(cfg, dev)
    k, gate = lj_fluid._grid_inner_steps(cfg, md)
    s0 = lj_fluid.init_state(cfg, dev)
    s = md.make_production_run(200, k, gate_frac=gate)(md.init(s0.position, s0.velocity))
    torch.cuda.synchronize()
    print(f"{smi}: grid {tuple(s.xg.shape)}, R={md.rows_per_block}, compensated {md.compensated}, window {k} "
          f"steps at gate {gate}", flush=True)

    # 1. bits
    force = md.force_kernel
    assert_states_equal(md, md._make_window(force, 4)(s), eager_window(md, force, 4)(s))
    print("fused window (4 steps) torch.equal to the eager window in every field, dmax2, overflow, time",
          flush=True)

    # 2. the launches alone, beside the eager passes of the same updates
    t, bounds, ops = launch_times(md, s)
    for name in ("step", "first", "close"):
        print(f"{smi}: {name} launch {spread(t[name])} ms, eager {spread(t['eager_' + name])} ms, bound "
              f"{bounds[name][0]:.5f} ms ({bounds[name][1]}), {100 * bounds[name][0] / t[name][0]:.1f}% of it; "
              f"device ops {ops.get(name, 'n/a')} vs {ops.get('eager_' + name, 'n/a')}", flush=True)

    # 3. whole 4-step windows, B3 included
    fused_w = md._make_window(force, 4)
    eager_w = eager_window(md, force, 4)
    tw = interleaved_ms({"fused": lambda: fused_w(s), "eager": lambda: eager_w(s)}, reps=10, lead=True)
    hw = {"fused": enqueue_us(lambda: fused_w(s)), "eager": enqueue_us(lambda: eager_w(s))}
    ow = {"fused": sum(device_op_count(lambda: fused_w(s)).values()),
          "eager": sum(device_op_count(lambda: eager_w(s)).values())}
    for name in ("fused", "eager"):
        print(f"{smi}: 4-step window {name}: device {spread(tw[name])} ms, host "
              f"{hw[name]:.1f} us a window to enqueue, {ow[name]} device ops", flush=True)
    print(json.dumps({"kernels": {
        **{f"leapfrog_{name}": {"kernel_ms": t[name][0], "plain_ms": t["eager_" + name][0],
                                "bound_ms": bounds[name][0]} for name in ("step", "first", "close")},
        "window4": {"fused_ms": tw["fused"][0], "eager_ms": tw["eager"][0], "fused_host_us": hw["fused"],
                    "eager_host_us": hw["eager"], "fused_ops": ow["fused"], "eager_ops": ow["eager"]},
    }, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
