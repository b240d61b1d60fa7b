"""A1, the rebuild's allocation as three kernel passes
(``ops/kernels/alloc_cuda.py``, ``csrc/alloc.cu``), beside the design it
replaced, the eager PyTorch allocation (``alloc_cuda.allocation_reference``).

- :func:`emulate`: the three passes in plain PyTorch, pass by pass in the
  grid's own layout (K1: each cell's slots in order, a running count a
  class, the words and the class counts; the caller's row extension; K2:
  the class prefix at each target cell, the count grid and the occupancy;
  K3: the codes from the words), which the CPU tests hold to the plain
  version bit for bit;
- :func:`planted`: a state with the allocation's edge cases planted;
- on the card, at both benchmark cells' states (``port_bench``'s adapter:
  the start, equilibration and warm-up block from a seed),
  :func:`cell_report`: the kernels torch.equal to the eager allocation
  after 1, 4 and 6 steps of a window and on the planted state; both timed
  in 7 interleaved repeats of 20 calls (CUDA events, the card spinning
  first); the byte bound (:func:`bound_bytes`); the device ops of one
  allocation; the kernels' launches over one production block beside the
  rebuilds in it.

    python tests/torch_alloc_designs.py

Prints one JSON line last. ``chip_smoke.py`` runs :func:`cell_report` too.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import alloc_cuda  # noqa: E402

CELLS = ("lj2d-n1m", "lj3d-inlj-2m")
STEPS = (1, 4, 6)


def _dir(j: int, k: int, d: int) -> int:
    """Direction of class ``j`` on axis ``k``, in {-1, 0, 1}."""
    return (j // 3 ** (d - 1 - k)) % 3 - 1


def _moved(row, col, j: int, s: int, d: int, cps: int):
    """Flat index into an extended ``(rows + 2, plane)`` array of the cells
    ``(row, col)`` moved by ``s`` times class ``j``'s direction (the rows
    through the extension, the plane's axes periodically)."""
    r = row + 1 + s * _dir(j, 0, d)
    if d == 3:
        cy = (torch.div(col, cps, rounding_mode="floor") + s * _dir(j, 1, d)) % cps
        cz = (col % cps + s * _dir(j, 2, d)) % cps
        c = cy * cps + cz
    else:
        c = (col + s * _dir(j, 1, d)) % cps
    return r * cps ** (d - 1) + c


def emulate(pos, occ, overflow, *, cps: int, box: float, rows_per_block: int = 1, row0: int = 0, row_ext):
    """The three passes of ``csrc/alloc.cu`` in plain PyTorch, in the
    grid's layout: ``(*wrapped, scode, occ_new, overflow, counts)`` as
    ``alloc_cuda.allocate`` returns them. The float steps are the PyTorch
    operations the kernel reproduces (``alloc_math.cuh``); the rest walks
    the slots of every cell in order, as a K1 thread does, then prefixes
    the classes at each target (K2) and turns each word into its code
    (K3)."""
    d = len(pos)
    n_blocks, cap, lanes = pos[0].shape
    plane = cps ** (d - 1)
    rows = n_blocks * rows_per_block
    cells, k = rows * plane, 3**d
    stay = (k - 1) // 2
    dev = pos[0].device
    i32 = torch.int32
    c = torch.arange(cells, device=dev)
    first = torch.div(c, lanes, rounding_mode="floor") * cap * lanes + c % lanes
    row, col = torch.div(c, plane, rounding_mode="floor"), c % plane
    home = [row0 + row] + ([torch.div(col, cps, rounding_mode="floor"), col % cps] if d == 3 else [col])
    occ_f = occ.reshape(-1)

    # K1
    wrapped = [torch.remainder(x, box) for x in pos]
    flat_w = [w.reshape(-1) for w in wrapped]
    cnt = torch.zeros((k, cells), dtype=i32, device=dev)
    word = torch.empty(occ_f.shape, dtype=i32, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    for a in range(cap):
        i = first + a * lanes
        j = torch.zeros(cells, dtype=torch.int64, device=dev)
        far = torch.zeros(cells, dtype=torch.bool, device=dev)
        for w, h in zip(flat_w, home):
            t = torch.div(w[i], box / cps, rounding_mode="floor").to(i32).clamp(0, cps - 1)
            dk = (t - h + 1 + cps) % cps - 1
            far = far | (dk < -1) | (dk > 1)
            j = j * 3 + dk + 1
        o = occ_f[i] > 0.5
        flag = flag | (o & far).any()
        j = torch.where(far, stay, j)
        rank = cnt[j, c]
        cnt[j[o], c[o]] += 1
        word[i] = torch.where(o, (rank << alloc_cuda.CLASS_BITS) | j.to(i32), -1)
    counts_ext = row_ext(cnt.view(k, rows, plane), 1).reshape(k, -1)

    # K2
    bases = torch.empty((k, cells), dtype=i32, device=dev)
    base = torch.zeros(cells, dtype=i32, device=dev)
    for j in range(k):
        bases[j] = base
        base = base + counts_ext[j, _moved(row, col, j, -1, d, cps)]
    tot = torch.clamp(base, max=cap)
    occ_new = torch.empty_like(occ_f)
    slots = first[None] + torch.arange(cap, device=dev)[:, None] * lanes
    occ_new[slots] = (torch.arange(cap, device=dev)[:, None] < tot[None]).to(occ.dtype)
    flag = flag | overflow
    bases_ext = row_ext(bases.view(k, rows, plane), 1).reshape(k, -1)

    # K3
    code = word.clone()
    i = torch.nonzero(word >= 0).squeeze(1)
    w = word[i]
    j = w & ((1 << alloc_cuda.CLASS_BITS) - 1)
    ci = torch.div(i, cap * lanes, rounding_mode="floor") * lanes + i % lanes
    target = torch.empty_like(w)
    for jj in range(k):
        m = j == jj
        cc = ci[m]
        target[m] = bases_ext[jj, _moved(torch.div(cc, plane, rounding_mode="floor"), cc % plane, jj, 1, d, cps)]
    target = target + (w >> alloc_cuda.CLASS_BITS)
    code[i] = torch.where(target < cap, j * cap + target, -1)
    flag = flag | (target >= cap).any()
    shape = pos[0].shape
    return (*wrapped, code.view(shape), occ_new.view(shape), flag, tot.view(rows, plane))


def _homes(md, s) -> list:
    """Each slot's cell (the one it lies in), one flat tensor an axis."""
    n_blocks, cap, lanes = s.xg.shape
    i = torch.arange(s.xg.numel(), device=s.xg.device)
    c = torch.div(i, cap * lanes, rounding_mode="floor") * lanes + i % lanes
    col = c % md.plane
    rest = [torch.div(col, md.cps, rounding_mode="floor"), col % md.cps] if len(md.AXES) == 3 else [col]
    return [md._row0 + torch.div(c, md.plane, rounding_mode="floor")] + rest


PLANTED = ("crowd", "far", "face", "box", "below")


def planted(md, s, seed: int = 5, only=PLANTED):
    """``s`` with the allocation's edge cases planted (those named in
    ``only``), each on particles of its own, chosen by the cell they lie in
    (any D, layout and device): ``crowd``, ``cap + 2`` particles of the
    cells around cell (1, 1[, 1]) moved into it (more than its capacity:
    the last arrivals get no slot and raise ``overflow``); ``far``, a far
    mover from cell row 1 to the middle of row 3 (it stays and raises
    ``overflow``); ``face``, a y coordinate exactly on the float32 face
    between y-cells 2 and 3, from y-cell 3; ``box``, an x of ``box`` from
    cell row ``cps - 1`` (it wraps to 0: a move to row 0); ``below``, an x
    of ``-skin/2`` from cell row 0 (a move to row ``cps - 1``). The
    particles are the same whichever cases are planted."""
    gen = torch.Generator().manual_seed(seed)
    cell = md.box / md.cps
    occ = s.occ.reshape(-1) > 0.5
    grids = [getattr(s, f"{a}g").clone() for a in md.AXES]
    flat = [g.view(-1) for g in grids]
    home = _homes(md, s)
    used = torch.zeros_like(occ)

    def take(mask, n: int = 1):
        idx = torch.nonzero(mask & occ & ~used).squeeze(1)[:n]
        if idx.numel() < n:
            raise ValueError(f"found {idx.numel()} particles for a planted case, need {n}")
        used[idx] = True
        return idx

    def f32(v: float) -> float:
        return float(torch.tensor(v, dtype=torch.float32))

    near = torch.stack([(h - 1).abs() <= 1 for h in home]).all(0) & ~torch.stack([h == 1 for h in home]).all(0)
    crowd = take(near, md.cap + 2)
    inside = [(cell * (1.1 + 0.8 * torch.rand(crowd.numel(), generator=gen))).to(f.dtype).to(f.device)
              for f in flat]
    cases = {"crowd": [(k, crowd, v) for k, v in enumerate(inside)],
             "far": [(0, take(home[0] == 1), f32(3.5 * cell))],
             "face": [(1, take(home[1] == 3), f32(3.0 * cell))],
             "box": [(0, take(home[0] == md.cps - 1), f32(md.box))],
             "below": [(0, take(home[0] == 0), f32(-0.5 * md.skin))]}
    for name in only:
        for k, idx, v in cases[name]:
            flat[k][idx] = v
    return s.replace(**{f"{a}g": g for a, g in zip(md.AXES, grids)})


def reference(md, s):
    """The eager allocation of the engine ``md`` on ``s``, on any device."""
    return alloc_cuda.allocation_reference([getattr(s, f"{a}g") for a in md.AXES], s.occ, s.overflow, cps=md.cps,
                                           box=md.box, rows_per_block=md.rows_per_block, row0=md._row0,
                                           row_ext=md._row_ext)


def assert_equal(got, want, label: str) -> None:
    """Every output of two allocations torch.equal (wrapped planes, codes,
    occupancy, overflow, count grid)."""
    names = [f"wrapped[{k}]" for k in range(len(got) - 4)] + ["scode", "occ_new", "overflow", "counts"]
    for name, a, b in zip(names, got, want):
        if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)):
            raise AssertionError(f"{label}: {name} differs")


def bound_bytes(md) -> int:
    """Least bytes an allocation moves: the D coordinate planes and the
    occupancy read, the D wrapped planes, the codes and the occupancy
    written, 4 bytes a slot each; the count grid and the 3^D class counts,
    4 bytes a cell each."""
    d = len(md.AXES)
    slots = md.n_rows * md.cap * md.plane
    return 4 * (slots * (2 * d + 3) + md.n_rows * md.plane * (1 + 3**d))


def cell_state(name: str, seed: int, device):
    """``(sim, md, s)``: the benchmark cell ``name``'s adapter built from
    ``seed`` (start, equilibration, warm-up block), its engine, and the
    state binned afresh from the adapter's start."""
    from port_bench import harness

    cell = harness.load_cell(name)
    sim = harness.system_class(cell)(cell.config, cell.traffic, seed, device)
    md = sim.md
    return sim, md, md.init(sim.start.position, sim.start.velocity)


def check_states(md, s0, label: str) -> list:
    """The kernels against the eager allocation on ``s0`` after 1, 4 and 6
    steps of a window and on each of those planted; returns the states'
    overflow flags (False, False, False, True, True, True expected)."""
    flags = []
    for planting in (False, True):
        for n in STEPS:
            s = md._window_for(s0, n)(s0)
            if planting:
                s = planted(md, s)
            got = md._migration_dest(s)
            assert_equal(got, reference(md, s), f"{label} after {n} steps{', planted' if planting else ''}")
            flags.append(bool(got[-2]))
    return flags


def cell_report(name: str, seed: int, smi: str) -> dict:
    """At the benchmark cell ``name`` (state from ``seed``): the checks of
    :func:`check_states`, the times of the kernels and of the eager
    allocation, the bound, the device ops of one allocation, and the
    kernels' launches over one production block beside its rebuilds
    (migrate launches). Prints each and returns them."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda, migrate_cuda3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import roofline
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import (
        device_op_count,
        interleaved_ms,
        spread,
    )

    dev = torch.device("cuda")
    sim, md, s0 = cell_state(name, seed, dev)
    flags = check_states(md, s0, name)
    print(f"A1 {name}: grid {tuple(s0.xg.shape)} (R={md.rows_per_block}, cap {md.cap}, {3 ** len(md.AXES)} "
          f"classes): the kernels torch.equal to the eager allocation in every output after {STEPS} steps and "
          f"on those states planted; overflow {flags}", flush=True)
    if flags != [False] * len(STEPS) + [True] * len(STEPS):
        raise AssertionError(f"A1 {name}: overflow {flags}")
    s = md._window_for(s0, 4)(s0)
    t = interleaved_ms({"kernels": lambda: md._migration_dest(s), "eager": lambda: reference(md, s)}, lead=True)
    ops = {k: sum(device_op_count(fn).values()) for k, fn in
           (("kernels", lambda: md._migration_dest(s)), ("eager", lambda: reference(md, s)))}
    b = roofline.bound(0.0, bound_bytes(md))

    def counters():
        return (alloc_cuda.LAUNCHES, migrate_cuda.LAUNCHES + migrate_cuda.PACKED_LAUNCHES + migrate_cuda3.LAUNCHES
                + migrate_cuda3.FLAT_LAUNCHES)

    before = counters()
    sim.block(sim.start)
    torch.cuda.synchronize()
    launches, rebuilds = (b_ - a_ for a_, b_ in zip(before, counters()))
    if launches != rebuilds or not launches:
        raise AssertionError(f"A1 {name}: {launches} allocations on the card in a block of {rebuilds} rebuilds")
    print(f"{smi}: A1 {name} time (medians of 7 interleaved repeats of 20 calls, lead): kernels {spread(t['kernels'])}"
          f", eager {spread(t['eager'])}; bound {b[0]:.5f} ms ({b[1]}: {bound_bytes(md)} bytes), "
          f"{100 * b[0] / t['kernels'][0]:.1f}% of it; device ops an allocation {ops['kernels']} (eager "
          f"{ops['eager']}); a {sim.steps_per_block}-step block: {launches} allocations on the card, "
          f"{rebuilds} rebuilds", flush=True)
    return {"kernel_ms": t["kernels"], "plain_ms": t["eager"], "bound_ms": b[0], "bound_by": b[1],
            "bytes": bound_bytes(md), "ops": ops["kernels"], "eager_ops": ops["eager"],
            "block_launches": launches, "block_rebuilds": rebuilds, "overflow": flags}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_alloc_designs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {name: cell_report(name, seed, smi) for name, seed in zip(CELLS, (4200000017, 4200000029))}
    print(json.dumps({"alloc": out, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
