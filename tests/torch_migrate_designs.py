"""Kernel B2 (the 2D rebuild permutation: unpacked, packed and halo) against
the design it replaced, on the card: both checked against the plain
versions, then timed in turns in one process.

    python tests/torch_migrate_designs.py OUT_DIR

The previous design is built here, from the source below, with ``nvcc``
into ``OUT_DIR``; the port does not ship it. One rebuild of it was:

- a ``torch.stack`` of the F field planes into one (F, G, cap, R * cps)
  tensor;
- a fill launch that writes ``fills[f]`` into every one of the F x G x cap
  x R * cps output elements, one thread an element, its field found by a
  64-bit division;
- a scatter launch, one thread a source slot, that writes the slot's F
  fields to the target its code names (B2 halo: from the ``(rows + 2)``
  extended rows, a write outside the local rows dropped).

The states are ``chip_smoke.py``'s: phase 2's (2D N=100k, 121 cells per
side, R = 1), phase 15's at N=16,384 (49 cells per side, R = 49) and at
N=1M (385 cells per side, R = 7), each 20 steps after a rebuild, and phase
24's N=97,044 (120 cells per side) at one rank's shape with the halo rows.
On each, the rebuild's inputs as the engine passes them (the planes where
they lie, the allocation's occupancy) and an overflow state made from them
(:func:`overflow_state`: every particle moved by up to 0.45 of a cell, then
more particles than a cell's capacity crowded into one cell, so the
allocation drops the last arrivals): the previous design and the port's
B2 are torch.equal to the plain version, then timed in 7 interleaved
repeats of 20 calls, each queued behind a spin of the card
(``utils.profiling.cuda_ms(lead=True)``): the whole previous rebuild step
(stack, fill, scatter), its fill alone, its scatter alone, and the port's
kernel; and the host microseconds a call of each wrapper.
``chip_smoke.py`` builds the previous design with :func:`build` and times
it beside B2, B2 packed and B2 halo.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;

struct Fills {
  float v[kMaxFields];
};

__global__ void migrate_fill_kernel(float* __restrict__ out, Fills fills, int n_fields, int n_slots) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_fields) * n_slots) return;
  out[i] = fills.v[i / n_slots];
}

__global__ void migrate_scatter_kernel(const int* __restrict__ scode, const float* __restrict__ fields,
                                       float* __restrict__ out, int n_fields, int cps, int cap,
                                       int rows_per_block) {
  const int R = rows_per_block;
  const int lanes = R * cps;
  const int row = cap * lanes;
  const int n_slots = (cps / R) * row;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int code = scode[s];
  if (code < 0 || code >= 9 * cap) return;
  const int dcode = code / cap;
  const int a = code % cap;
  const int lane = s % lanes;
  int tx = (s / row) * R + lane / cps + dcode / 3 - 1;
  int ty = lane % cps + dcode % 3 - 1;
  tx += tx < 0 ? cps : (tx >= cps ? -cps : 0);
  ty += ty < 0 ? cps : (ty >= cps ? -cps : 0);
  const int t = (tx / R) * row + a * lanes + (tx % R) * cps + ty;
  for (int f = 0; f < n_fields; ++f) out[f * n_slots + t] = fields[f * n_slots + s];
}

__global__ void migrate_halo_scatter_kernel(const int* __restrict__ scode, const float* __restrict__ fields,
                                            float* __restrict__ out, int n_fields, int n_rows, int cps,
                                            int cap) {
  const int row = cap * cps;
  const int n_src = (n_rows + 2) * row;
  const int n_out = n_rows * row;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_src) return;
  const int code = scode[s];
  if (code < 0 || code >= 9 * cap) return;
  const int dcode = code / cap;
  const int a = code % cap;
  const int tx = s / row + dcode / 3 - 2;
  if (tx < 0 || tx >= n_rows) return;
  int ty = s % cps + dcode % 3 - 1;
  ty += ty < 0 ? cps : (ty >= cps ? -cps : 0);
  const int t = (tx * cap + a) * cps + ty;
  for (int f = 0; f < n_fields; ++f) out[f * n_out + t] = fields[f * n_src + s];
}

}  // namespace

// n_rows: the output's cell rows (cps without halo); what: 0 the fill then
// the scatter (the previous B2 launcher), 1 the fill alone, 2 the scatter
// alone
extern "C" int design_migrate(const int* scode, const float* fields, float* out, const float* fills,
                              int n_fields, int n_rows, int cps, int cap, int rows_per_block, int halo,
                              int what, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  Fills f{};
  for (int k = 0; k < n_fields; ++k) f.v[k] = fills[k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int n_out = n_rows * cap * cps;
  if (what != 2) {
    const long long total = static_cast<long long>(n_fields) * n_out;
    migrate_fill_kernel<<<static_cast<int>((total + threads - 1) / threads), threads, 0, st>>>(
        out, f, n_fields, n_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (what != 1) {
    if (halo) {
      const int n_src = (n_rows + 2) * cap * cps;
      migrate_halo_scatter_kernel<<<(n_src + threads - 1) / threads, threads, 0, st>>>(
          scode, fields, out, n_fields, n_rows, cps, cap);
    } else {
      migrate_scatter_kernel<<<(n_out + threads - 1) / threads, threads, 0, st>>>(
          scode, fields, out, n_fields, cps, cap, rows_per_block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(out_dir: Path):
    """``design_migrate`` from ``SOURCE``, built with the port's nvcc
    flags."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "migrate_designs.cu", out_dir / "libmigrate_designs.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).design_migrate
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def previous(fn, scode, fields, fills, rows_per_block: int = 1, halo: bool = False, what: int = 0):
    """One rebuild of the previous design: the stack (``fields`` a list of
    planes), the fill and the scatter (``what`` 1: the fill alone, 2: the
    scatter alone, into an uninitialised output). Returns the output."""
    import torch

    stacked = torch.stack(fields) if isinstance(fields, (list, tuple)) else fields
    n_fields, ext_rows, cap, lanes = stacked.shape
    rows = ext_rows - 2 if halo else ext_rows
    cps = lanes // rows_per_block
    out = torch.empty((n_fields, rows, cap, lanes), dtype=stacked.dtype, device=stacked.device)
    status = fn(scode.data_ptr(), stacked.data_ptr(), out.data_ptr(), (ctypes.c_float * n_fields)(*fills),
                n_fields, rows * rows_per_block, cps, cap, rows_per_block, int(halo), what,
                torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"previous B2 design: CUDA error {status}")
    return out


def rebuild_inputs(md, gs):
    """The rebuild's inputs on ``gs``, as ``GridMD._rebuild_migrate`` makes
    them: the code grid, the allocation's occupancy, the field planes (Kahan
    residuals included where the state has them) and their fills, and the
    allocation's overflow flag."""
    import torch

    xw, yw, scode, occ, overflow, _ = md._migration_dest(gs)
    planes = [xw, yw, gs.vxg, gs.vyg, gs.fxg, gs.fyg, gs.pid.to(torch.float32)]
    fills = [md.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
    if gs.crx is not None:
        planes += [gs.crx, gs.cry, gs.cvx, gs.cvy]
        fills += [0.0] * 4
    return scode, occ, planes, fills, overflow


def emulate(scode, planes, occ, fills, rows_per_block: int = 1, halo: bool = False):
    """``csrc/migrate.cu``'s launch in plain Python, on CPU tensors: for each
    source block row, lane and slot, the scatter of its fields to the target
    its code names (a halo target outside the local rows dropped), and the
    fill of the same output slot where ``occ`` is 0; each output element's
    writes counted. Returns ``(out, writes)``; an element never written
    stays NaN."""
    import numpy as np
    import torch

    code = scode.numpy()
    fields = np.stack([f.numpy() for f in planes])
    occ = occ.numpy()
    r = rows_per_block
    src_rows, cap, lanes = code.shape
    cps, n_rows = lanes // r, occ.shape[0]
    out = np.full((len(fills),) + occ.shape, np.nan, np.float32)
    writes = np.zeros(occ.shape, np.int64)
    for g in range(src_rows):
        local = not halo or 1 <= g <= n_rows
        lg = g - 1 if halo else g
        for lane in range(lanes):
            sub, cy = divmod(lane, cps)
            cx = lg * r + sub
            for a in range(cap):
                v = int(code[g, a, lane])
                if 0 <= v < 9 * cap:
                    d, ta = divmod(v, cap)
                    tx = cx + d // 3 - 1
                    if not halo or 0 <= tx < n_rows:
                        tx %= cps
                        t = (tx // r, ta, (tx % r) * cps + (cy + d % 3 - 1) % cps)
                        out[(slice(None),) + t] = fields[:, g, a, lane]
                        writes[t] += 1
                if local and not occ[lg, a, lane] > 0.5:
                    out[:, lg, a, lane] = fills
                    writes[lg, a, lane] += 1
    return torch.from_numpy(out), writes


def overflow_state(md, gs, seed: int = 5):
    """``gs`` with every particle moved by up to 0.45 of a cell on each axis
    (unwrapped), then ``cap + 8`` particles of the cells around cell (1, 1)
    moved to points inside it: more than its capacity, so the allocation
    raises ``overflow`` and drops the last arrivals. Any layout (the cells
    are found from the coordinates)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cell = md.box / md.cps
    occ = gs.occ > 0.5
    moved = [g + torch.from_numpy(rng.uniform(-0.45, 0.45, tuple(g.shape)).astype(np.float32)).to(g.device)
             * cell * occ for g in (gs.xg, gs.yg)]
    cx, cy = (torch.div(torch.remainder(g, md.box), cell, rounding_mode="floor").long() for g in moved)
    near = occ & ((cx - 1).abs() <= 1) & ((cy - 1).abs() <= 1) & ~((cx == 1) & (cy == 1))
    pick = torch.nonzero(near.reshape(-1)).squeeze(1)[: md.cap + 8]
    if pick.numel() < md.cap + 8:
        raise ValueError(f"only {pick.numel()} particles around cell (1, 1), need {md.cap + 8}")
    for g in moved:
        g.view(-1)[pick] = torch.from_numpy(
            (cell * (1.1 + 0.8 * rng.random(pick.numel()))).astype(np.float32)).to(g.device)
    return gs.replace(xg=moved[0], yg=moved[1])


def advanced(cfg, dev):
    """``chip_smoke.py``'s state for ``cfg``: 150 gated windows from the
    lattice, then 20 steps after the (trailing) rebuild, some coordinates
    outside [0, box). Returns ``(md, state)``."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    m = lj_fluid._make_grid_md(cfg, dev)
    k, gate = lj_fluid._grid_inner_steps(cfg, m)
    st = lj_fluid.init_state(cfg, dev)
    g = m.make_production_run(150 * k, k, gate_frac=gate)(m.init(st.position, st.velocity))
    return m, m._make_window(m.force_kernel, 20)(g)


def config(n: int):
    """``chip_smoke.py``'s 2D configuration at ``n`` particles."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override

    return override(MDConfig(), n=n, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, init="lattice", force_impl="grid",
                    compensated=True, eq_steps=2000, prod_steps=2000, sample_every=100)


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import host_us, interleaved_ms, spread

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    fn = build(Path(sys.argv[1]))
    dev = torch.device("cuda")
    for n in (100_000, 16_384, 1_000_000):
        md, gs = advanced(config(n), dev)
        r = md.rows_per_block
        for label, st in (("state", gs), ("overflow state", overflow_state(md, gs))):
            scode, occ, planes, fills, ovf = rebuild_inputs(md, st)
            want = migrate_cuda.migrate_reference(scode, torch.stack(planes), fills, r)
            for name, got in (("previous", previous(fn, scode, planes, fills, r)),
                              ("B2", migrate_cuda.migrate(scode, planes, fills, r, occ=occ))):
                if not torch.equal(got, want):
                    raise AssertionError(f"N={n} {label}: {name} not torch.equal to migrate_reference")
            print(f"N={n} {label} (R={r}, grid {tuple(scode.shape)}, overflow {bool(ovf)}): previous and B2 "
                  "torch.equal to the plain version", flush=True)
        scode, occ, planes, fills, _ = rebuild_inputs(md, gs)
        stacked = torch.stack(planes)
        t = interleaved_ms({
            "B2": lambda: migrate_cuda.migrate(scode, planes, fills, r, occ=occ),
            "previous": lambda: previous(fn, scode, planes, fills, r),
            "stack": lambda: torch.stack(planes),
            "fill": lambda: previous(fn, scode, stacked, fills, r, what=1),
            "scatter": lambda: previous(fn, scode, stacked, fills, r, what=2),
        }, lead=True)
        host = {"B2": host_us(lambda: migrate_cuda.migrate(scode, planes, fills, r, occ=occ)),
                "previous": host_us(lambda: previous(fn, scode, planes, fills, r))}
        print(f"N={n} grid {tuple(scode.shape)} (R={r}), {len(planes)} fields; medians of 7 interleaved repeats "
              f"of 20 calls (lead): " + ", ".join(f"{k} {spread(v)}" for k, v in t.items())
              + "; host us a call: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
        del md, gs, scode, occ, planes, stacked

    cfg24 = config(100_000)
    md24, g24 = advanced(config(scaling._round_to_divisible_n(cfg24.n, cfg24, [1, 2, 4])), dev)
    for label, st in (("state", g24), ("overflow state", overflow_state(md24, g24))):
        scode, occ, planes, fills, ovf = rebuild_inputs(md24, st)
        stacked = torch.stack(planes)
        want = migrate_cuda.migrate_reference(scode, stacked, fills)
        for p in (1, 2, 3, 4):
            cb, fb = halo_blocks(scode, p), halo_blocks(stacked, p, dim=1)
            for name, got in (
                    ("previous", [previous(fn, c, f, fills, halo=True) for c, f in zip(cb, fb)]),
                    ("B2 halo", [migrate_cuda.migrate_halo(c, f, fills, occ=o)
                                 for c, f, o in zip(cb, fb, occ.tensor_split(p))])):
                if not torch.equal(torch.cat(got, 1), want):
                    raise AssertionError(f"halo {label} over {p} blocks: {name} not torch.equal to B2's plain version")
        print(f"N={md24.n} halo {label} (overflow {bool(ovf)}): previous and B2 halo over 1-4 row blocks torch.equal "
              "to the plain version", flush=True)
    scode, occ, planes, fills, _ = rebuild_inputs(md24, g24)
    (ch,), (fh,) = halo_blocks(scode, 1), halo_blocks(torch.stack(planes), 1, dim=1)
    th = interleaved_ms({
        "B2 halo": lambda: migrate_cuda.migrate_halo(ch, fh, fills, occ=occ),
        "previous halo": lambda: previous(fn, ch, fh, fills, halo=True),
        "fill": lambda: previous(fn, ch, fh, fills, halo=True, what=1),
        "scatter": lambda: previous(fn, ch, fh, fills, halo=True, what=2),
    }, lead=True)
    host = {"B2 halo": host_us(lambda: migrate_cuda.migrate_halo(ch, fh, fills, occ=occ)),
            "previous halo": host_us(lambda: previous(fn, ch, fh, fills, halo=True))}
    print(f"N={md24.n} one rank's halo shape {tuple(ch.shape)} -> {tuple(scode.shape)}; medians of 7 interleaved "
          f"repeats of 20 calls (lead): " + ", ".join(f"{k} {spread(v)}" for k, v in th.items())
          + "; host us a call: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
