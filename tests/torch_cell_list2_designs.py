"""B3's partner list against the designs around it, on the card, at the
benchmark cell ``lj2d-n1m``'s state (N=1,000,000, 385 cells a side, R=7):

    python tests/torch_cell_list2_designs.py OUT_DIR

- B3 as the counted loop (every candidate staged in shared memory), the
  port's list form (16-bit entries ``offset << 7 | slot``; the listed
  partners read from the x and y planes, 19 MB at N=1M, which the card's
  50 MB L2 holds, a group's four partners loaded before any of its pairs;
  ``csrc/cell_force.cu``), the list form on empty lists (its counts and
  writes alone) and the list's build;
- two more walks of the same list, built here from the source below into
  ``OUT_DIR`` (the port does not ship them; it includes
  ``csrc/cell_force.cu`` for the list's layout and B3's strip): the list
  form's first design, which walks the strip staged in shared memory as
  B3 stages it (also on empty lists: its staging and writes alone), and a
  walk from the planes that loads one partner at a time, working its seam
  offset out where the entry's offset changes.

The state is the benchmark cell's (``port_bench``'s adapter: the lattice
start, equilibration and the warm-up block from ``--seed``), one block
more, then binned afresh; the forces are taken 3 steps into a window. The
build is checked against its plain version (the numbering, counts and
entries), the three walks are torch.equal to the counted loop there, then
all are timed in 7 interleaved repeats of 20 calls (CUDA events). A warp's
loop trips are counted from the list: the counted loop's, the sum over
the 9 offsets of the fullest staged cell among its 32 targets; the list
form's, its longest list in groups of four. One JSON line on stdout; exit
1 if a check fails.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "jax_tpus_benchmark_physics_simulation_tpu_torch" / "ops" / "kernels" / "csrc"

SOURCE = r"""
#include "cell_force.cu"

namespace {

// the list form with the partners read from the planes: B3's counts and
// prefix staged, no coordinates; each entry's cell and seam offset worked
// out from its offset
__global__ void list2_global_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                    const int* __restrict__ counts, float* __restrict__ fx,
                                    float* __restrict__ fy, int cps, int cap, int R, int W, float box,
                                    float cutoff2, float sigma2, float fscale, List2 list) {
  extern __shared__ float smem[];
  float* sres = smem;  // (2, cap, W)
  int* scnt = reinterpret_cast<int*>(smem + 2 * cap * W);  // (W + 2) of the middle row
  int* sstart = scnt + W + 2;
  unsigned char* tcell = reinterpret_cast<unsigned char*>(sstart + W + 1);
  const int lanes = R * cps;
  const int cx = blockIdx.y, cy0 = blockIdx.x * W;
  const int nc = min(W, cps - cy0);
  const int tid = threadIdx.x;
  auto row_base = [&](int row) { return (row / R) * cap * lanes + (row % R) * cps; };
  for (int j = tid; j < nc; j += blockDim.x) scnt[j + 1] = min(max(counts[cx * cps + cy0 + j], 0), cap);
  __syncthreads();
  if (tid < 32) {
    const int c = tid;
    const int v = c < nc ? scnt[c + 1] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (c >= d) incl += t;
    }
    if (c == 0) sstart[0] = 0;
    if (c < nc) {
      sstart[c + 1] = incl;
      for (int a = incl - v; a < incl; ++a) tcell[a] = static_cast<unsigned char>(c);
    }
  }
  __syncthreads();
  const float two_fscale = 2.0f * fscale;
  const float r2_lo = sigma2 * 0x1p-46f;
  const int total = sstart[nc];
  const int base_t = row_base(cx) + cy0;
  const int g0 = list.first[blockIdx.y * gridDim.x + blockIdx.x];
  for (int t = tid; t < total; t += blockDim.x) {
    const int c = tcell[t];
    const int a = t - sstart[c];
    const float xi = x[base_t + a * lanes + c];
    const float yi = y[base_t + a * lanes + c];
    const int cy = cy0 + c;
    float acc_x = 0.0f, acc_y = 0.0f, part_x = 0.0f, part_y = 0.0f;
    const int g = g0 + t;
    const int n_list = list.words[g];  // every target is listed on this state (checked by the caller)
    int cur = -1;
    int base = 0;
    float off_x = 0.0f, off_y = 0.0f;
    auto pair = [&](unsigned int entry) {
      const int o = static_cast<int>(entry >> kListSlotBits);
      if (o != cur) {
        acc_x += part_x;
        acc_y += part_y;
        part_x = 0.0f;
        part_y = 0.0f;
        cur = o;
        int nx = cx + o / 3 - 1, ny = cy + o % 3 - 1;
        off_x = 0.0f;
        off_y = 0.0f;
        if (nx < 0) { nx += cps; off_x = -box; } else if (nx >= cps) { nx -= cps; off_x = box; }
        if (ny < 0) { ny += cps; off_y = -box; } else if (ny >= cps) { ny -= cps; off_y = box; }
        base = row_base(nx) + ny;
      }
      const int src = base + static_cast<int>(entry & ((1u << kListSlotBits) - 1)) * lanes;
      const float ddx = xi - (x[src] + off_x);
      const float ddy = yi - (y[src] + off_y);
      const float r2 = ddx * ddx + ddy * ddy;
      const bool valid = (r2 > 0.0f) && (r2 < cutoff2);
      const float inv = div_rn_normal(sigma2, fmaxf(r2, r2_lo));
      const float s6 = inv * inv * inv;
      const float fmag = valid ? s6 * inv * (two_fscale * s6 - fscale) : 0.0f;
      part_x += fmag * ddx;
      part_y += fmag * ddy;
    };
    const int n_groups = (n_list + 3) >> 2;
    const unsigned long long* gp = reinterpret_cast<const unsigned long long*>(list.words + list.T) + g;
    for (int q = 0; q < n_groups; ++q) {
      const unsigned long long grp = gp[static_cast<long long>(q) * list.T];
      pair(static_cast<unsigned int>(grp & 0xFFFFu));
      pair(static_cast<unsigned int>((grp >> 16) & 0xFFFFu));
      pair(static_cast<unsigned int>((grp >> 32) & 0xFFFFu));
      pair(static_cast<unsigned int>(grp >> 48));
    }
    acc_x += part_x;
    acc_y += part_y;
    sres[a * W + c] = acc_x;
    sres[W * cap + a * W + c] = acc_y;
  }
  __syncthreads();
  for (int j = tid; j < cap * nc; j += blockDim.x) {
    const int a = j / nc, c = j % nc;
    const bool occ = a < scnt[c + 1];
    const int dst = base_t + a * lanes + c;
    fx[dst] = occ ? sres[a * W + c] : 0.0f;
    fy[dst] = occ ? sres[W * cap + a * W + c] : 0.0f;
  }
}

// the list walked in the strip staged in shared memory as B3 stages it
// (the list form's first design): B3's steps 1 to 3, then each target's
// entries from the staged cells
__global__ void list2_staged_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                    const int* __restrict__ counts, float* __restrict__ fx,
                                    float* __restrict__ fy, int cps, int cap, int R, int W, float box,
                                    float cutoff2, float sigma2, float fscale, List2 list) {
  extern __shared__ float smem[];
  const StripSmem L{W, cap, 2};
  Strip2 S(smem, L, cps, cap, R);
  S.load(x, y, counts, box);
  const int n_cols = S.n_cols, nc = S.nc, lanes = S.lanes;
  const float two_fscale = 2.0f * fscale;
  const float r2_lo = sigma2 * 0x1p-46f;
  const int total = S.sstart[nc];
  const int base_t = S.row_base(S.cx) + S.cy0;
  const int g0 = list.first[strip_index()];
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * lanes + c];
    const float yi = y[base_t + a * lanes + c];
    float acc_x = 0.0f, acc_y = 0.0f, part_x = 0.0f, part_y = 0.0f;
    const int g = g0 + t;
    const int n_list = list.words[g];  // every target is listed on this state (checked by the caller)
    int cur = -1;
    auto pair = [&](unsigned int entry) {
      const int o = static_cast<int>(entry >> kListSlotBits);
      const bool flush = o != cur;
      cur = o;
      acc_x += flush ? part_x : 0.0f;
      acc_y += flush ? part_y : 0.0f;
      part_x = flush ? 0.0f : part_x;
      part_y = flush ? 0.0f : part_y;
      const int j = ((o / 3) * n_cols + c + o % 3) * (cap + 1) + static_cast<int>(entry & ((1u << kListSlotBits) - 1));
      const float ddx = xi - S.sx[j];
      const float ddy = yi - S.sy[j];
      const float r2 = ddx * ddx + ddy * ddy;
      const bool valid = (r2 > 0.0f) && (r2 < cutoff2);
      const float inv = div_rn_normal(sigma2, fmaxf(r2, r2_lo));
      const float s6 = inv * inv * inv;
      const float fmag = valid ? s6 * inv * (two_fscale * s6 - fscale) : 0.0f;
      part_x += fmag * ddx;
      part_y += fmag * ddy;
    };
    const int n_groups = (n_list + 3) >> 2;
    const unsigned long long* gp = reinterpret_cast<const unsigned long long*>(list.words + list.T) + g;
    unsigned long long next = n_groups > 0 ? gp[0] : 0ull;
    for (int q = 0; q < n_groups; ++q) {
      const unsigned long long grp = next;
      if (q + 1 < n_groups) next = gp[static_cast<long long>(q + 1) * list.T];
      pair(static_cast<unsigned int>(grp & 0xFFFFu));
      pair(static_cast<unsigned int>((grp >> 16) & 0xFFFFu));
      pair(static_cast<unsigned int>((grp >> 32) & 0xFFFFu));
      pair(static_cast<unsigned int>(grp >> 48));
    }
    acc_x += part_x;
    acc_y += part_y;
    S.sres[a * W + c] = acc_x;
    S.sres[W * cap + a * W + c] = acc_y;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cap * nc; j += blockDim.x) {
    const int a = j / nc, c = j % nc;
    const bool occ = a < S.scnt[n_cols + c + 1];
    const int dst = base_t + a * lanes + c;
    fx[dst] = occ ? S.sres[a * W + c] : 0.0f;
    fy[dst] = occ ? S.sres[W * cap + a * W + c] : 0.0f;
  }
}

}  // namespace

extern "C" int design_list2(const float* x, const float* y, const int* counts, float* fx, float* fy,
                                   int cps, int cap, int R, float box, float cutoff2, float sigma2,
                                   float fscale, const unsigned short* words, const int* first, int k, int T,
                                   int staged, void* stream) {
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = packed_strip(cps, cap, 2, n_sm);
  const int smem = 4 * (2 * cap * W + 2 * W + 3) + W * cap;
  const dim3 grid((cps + W - 1) / W, cps);
  if (staged) {
    list2_staged_kernel<<<grid, packed_threads(W), StripSmem{W, cap, 2}.bytes(), static_cast<cudaStream_t>(stream)>>>(
        x, y, counts, fx, fy, cps, cap, R, W, box, cutoff2, sigma2, fscale, List2{words, first, k, T});
  } else {
    list2_global_kernel<<<grid, packed_threads(W), smem, static_cast<cudaStream_t>(stream)>>>(
        x, y, counts, fx, fy, cps, cap, R, W, box, cutoff2, sigma2, fscale, List2{words, first, k, T});
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(out_dir: Path):
    """``design_list2`` from ``SOURCE``, built with the port's nvcc
    flags; the build log (registers, spills) is printed."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "cell_list2_designs.cu", out_dir / "libcell_list2_designs.so"
    src.write_text(SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
    proc.check_returncode()
    fn = ctypes.CDLL(str(lib)).design_list2
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def warp_trips(md, counts, plist, strip: int):
    """Mean loop trips a warp (32 consecutive targets of a strip's block)
    of the counted loop and of the list form, from the list."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda_packed

    c, cap = md.cps, md.cap
    flat, num, _ = cell_cuda_packed._targets(counts, plist, cap)
    cnt = counts.clamp(0, cap).long()
    cx, cy = flat // (cap * c), flat % c
    d = torch.tensor([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)], device=flat.device)
    cells = cnt[(cx[:, None] + d[:, 0]) % c, (cy[:, None] + d[:, 1]) % c]  # (targets, 9)
    n = plist.counts[num].long()
    # a target's place in its strip's block: its number less the strip's first
    sid = cx * (-(-c // strip)) + cy // strip
    warp = sid * ((strip * cap + 31) // 32) + (num - plist.first.long()[sid]) // 32
    _, warp = torch.unique(warp, return_inverse=True)
    n_w = int(warp.max()) + 1

    def warp_max(v):
        v = v.double()
        out = torch.zeros((n_w,) + v.shape[1:], dtype=v.dtype, device=v.device)
        return out.index_reduce_(0, warp, v, "amax", include_self=True)

    return {
        "counted": float(warp_max(cells).sum(1).mean()),
        "list": float(warp_max((n + 3) // 4 * 4).mean()),
        "list_entries_mean": float(n.double().mean()),
        "list_entries_max": int(n.max()),
        "candidates_mean": float(cells.sum(1).double().mean()),
    }


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda_packed
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms
    from port_bench import harness
    from port_bench.counts import roofline

    out_dir = Path(sys.argv[1])
    design = build(out_dir)
    dev = torch.device("cuda")
    print(harness.card_facts(torch), file=sys.stderr, flush=True)
    cell = harness.load_cell("lj2d-n1m")
    sim = harness.system_class(cell)(cell.config, cell.traffic, 5700000021, dev)
    md = sim.md
    k_in, gate = lj_fluid._grid_inner_steps(sim.cfg, md)
    gs = md.init(sim.start.position, sim.start.velocity)
    gs = md._rebuild_migrate(md.make_production_run(2000, k_in, gate_frac=gate)(gs))
    p, r = md._params, md.rows_per_block
    counts = gs.counts
    plist, full = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, counts, p, r, md.list_r2, md.list_cap, md.n)
    ref, ref_full = cell_cuda_packed.build_partner_list2_reference(gs.xg, gs.yg, counts, p, r, md.list_r2,
                                                                   md.list_cap, plist.stride, plist.strip)
    # 3 steps into a window
    ax = md.AXES
    lf = Leapfrog([getattr(gs, f"v{a}g") for a in ax], [getattr(gs, f"{a}g") for a in ax],
                  [getattr(gs, f"disp{a}") for a in ax], [getattr(gs, f"cr{a}") for a in ax],
                  [getattr(gs, f"cv{a}") for a in ax], dt=md.dt)
    f = [getattr(gs, f"f{a}g") for a in ax]
    for _ in range(3):
        lf.step(f)
        f = cell_cuda_packed.grid_force_packed(*lf.pos, counts, p, r)
    x, y = lf.pos
    outs = [torch.empty_like(x) for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream

    def design_call(pl, staged=0):
        status = design(x.data_ptr(), y.data_ptr(), counts.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                        p.cps, p.cap, r, p.box, p.cutoff2, p.sigma2, p.fscale, pl.words.data_ptr(),
                        pl.first.data_ptr(), pl.k, pl.stride, staged, stream)
        if status:
            raise RuntimeError(f"design_list2: CUDA error {status}")
        return outs

    empty, _ = cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, counts, p, r, 0.0, md.list_cap, md.n)
    want = cell_cuda_packed.grid_force_packed(x, y, counts, p, r)
    got_list = cell_cuda_packed.grid_force_packed(x, y, counts, p, r, plist=plist)
    got_global = [o.clone() for o in design_call(plist)]
    got_staged = [o.clone() for o in design_call(plist, 1)]
    torch.cuda.synchronize()
    _, num, _ = cell_cuda_packed._targets(counts, plist, p.cap)
    _, num_ref, _ = cell_cuda_packed._targets(counts, ref, p.cap)
    n_used = (plist.counts[num] + 3) // 4 * 4
    used = torch.arange(plist.k, device=dev)[None] < n_used[:, None]
    equal = {
        "build_plain": (torch.equal(num.sort().values, torch.arange(md.n, device=dev))
                        and torch.equal(plist.counts[num], ref.counts[num_ref])
                        and torch.equal(torch.where(used, plist.entries[num], 0),
                                        torch.where(used, ref.entries[num_ref], 0))
                        and int(full) == int(ref_full)),
        "list": all(torch.equal(a, b) for a, b in zip(got_list, want)),
        "global": all(torch.equal(a, b) for a, b in zip(got_global, want)),
        "staged": all(torch.equal(a, b) for a, b in zip(got_staged, want)),
        "no_full": int(full) == 0,
        "empty_lists": int(empty.counts[num].max()) == 0,
    }
    trips = warp_trips(md, counts, plist, plist.strip)
    times = interleaved_ms({
        "counted": lambda: cell_cuda_packed.grid_force_packed(x, y, counts, p, r),
        "list": lambda: cell_cuda_packed.grid_force_packed(x, y, counts, p, r, plist=plist),
        "list_empty": lambda: cell_cuda_packed.grid_force_packed(x, y, counts, p, r, plist=empty),
        "global": lambda: design_call(plist),
        "staged": lambda: design_call(plist, 1),
        "staged_empty": lambda: design_call(empty, 1),
        "build": lambda: cell_cuda_packed.build_partner_list2(gs.xg, gs.yg, counts, p, r, md.list_r2,
                                                              md.list_cap, md.n),
    })
    census = roofline.pair_census(md.positions(gs), md.box, md.cps, sim.cfg.cutoff)
    least, by = roofline.force_bound(census, 2, math.prod(md.grid_shape), 4 * md.cps**2)
    line = {
        "card": harness.card_facts(torch), "n": md.n, "cps": md.cps, "rows_per_block": r, "strip": plist.strip,
        "k": md.list_cap,
        "r_list": math.sqrt(md.list_r2), "list_full": int(full), "equal": equal,
        "ms": {k: v[0] for k, v in times.items()}, "ms_min_max": {k: v[1:] for k, v in times.items()},
        "bound_ms": 1e3 * least, "bound_by": by, "census": census,
        "roofline_pct": {k: 1e5 * least / times[k][0] for k in ("counted", "list", "global", "staged")},
        "warp_trips": trips, "list_bytes": plist.words.numel() * 2,
    }
    print(json.dumps(line), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
