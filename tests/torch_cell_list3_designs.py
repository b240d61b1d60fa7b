"""The partner list of the 3D counted kernel against the designs around it,
on the card, at LAMMPS in.lj's geometry (2,048,000 atoms, 46 cells a side,
B5 at bound 32):

    python tests/torch_cell_list3_designs.py OUT_DIR

- the counted kernel (B5, every staged candidate), the port's list form
  (16-bit entries, ``csrc/cell_force3.cu``) and its build (each offset's
  partners as a bitmask, then their entries), beside the build's two
  earlier designs (a branch a kept partner; a branch-free four-entry
  queue), and the list form on empty lists (its staging and writes alone);
- a per-offset bitmask (27 words of 32 bits a target, bit b: slot b of
  that offset's cell is a partner), its build and its force kernel, built
  here from the source below into ``OUT_DIR`` (the port does not ship it;
  it includes ``csrc/cell_force3.cu`` for the staging).

The state is the benchmark cell's (``port_bench``'s adapter: the fcc start,
equilibration and the warm-up block from ``--seed``), one block more, then
binned afresh; the forces are taken 3 steps into a window. The list form
and the bitmask form are torch.equal to the counted kernel there, then all
five are timed in 7 interleaved repeats of 20 calls (CUDA events). A warp's
loop trips are counted from the lists: the counted kernel's, the sum over
the 27 offsets of the fullest staged cell among its 32 targets; the list
form's, its longest list in groups of four; the bitmask's, the sum over
the offsets of its largest partner count. One JSON line on stdout.
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
#include "cell_force3.cu"

namespace {

// the bitmask of target t at offset o of strip s: [s][o][t], 27 words a
// target; bit b set: slot b of the offset's staged cell is a partner
__device__ __forceinline__ long long mask_at(int s, int o, int t, int T) {
  return (static_cast<long long>(s) * 27 + o) * T + t;
}

__global__ void mask3_build_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                   const float* __restrict__ z, Params p, int W, float rlist2,
                                   unsigned int* __restrict__ mask) {
  extern __shared__ float smem[];
  constexpr int COV = 32;
  const Strip3 L{W, COV, 3};
  StripStage S(smem, L, p, W, COV);
  S.load(x, y, z, p, COV);
  const int plane = p.ncy * p.ncz;
  const int row = p.cap * plane;
  const int total = S.sstart[S.nc];
  const int base_t = S.cx * row + S.cy * p.ncz + S.cz0;
  const int T = PartnerList::stride(W, COV);
  const int strip = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * plane + c];
    const float yi = y[base_t + a * plane + c];
    const float zi = z[base_t + a * plane + c];
    const int self = (4 * S.n_cols + c + 1) * (COV + 1) + a;
    for (int r = 0; r < 9; ++r) {
      for (int dz = 0; dz < 3; ++dz) {
        const int cell = r * S.n_cols + c + dz;
        const int base = cell * (COV + 1);
        unsigned int bits = 0;
        for (int b = 0; b < S.scnt[cell]; ++b) {
          const float ddx = xi - S.sx[base + b];
          const float ddy = yi - S.sy[base + b];
          const float ddz = zi - S.sz[base + b];
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          if (!(r2 >= rlist2) && base + b != self) bits |= 1u << b;
        }
        mask[mask_at(strip, r * 3 + dz, t, T)] = bits;
      }
    }
  }
}

__global__ void mask3_force_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                   const float* __restrict__ z, float* __restrict__ fx,
                                   float* __restrict__ fy, float* __restrict__ fz, Params p, int W,
                                   const unsigned int* __restrict__ mask) {
  extern __shared__ float smem[];
  constexpr int COV = 32;
  const Strip3 L{W, COV, 3};
  StripStage S(smem, L, p, W, COV);
  S.load(x, y, z, p, COV);
  const int plane = p.ncy * p.ncz;
  const int row = p.cap * plane;
  const int total = S.sstart[S.nc];
  const int base_t = S.cx * row + S.cy * p.ncz + S.cz0;
  const int T = PartnerList::stride(W, COV);
  const int strip = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const float two_fscale = 2.0f * p.fscale;
  const float r2_lo = p.sigma2 * 0x1p-46f;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * plane + c];
    const float yi = y[base_t + a * plane + c];
    const float zi = z[base_t + a * plane + c];
    float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
    for (int r = 0; r < 9; ++r) {
      for (int dz = 0; dz < 3; ++dz) {
        const int cell = r * S.n_cols + c + dz;
        const int base = cell * (COV + 1);
        unsigned int bits = mask[mask_at(strip, r * 3 + dz, t, T)];
        float part_x = 0.0f, part_y = 0.0f, part_z = 0.0f;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const float ddx = xi - S.sx[base + b];
          const float ddy = yi - S.sy[base + b];
          const float ddz = zi - S.sz[base + b];
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          const bool valid = (r2 > 0.0f) && (r2 < p.cutoff2);
          const float inv = div_rn_normal(p.sigma2, fmaxf(r2, r2_lo));
          const float s6 = inv * inv * inv;
          const float fmag = valid ? s6 * inv * (two_fscale * s6 - p.fscale) : 0.0f;
          part_x += fmag * ddx;
          part_y += fmag * ddy;
          part_z += fmag * ddz;
        }
        acc_x += part_x;
        acc_y += part_y;
        acc_z += part_z;
      }
    }
    const int o = a * W + c;
    S.sres[o] = acc_x;
    S.sres[COV * W + o] = acc_y;
    S.sres[2 * COV * W + o] = acc_z;
  }
  __syncthreads();
  const int base_o = S.cx * row + S.cy * p.ncz + S.cz0;
  for (int j = threadIdx.x; j < p.cap * S.nc; j += blockDim.x) {
    const int a = j / S.nc, c = j % S.nc;
    const bool occ = a < S.scnt[4 * S.n_cols + c + 1];
    const int o = occ ? a * W + c : 0;
    const int dst = base_o + a * plane + c;
    fx[dst] = occ ? S.sres[o] : 0.0f;
    fy[dst] = occ ? S.sres[COV * W + o] : 0.0f;
    fz[dst] = occ ? S.sres[2 * COV * W + o] : 0.0f;
  }
}

// the list build's first design: a branch a kept partner, the entry
// or'ed into the group at a shift of 16 (n & 3), the group stored and
// cleared at every fourth (B5 at bound 32; the shipped build's output)
__global__ void list3_build_branchy_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                           const float* __restrict__ z, Params p, int W, float rlist2,
                                           unsigned short* __restrict__ list) {
  extern __shared__ float smem[];
  constexpr int COV = 32;
  const Strip3 L{W, COV, 3};
  StripStage S(smem, L, p, W, COV);
  S.load(x, y, z, p, COV);
  const int plane = p.ncy * p.ncz;
  const int row = p.cap * plane;
  const int total = S.sstart[S.nc];
  const int base_t = S.cx * row + S.cy * p.ncz + S.cz0;
  const PartnerList PL{static_cast<int>(gridDim.x * gridDim.y * gridDim.z), PartnerList::stride(W, COV), p.list_k};
  const int strip = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const unsigned long long pad = COV;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * plane + c];
    const float yi = y[base_t + a * plane + c];
    const float zi = z[base_t + a * plane + c];
    const int self = (4 * S.n_cols + c + 1) * (COV + 1) + a;
    int n = 0;
    unsigned long long buf = 0;
    for (int r = 0; r < 9; ++r) {
      for (int dz = 0; dz < 3; ++dz) {
        const int cell = r * S.n_cols + c + dz;
        const int cnt = S.scnt[cell];
        const int base = cell * (COV + 1);
#pragma unroll 4
        for (int b = 0; b < cnt; ++b) {
          const float ddx = xi - S.sx[base + b];
          const float ddy = yi - S.sy[base + b];
          const float ddz = zi - S.sz[base + b];
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          if (!(r2 >= rlist2) && base + b != self) {
            if (n < p.list_k) {
              buf |= static_cast<unsigned long long>((cell << kListSlotBits) | b) << (16 * (n & 3));
              if ((n & 3) == 3) {
                *PL.group(list, strip, n >> 2, t) = buf;
                buf = 0;
              }
            }
            ++n;
          }
        }
      }
    }
    if (n <= p.list_k && (n & 3) != 0) {
      for (int k = n & 3; k < 4; ++k) buf |= pad << (16 * k);
      *PL.group(list, strip, n >> 2, t) = buf;
    }
    list[static_cast<long long>(strip) * PL.T + t] = n <= p.list_k ? static_cast<unsigned short>(n) : kListFull;
  }
}

// the list build's second design: each kept partner shifted into the top
// of a four-entry queue without a branch, every fourth stored
__global__ void list3_build_queue_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                         const float* __restrict__ z, Params p, int W, float rlist2,
                                         unsigned short* __restrict__ list) {
  extern __shared__ float smem[];
  constexpr int COV = 32;
  const Strip3 L{W, COV, 3};
  StripStage S(smem, L, p, W, COV);
  S.load(x, y, z, p, COV);
  const int plane = p.ncy * p.ncz;
  const int row = p.cap * plane;
  const int total = S.sstart[S.nc];
  const int base_t = S.cx * row + S.cy * p.ncz + S.cz0;
  const PartnerList PL{static_cast<int>(gridDim.x * gridDim.y * gridDim.z), PartnerList::stride(W, COV), p.list_k};
  const int strip = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const unsigned long long pad = COV;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * plane + c];
    const float yi = y[base_t + a * plane + c];
    const float zi = z[base_t + a * plane + c];
    const int self = (4 * S.n_cols + c + 1) * (COV + 1) + a;
    int n = 0;
    unsigned long long buf = 0;
    for (int r = 0; r < 9; ++r) {
      for (int dz = 0; dz < 3; ++dz) {
        const int cell = r * S.n_cols + c + dz;
        const int cnt = S.scnt[cell];
        const int base = cell * (COV + 1);
        const unsigned long long cell_e = static_cast<unsigned long long>(cell << kListSlotBits) << 48;
#pragma unroll 4
        for (int b = 0; b < cnt; ++b) {
          const float ddx = xi - S.sx[base + b];
          const float ddy = yi - S.sy[base + b];
          const float ddz = zi - S.sz[base + b];
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          const bool take = !(r2 >= rlist2) && base + b != self;
          buf = take ? (buf >> 16) | cell_e | (static_cast<unsigned long long>(b) << 48) : buf;
          n += take ? 1 : 0;
          if (take && (n & 3) == 0 && n <= p.list_k) *PL.group(list, strip, (n >> 2) - 1, t) = buf;
        }
      }
    }
    if (n <= p.list_k && (n & 3) != 0) {
      for (int k = n & 3; k < 4; ++k) buf = (buf >> 16) | (pad << 48);
      *PL.group(list, strip, n >> 2, t) = buf;
    }
    list[static_cast<long long>(strip) * PL.T + t] = n <= p.list_k ? static_cast<unsigned short>(n) : kListFull;
  }
}

template <class K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// what 0: the bitmask build into mask, 1: the forces from it, 2 and 3:
// the list build's first and second designs into list (k entries a
// target); B5 at bound 32 only
extern "C" int design_list3(const float* x, const float* y, const float* z, float* fx, float* fy,
                            float* fz, unsigned int* mask, unsigned short* list, int cps, int cap,
                            float box, float sentinel, float cutoff2, float sigma2, float fscale,
                            float rlist2, int strip, int k, int what, void* stream) {
  Params p{cps, cap, cps, cps, 0, box, sentinel, cutoff2, sigma2, fscale, 0.0f, 0.0f};
  p.list_k = k;
  const int smem = Strip3{strip, 32, 3}.bytes();
  const dim3 grid((cps + strip - 1) / strip, cps, cps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (what == 0) {
    err = prepare(mask3_build_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mask3_build_kernel<<<grid, counted_threads(strip, 32), smem, s>>>(x, y, z, p, strip, rlist2, mask);
  } else if (what == 3) {
    err = prepare(list3_build_queue_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    list3_build_queue_kernel<<<grid, counted_threads(strip, 32), smem, s>>>(x, y, z, p, strip, rlist2, list);
  } else if (what == 2) {
    err = prepare(list3_build_branchy_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    list3_build_branchy_kernel<<<grid, counted_threads(strip, 32), smem, s>>>(x, y, z, p, strip, rlist2, list);
  } else {
    err = prepare(mask3_force_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mask3_force_kernel<<<grid, counted_threads(strip, 32), smem, s>>>(x, y, z, fx, fy, fz, p, strip, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(out_dir: Path):
    """``design_list3`` from ``SOURCE``, built with the port's nvcc flags;
    the build log (registers, spills) is printed."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "cell_list3_designs.cu", out_dir / "libcell_list3_designs.so"
    src.write_text(SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
    proc.check_returncode()
    fn = ctypes.CDLL(str(lib)).design_list3
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def warp_trips(md, gs, plist, occ):
    """Mean loop trips a warp (32 consecutive targets of a block) of the
    counted kernel, the list form and the bitmask, from the list."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3

    c, strip, T = md.cps, plist.strip, plist.stride
    flat, place = cell_cuda3._list_targets(occ, strip, T)
    cnt = occ.sum(1)  # (cx, cy, cz)
    cx, cy, cz = flat // (occ.shape[1] * c * c), (flat // c) % c, flat % c
    # each target's 27 staged cell counts in the loop's order
    d = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                     device=flat.device)
    cells = cnt[(cx[:, None] + d[:, 0]) % c, (cy[:, None] + d[:, 1]) % c, (cz[:, None] + d[:, 2]) % c]
    n = plist.counts.reshape(-1)[place]
    ent = plist.entries.reshape(-1, plist.k)[place]
    o = (ent >> cell_cuda3.LIST_SLOT_BITS) // (strip + 2) * 3 + (ent >> cell_cuda3.LIST_SLOT_BITS) % (strip + 2) \
        - (cz % strip)[:, None]
    used = torch.arange(plist.k, device=flat.device)[None] < n[:, None]
    per_off = torch.zeros((flat.shape[0], 27), dtype=torch.int64, device=flat.device)
    per_off.scatter_add_(1, torch.where(used, o, 0).long(), used.long())
    warp = place // T * ((T + 31) // 32) + place % T // 32  # (strip, warp of its block)
    n_w = int(warp.max()) + 1

    def warp_max(v):
        v = v.double()
        out = torch.zeros((n_w,) + v.shape[1:], dtype=v.dtype, device=v.device)
        return out.index_reduce_(0, warp, v, "amax", include_self=True)

    live = torch.zeros(n_w, dtype=torch.bool, device=flat.device)
    live[warp] = True
    return {
        "counted": float(warp_max(cells).sum(1)[live].mean()),
        "list": float(warp_max((n + 3) // 4 * 4)[live].mean()),
        "mask": float(warp_max(per_off).sum(1)[live].mean()),
        "list_entries_mean": float(n.double().mean()),
        "candidates_mean": float(cells.sum(1).double().mean()),
    }


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import cell_cuda3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import Leapfrog
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms
    from port_bench import harness
    from port_bench.counts import roofline

    out_dir = Path(sys.argv[1])
    design = build(out_dir)
    dev = torch.device("cuda")
    print(harness.card_facts(torch), file=sys.stderr, flush=True)
    cell = harness.load_cell("lj3d-inlj-2m")
    sim = harness.system_class(cell)(cell.config, cell.traffic, 5600000079, dev)
    md = sim.md
    gs = md.init(sim.start.position, sim.start.velocity)
    gs = md._rebuild_migrate(md.make_production_run_fixed(200, sim.cadence)(gs))
    p, cov = md._params, md.static_cov
    if cov != 32 or int(gs.max_occ) > cov:
        raise SystemExit(f"expected B5 at bound 32 on this state, got cov {cov}, max_occ {int(gs.max_occ)}")
    plist, full = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, md.list_r2, md.list_cap, static_cov=cov)
    # 3 steps into a window
    ax = md.AXES
    lf = Leapfrog([getattr(gs, f"v{a}g") for a in ax], [getattr(gs, f"{a}g") for a in ax],
                  [getattr(gs, f"disp{a}") for a in ax], [getattr(gs, f"cr{a}") for a in ax],
                  [getattr(gs, f"cv{a}") for a in ax], dt=md.dt)
    f = [getattr(gs, f"f{a}g") for a in ax]
    for _ in range(3):
        lf.step(f)
        f = cell_cuda3.grid_force3(*lf.pos, p, static_cov=cov)
    x, y, z = lf.pos
    strip = plist.strip
    mask = torch.empty((plist.n_strips * 27 * plist.stride,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(x) for _ in range(3)]

    branchy = cell_cuda3.PartnerList3(torch.empty_like(plist.words), p.cps, cov, cov, strip, plist.k)

    def design_call(what, pos):
        status = design(*(t.data_ptr() for t in (*pos, *outs, mask, branchy.words)), p.cps, p.cap, p.box,
                        p.sentinel, p.cutoff2, p.sigma2, p.fscale, md.list_r2, strip, plist.k, what, stream)
        if status:
            raise RuntimeError(f"design_list3: CUDA error {status}")
        return outs

    def mask_call(what, pos):
        return design_call(what, pos)

    mask_call(0, (gs.xg, gs.yg, gs.zg))
    design_call(2, (gs.xg, gs.yg, gs.zg))
    want = cell_cuda3.grid_force3(x, y, z, p, static_cov=cov)
    got_list = cell_cuda3.grid_force3(x, y, z, p, static_cov=cov, plist=plist)
    got_mask = [o.clone() for o in mask_call(1, (x, y, z))]
    # every list empty: the list form's staging and writes alone
    empty, _ = cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, 0.0, plist.k, static_cov=cov)
    torch.cuda.synchronize()
    occ = gs.xg.view(p.cps, p.cap, p.cps, p.cps)[:, :cov] != p.sentinel
    _, place = cell_cuda3._list_targets(occ, strip, plist.stride)
    n_used = (plist.counts.reshape(-1)[place] + 3) // 4 * 4
    used = torch.arange(plist.k, device=dev)[None] < n_used[:, None]
    def same_as_shipped(other):
        return (torch.equal(plist.counts.reshape(-1)[place], other.counts.reshape(-1)[place])
                and torch.equal(torch.where(used, plist.entries.reshape(-1, plist.k)[place], 0),
                                torch.where(used, other.entries.reshape(-1, plist.k)[place], 0)))

    same = same_as_shipped(branchy)
    design_call(3, (gs.xg, gs.yg, gs.zg))
    torch.cuda.synchronize()
    same_queue = same_as_shipped(branchy)
    equal = {"list": all(torch.equal(a, b) for a, b in zip(got_list, want)),
             "mask": all(torch.equal(a, b) for a, b in zip(got_mask, want)),
             "first_build": same, "queue_build": same_queue,
             "empty_lists": int(empty.counts.reshape(-1)[place].max()) == 0}
    trips = warp_trips(md, gs, plist, occ)
    times = interleaved_ms({
        "counted": lambda: cell_cuda3.grid_force3(x, y, z, p, static_cov=cov),
        "list": lambda: cell_cuda3.grid_force3(x, y, z, p, static_cov=cov, plist=plist),
        "list_build": lambda: cell_cuda3.build_partner_list3(gs.xg, gs.yg, gs.zg, p, md.list_r2, md.list_cap,
                                                             static_cov=cov),
        "list_build_first": lambda: design_call(2, (gs.xg, gs.yg, gs.zg)),
        "list_build_queue": lambda: design_call(3, (gs.xg, gs.yg, gs.zg)),
        "list_empty": lambda: cell_cuda3.grid_force3(x, y, z, p, static_cov=cov, plist=empty),
        "mask": lambda: mask_call(1, (x, y, z)),
        "mask_build": lambda: mask_call(0, (gs.xg, gs.yg, gs.zg)),
    })
    census = roofline.pair_census(md.positions(gs), md.box, md.cps, sim.cfg.cutoff)
    least, by = roofline.force_bound(census, 3, math.prod(md.grid_shape))
    n_targets = int(occ.sum())
    line = {
        "card": harness.card_facts(torch), "n": md.n, "cps": md.cps, "cov": cov, "strip": strip,
        "k": md.list_cap, "r_list": math.sqrt(md.list_r2), "list_full": int(full), "equal": equal,
        "ms": {k: v[0] for k, v in times.items()}, "ms_min_max": {k: v[1:] for k, v in times.items()},
        "bound_ms": 1e3 * least, "bound_by": by,
        "roofline_pct": {k: 1e5 * least / times[k][0] for k in ("counted", "list", "mask")},
        "warp_trips": trips,
        "bytes_read_per_call": {"list": 2 * n_targets + 2 * 4 * n_targets * math.ceil(trips["list_entries_mean"] / 4),
                                "mask": 4 * 27 * n_targets},
        "list_bytes": plist.words.numel() * 2, "mask_bytes": mask.numel() * 4,
    }
    print(json.dumps(line), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
