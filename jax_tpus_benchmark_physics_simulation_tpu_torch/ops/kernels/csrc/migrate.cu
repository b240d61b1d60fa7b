// Cell-grid rebuild permutation (2D), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/migrate_pallas.py:_migrate_kernel (built by
// make_migrate_kernel), and as B2 halo its explicit-halo form (the `.raw`
// call at migrate_pallas.py:226, R = 1) that parallel/grid_md_sharded.py
// runs on each device's rows.
//
// The grid is (G, cap, R * cps) with G = cps / R blocks of R cell rows
// (R = 1 is the unpacked (cps, cap, cps) layout; see cell_force.cu): slot
// (g, b, lane) is slot b of cell (cx, cy) = (g * R + lane / cps, lane % cps).
// Every occupied source slot carries a source-frame code
// scode = dcode * cap + a, where dcode = (dx + 1) * 3 + (dy + 1) is its
// migration direction and a its allocated slot in the target cell
// (tx, ty) = ((cx + dx) mod cps, (cy + dy) mod cps), which sits at
// ((tx / R) * cap + a) * R * cps + (tx % R) * cps + ty; scode = -1 marks an
// empty or invalid slot. Each target slot takes all F fields of the one
// source whose code names it, and every other slot takes fills[f]. The TPU
// kernel's lane rolls and block-crossing row patches (_row_source) are this
// index map: a block row's cell row tx % R and the block row tx / R of the
// target come from its cell row, so a mover across a block seam needs no
// case of its own. The F field planes are read where they lie, each through
// its own pointer; the output is one (F, G, cap, R * cps) allocation.
//
// Design: one launch a rebuild does the fill and the scatter (csrc/
// migrate3.cu's design in 2D). A block takes 32 consecutive lanes of one
// source block row, all cap slots of them, a thread per lane and slot row
// (strided by the block's 16 slot rows: one slot a thread at the engines'
// capacity of 16); a thread finds its lane's cell once. For each of its
// source slots it loads the F fields before it stores any,
// then writes them to the target the code names; for the output slot of the
// same index it writes fills[f] where the allocation left that slot empty
// (occ < 0.5). The allocation fills a target cell's slots 0 .. tot - 1 with
// exactly the sources that name it (grid_md._migration_dest, overflow
// included), so the two kinds of write meet disjoint slots that cover the
// grid: every output element is written once, and the output is
// bit-identical to the plain PyTorch version (values are only moved).
// Blocks of 512 threads with at most 64 registers a thread (two blocks an
// SM or more): on the H100 this shape beat migrate3.cu's (256 threads, 128
// registers) at every main-path shape (tests/torch_migrate_designs.py).
//
// B2 halo (R = 1): the source rows are one rank's n_rows cell rows with the
// previous rank's last row before them and the next rank's first row after
// them, (n_rows + 2, cap, cps); out and occ hold the local rows only. A
// source in extended row r moving by dx lands in local row r + dx - 1; a
// write outside [0, n_rows) is dropped, because the rank that owns that row
// scatters the same source from its own halo copy. Rows do not wrap here
// (the halo rows stand in for the periodic neighbours); columns do. Only
// the local rows fill.
//
// What bounds it on an H100: at N=100k with Kahan fields, F = 11 planes of
// 234,256 slots: the code grid and the occupancy read (1.9 MB), the fields
// of the 100k occupied slots read (4.4 MB), 10.3 MB written, about 5 us of
// HBM time at 3.35 TB/s (ten times that at N=1M, 2.37M slots). The TPU needed
// a dense compare/select over 9 * cap candidates per slot because its
// gathers and scatters are descriptor-bound; a GPU scatters at memory speed,
// so the direct scatter replaces that O(9 * cap) work with O(1) per slot.
// Reads are coalesced along the lanes; writes are coalesced wherever
// neighbouring slots move the same way, which most (the stayers) do, and
// the fills always are.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kLanes = 32;    // lanes a block
constexpr int kSlotRows = 16;  // slot rows a block takes at once

struct Fills {
  float v[kMaxFields];
};

// the F field planes of the source rows
struct Planes {
  const float* f[kMaxFields];
};

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// grid (ceil(R * cps / 32), source block rows), block (32, kSlotRows).
// Without HALO the n_rows = cps / R source block rows are the output's;
// with it (R = 1) source row g of n_rows + 2 is local row g - 1 or a halo
// row.
template <bool HALO>
__global__ void __launch_bounds__(kLanes * kSlotRows, 2)
    migrate_kernel(const int* __restrict__ scode, Planes src, const float* __restrict__ occ,
                   float* __restrict__ out, Fills fills, int n_fields, int n_rows, int cap, int cps,
                   int rows_per_block) {
  const int R = rows_per_block;
  const int lanes = R * cps;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= lanes) return;
  const long long n_out = static_cast<long long>(n_rows) * cap * lanes;
  const int g = blockIdx.y;
  const bool local = !HALO || (g >= 1 && g <= n_rows);
  const int lg = HALO ? g - 1 : g;  // the output block row of this source row
  const int sub = lane / cps;       // the lane's cell row in its block
  const int cy = lane - sub * cps;
  const int cx = lg * R + sub;      // HALO: the local row, -1 or n_rows for a halo row

  for (int a = threadIdx.y; a < cap; a += kSlotRows) {
    const long long s = static_cast<long long>(g * cap + a) * lanes + lane;
    const int code = scode[s];
    if (code >= 0 && code < 9 * cap) {
      const int dcode = code / cap;
      const int ta = code - dcode * cap;
      int tx = cx + dcode / 3 - 1;
      const bool keep = !HALO || (tx >= 0 && tx < n_rows);
      if (!HALO) tx = wrap(tx, cps);
      if (keep) {
        const int ty = wrap(cy + dcode % 3 - 1, cps);
        const int tg = tx / R;
        const long long t = static_cast<long long>(tg * cap + ta) * lanes + (tx - tg * R) * cps + ty;
        float v[kMaxFields];
#pragma unroll
        for (int k = 0; k < kMaxFields; ++k) {
          if (k < n_fields) v[k] = __ldg(src.f[k] + s);
        }
#pragma unroll
        for (int k = 0; k < kMaxFields; ++k) {
          if (k < n_fields) out[k * n_out + t] = v[k];
        }
      }
    }
    if (local) {
      const long long o = static_cast<long long>(lg * cap + a) * lanes + lane;
      if (!(__ldg(occ + o) > 0.5f)) {
#pragma unroll
        for (int k = 0; k < kMaxFields; ++k) {
          if (k < n_fields) out[k * n_out + o] = fills.v[k];
        }
      }
    }
  }
}

cudaError_t launch(const int* scode, const void* const* fields, const float* occ, float* out,
                   const float* fills, int n_fields, int n_rows, int cap, int cps, int rows_per_block,
                   bool halo, int device, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n_rows < 1 || cap < 1 || rows_per_block < 1 ||
      n_rows + 2 > 65535 || (halo && rows_per_block != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Fills f{};
  Planes src{};
  for (int k = 0; k < n_fields; ++k) {
    f.v[k] = fills[k];
    src.f[k] = static_cast<const float*>(fields[k]);
  }
  const dim3 block(kLanes, kSlotRows);
  const int lane_blocks = (rows_per_block * cps + kLanes - 1) / kLanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halo) {
    migrate_kernel<true><<<dim3(lane_blocks, n_rows + 2), block, 0, st>>>(
        scode, src, occ, out, f, n_fields, n_rows, cap, cps, 1);
  } else {
    migrate_kernel<false><<<dim3(lane_blocks, n_rows), block, 0, st>>>(
        scode, src, occ, out, f, n_fields, n_rows, cap, cps, rows_per_block);
  }
  return cudaGetLastError();
}

}  // namespace

// B2 (R = rows_per_block >= 1, cps % R == 0): scode and fields[0 ..
// n_fields - 1] (a host array of device pointers) are the (cps / R, cap,
// R * cps) int32 code grid and float32 field planes; occ is the
// allocation's float32 occupancy of the output, of the same shape; out the
// (n_fields, cps / R, cap, R * cps) float32 output; fills points to n_fields
// host floats. Launches on `stream` and returns cudaGetLastError().
extern "C" int jtps_migrate(const int* scode, const void* const* fields, const float* occ, float* out,
                            const float* fills, int n_fields, int cps, int cap, int rows_per_block,
                            int device, void* stream) {
  if (rows_per_block < 1 || cps % rows_per_block != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(scode, fields, occ, out, fills, n_fields, cps / rows_per_block, cap, cps,
                                 rows_per_block, false, device, stream));
}

// B2 halo: scode and fields[k] are (n_rows + 2, cap, cps), each with its
// halo rows attached; occ is the local rows' (n_rows, cap, cps) occupancy
// and out (n_fields, n_rows, cap, cps). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int jtps_migrate_halo(const int* scode, const void* const* fields, const float* occ, float* out,
                                 const float* fills, int n_fields, int n_rows, int cps, int cap, int device,
                                 void* stream) {
  return static_cast<int>(
      launch(scode, fields, occ, out, fills, n_fields, n_rows, cap, cps, 1, true, device, stream));
}
