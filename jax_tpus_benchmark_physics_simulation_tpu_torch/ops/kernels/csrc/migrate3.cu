// Cell-grid rebuild permutation (3D) and its mover flag, for NVIDIA Hopper
// (sm_90a).
//
// Replaces two TPU kernels of jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/migrate_pallas3.py (both built by make_migrate_kernel3):
//   B6 _migrate_kernel3_compact (the default), and
//   B7 _migrate_kernel3 (compact=False, B6's parity oracle).
// Both compute one permutation, and on this card both are this one kernel,
// B7 with the mover flag off. B6 halo replaces its explicit-halo form (the
// `.raw` call at migrate_pallas3.py:471 that parallel/grid_md3_sharded.py
// runs on each device's x-rows).
//
// Layout: every grid is (ncx, cap, ncy * ncz), row-major: slot (cx, b, cy,
// cz) at (cx * cap + b) * P + cy * ncz + cz, P = ncy * ncz. Every occupied
// source slot carries a source-frame code scode = dcode * cap + a, where
// dcode = ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1) in 0..26 is its migration
// direction and a its allocated slot in the target cell (cx + dx, cy + dy,
// cz + dz), each index mod its axis length; scode = -1 marks an empty or
// invalid slot. Each target slot takes all F fields of the one source whose
// code names it, and every other slot takes fills[f]. The F field planes
// are read where they lie, each through its own pointer; the output is one
// (F, ncx, cap, P) allocation.
//
// Design: one launch a rebuild does the fill, the scatter and the flag.
// A block takes 32 consecutive (cy, cz) cells of one source x-row, all cap
// slots of them, a thread per cell and slot row (strided by the block's 8
// slot rows). For each of its source slots a thread moves the F fields to
// the target the code names; for the output slot of the same index it
// writes fills[f] where the allocation left that slot empty (occ < 0.5).
// The allocation fills a target cell's slots 0 .. tot - 1 with exactly the
// sources that name it (grid_md3._migration_dest3), so the two kinds of
// write meet disjoint slots that cover the grid: every output element is
// written once, and the output is bit-identical to the plain PyTorch
// version (values are only moved). The mover flag -- some source cell has
// more than k_mov valid slots moving (dcode != 13) -- is the same block's
// count per cell in shared memory, ORed over the blocks into a word of the
// caller's scratch; the last block to finish (a second word, a counter that
// atomicInc wraps back to 0) writes the flag and clears the first, so the
// wrapper returns it as a device tensor with no host read and no second
// launch. Every launch leaves the scratch as it found it (both words 0), so
// launches in turn on one stream share one scratch; the wrapper keeps one a
// stream, so launches that may overlap never do.
//
// Why B6 and B7 are one kernel here: the TPU realised the permutation as
// dense compare/selects over 27 directions x candidate rows, because its
// gathers and scatters are descriptor-bound. B6 packed each cell's movers
// into k_mov shared rows to cut that candidate scan, at the price of a cell
// limit (k_mov) and its loud flag; B7 scanned everything. A direct scatter
// has no candidate scan to cut, so the compaction buys nothing on a GPU. The
// port keeps k_mov and computes the flag from the codes exactly as the JAX
// wrapper does (migrate_cuda3.mover_overflow), so both packages flag the
// same states, but it never drops a particle.
//
// B6 halo: the source rows are one rank's ncx x-rows with the previous
// rank's last x-row before them and the next rank's first x-row after them
// (ncx + 2 rows, as the exchange attaches them); out holds the local rows
// only. A source in extended row r moving by dx lands in local row
// r + dx - 1, and a write outside [0, ncx) is dropped: the rank that owns
// that row scatters the same source from its own halo copy. x does not wrap
// here; y and z do. The flag counts the local rows' sources only. The TPU
// compacted each row's movers to k_mov planes before the exchange
// (grid_md3_sharded.py:86-91); here the halo rows travel whole: at N=86k
// (18 x 32 x 324) a row of all 16 fields is 0.66 MB a side, a rebuild's
// worth of NVLink time in microseconds, and no particle can be dropped.
//
// What bounds it on an H100: at N=100k with Kahan fields, F = 16 planes of
// 219,488 slots: the code grid and the occupancy (1.8 MB) read, the fields
// of the 100k occupied slots (6.4 MB) read, 14 MB written, about 7 us of
// HBM time at 3.35 TB/s. Reads are coalesced along (cy, cz); writes are
// coalesced wherever neighbouring slots move the same way, which most (the
// stayers) do, and the fills always are. Each thread loads all F fields of
// a slot before it stores any, so the loads are in flight together.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kLanes = 32;     // (cy, cz) cells a block
constexpr int kSlotRows = 8;   // slot rows a block takes at once
constexpr int kStay = 13;      // dcode of (dx, dy, dz) == (0, 0, 0)

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

// grid (ceil(P / 32), source rows), block (32, kSlotRows). HALO: source row
// r of ncx + 2 is local row r - 1 (r = 1 .. ncx) or a halo row; without it,
// the ncx source rows are the local rows. sync[0] gathers the blocks' flags,
// sync[1] counts the finished blocks; both are 0 before and after a launch.
template <bool HALO>
__global__ void __launch_bounds__(kLanes * kSlotRows)
    migrate3_kernel(const int* __restrict__ scode, Planes src, const float* __restrict__ occ,
                    float* __restrict__ out, unsigned char* __restrict__ flag,
                    unsigned int* __restrict__ sync, Fills fills, int n_fields, int ncx, int cap,
                    int ncy, int ncz, int k_mov) {
  __shared__ int movers[kLanes];
  const int plane = ncy * ncz;
  const long long n_out = static_cast<long long>(ncx) * cap * plane;
  const int r = blockIdx.y;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool in = lane < plane;
  const bool local = !HALO || (r >= 1 && r <= ncx);
  const int lr = HALO ? r - 1 : r;  // local (output) row of this source row
  if (threadIdx.y == 0) movers[threadIdx.x] = 0;
  __syncthreads();

  int my_movers = 0;
  if (in) {
    const int cy = lane / ncz, cz = lane - (lane / ncz) * ncz;
    for (int a = threadIdx.y; a < cap; a += kSlotRows) {
      const long long s = static_cast<long long>(r * cap + a) * plane + lane;
      const int code = scode[s];
      const int dcode = code >= 0 ? code / cap : -1;
      if (local && dcode >= 0 && dcode != kStay) ++my_movers;
      if (dcode >= 0 && dcode < 27) {
        const int ta = code - dcode * cap;
        int tx = lr + dcode / 9 - 1;
        const bool keep = !HALO || (tx >= 0 && tx < ncx);
        if (!HALO) tx = wrap(tx, ncx);
        if (keep) {
          const int ty = wrap(cy + (dcode / 3) % 3 - 1, ncy);
          const int tz = wrap(cz + dcode % 3 - 1, ncz);
          const long long t = static_cast<long long>(tx * cap + ta) * plane + ty * ncz + tz;
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
        const long long o = static_cast<long long>(lr * cap + a) * plane + lane;
        if (!(__ldg(occ + o) > 0.5f)) {
#pragma unroll
          for (int k = 0; k < kMaxFields; ++k) {
            if (k < n_fields) out[k * n_out + o] = fills.v[k];
          }
        }
      }
    }
  }
  if (my_movers) atomicAdd(&movers[threadIdx.x], my_movers);
  __syncthreads();
  const bool over = threadIdx.y == 0 && in && local && movers[threadIdx.x] > k_mov;
  const int block_over = __syncthreads_or(over);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    if (block_over) atomicOr(&sync[0], 1u);
    __threadfence();
    const unsigned int n_blocks = gridDim.x * gridDim.y;
    if (atomicInc(&sync[1], n_blocks - 1) == n_blocks - 1) {
      // the last block: every other block's OR came before its count
      *flag = atomicExch(&sync[0], 0u) != 0u ? 1 : 0;
    }
  }
}

}  // namespace

// B6 (k_mov >= 1) and B7 (k_mov < 1: no flag, *flag = 0), or with halo != 0
// B6 halo. code and fields[0 .. n_fields - 1] (a host array of device
// pointers) are the source rows' (ncx + 2 * halo, cap, ncy * ncz) int32 code
// grid and float32 field planes. occ is the allocation's (ncx, cap,
// ncy * ncz) float32 occupancy of the output, out the (n_fields, ncx, cap,
// ncy * ncz) float32 output, flag one device byte, sync two device words,
// both 0, which the launch leaves 0 (launches that may overlap need their
// own); fills points to n_fields host floats. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int jtps_migrate3(const int* code, const void* const* fields, const float* occ,
                             float* out, unsigned char* flag, unsigned int* sync,
                             const float* fills, int n_fields, int ncx, int cap, int ncy, int ncz,
                             int k_mov, int halo, int device, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || ncx < 1 || ncx + 2 > 65535 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fills f{};
  Planes src{};
  for (int k = 0; k < n_fields; ++k) {
    f.v[k] = fills[k];
    src.f[k] = static_cast<const float*>(fields[k]);
  }
  const int threshold = k_mov >= 1 ? k_mov : INT_MAX;
  const dim3 block(kLanes, kSlotRows);
  const int lane_blocks = (ncy * ncz + kLanes - 1) / kLanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halo) {
    migrate3_kernel<true><<<dim3(lane_blocks, ncx + 2), block, 0, st>>>(
        code, src, occ, out, flag, sync, f, n_fields, ncx, cap, ncy, ncz, threshold);
  } else {
    migrate3_kernel<false><<<dim3(lane_blocks, ncx), block, 0, st>>>(
        code, src, occ, out, flag, sync, f, n_fields, ncx, cap, ncy, ncz, threshold);
  }
  return static_cast<int>(cudaGetLastError());
}
