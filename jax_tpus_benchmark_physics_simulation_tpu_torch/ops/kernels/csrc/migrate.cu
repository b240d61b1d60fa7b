// Cell-grid rebuild permutation (2D), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/migrate_pallas.py:_migrate_kernel (built by
// make_migrate_kernel).
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
// source whose code names it, and unmatched targets take fills[f]. The TPU
// kernel's lane rolls and block-crossing row patches (_row_source) are this
// index map.
//
// Design: a fill launch writes fills[f] into every output slot, then a
// scatter launch with one thread per source slot writes that slot's F
// fields to its target. The allocation is injective (grid_md._migration_dest
// gives each target slot at most one source), so no two threads write the
// same element and the output is bit-identical to the plain PyTorch
// version: values are only moved.
//
// What bounds it on an H100: at N=100k with Kahan fields, F = 11 planes of
// 234k slots, 10.3 MB read and 20.6 MB written (fill plus scatter), a few
// microseconds of HBM time (ten times that at N=1M, 2.37M slots). The TPU needed a dense compare/select over 9 *
// cap candidates per slot because its gathers and scatters are
// descriptor-bound; a GPU scatters at memory speed, so the direct scatter
// replaces that O(9 * cap) work with O(1) per slot. Reads are coalesced
// along cy; writes are coalesced wherever neighbouring slots move the same
// way, which most do.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;

struct Fills {
  float v[kMaxFields];
};

__global__ void migrate_fill_kernel(float* __restrict__ out, Fills fills,
                                    int n_fields, int n_slots) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_fields) * n_slots) return;
  out[i] = fills.v[i / n_slots];
}

__global__ void migrate_scatter_kernel(const int* __restrict__ scode,
                                       const float* __restrict__ fields,
                                       float* __restrict__ out, int n_fields,
                                       int cps, int cap, int rows_per_block) {
  const int R = rows_per_block;
  const int lanes = R * cps;
  const int row = cap * lanes;  // one block of R cell rows
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
  for (int f = 0; f < n_fields; ++f) {
    out[f * n_slots + t] = fields[f * n_slots + s];
  }
}

}  // namespace

// fields and out are (n_fields, G, cap, R * cps) float32; scode is
// (G, cap, R * cps) int32; fills points to n_fields host floats. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int jtps_migrate(const int* scode, const float* fields, float* out,
                            const float* fills, int n_fields, int cps, int cap,
                            int rows_per_block, int device, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || rows_per_block < 1 ||
      cps % rows_per_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fills f{};
  for (int k = 0; k < n_fields; ++k) f.v[k] = fills[k];
  const int n_slots = cps * cap * cps;
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(n_fields) * n_slots;
  const int fill_blocks = static_cast<int>((total + threads - 1) / threads);
  migrate_fill_kernel<<<fill_blocks, threads, 0, st>>>(out, f, n_fields, n_slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_slots + threads - 1) / threads;
  migrate_scatter_kernel<<<blocks, threads, 0, st>>>(
      scode, fields, out, n_fields, cps, cap, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
