// Cell-grid rebuild permutation (3D), for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/migrate_pallas3.py (both built by make_migrate_kernel3):
//   B6 _migrate_kernel3_compact (the default), and
//   B7 _migrate_kernel3 (compact=False, B6's parity oracle).
// Both compute one permutation, and on this card both are this one scatter.
//
// Layout: every grid is (ncx, cap, ncy * ncz), row-major: slot (cx, b, cy,
// cz) at (cx * cap + b) * P + cy * ncz + cz, P = ncy * ncz. Every occupied
// source slot carries a source-frame code scode = dcode * cap + a, where
// dcode = ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1) in 0..26 is its migration
// direction and a its allocated slot in the target cell (cx + dx, cy + dy,
// cz + dz), each index mod its axis length; scode = -1 marks an empty or
// invalid slot. Each target slot takes all F fields of the one source whose
// code names it, and unmatched targets take fills[f].
//
// Design: a fill launch writes fills[f] into every output slot, then a
// scatter launch with one thread per source slot writes that slot's F
// fields to its target. The allocation is injective (grid_md3's
// _migration_dest3 gives each target slot at most one source), so no two
// threads write the same element and the output is bit-identical to the
// plain PyTorch version: values are only moved.
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
// What bounds it on an H100: at N=100k with Kahan fields, F = 16 planes of
// 219,488 slots: 14 MB read, 14 MB filled and 6.4 MB scattered (100k
// particles), about 10 us of HBM time at 3.35 TB/s. Reads are coalesced
// along (cy, cz); writes are coalesced wherever neighbouring slots move the
// same way, which most (the stayers) do. The fill runs on a (slot blocks,
// fields) grid, so no thread divides to find its field.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;

struct Fills {
  float v[kMaxFields];
};

// grid (slot blocks, n_fields): no division per element
__global__ void migrate3_fill_kernel(float* __restrict__ out, Fills fills,
                                     int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  out[static_cast<long long>(blockIdx.y) * n_slots + i] = fills.v[blockIdx.y];
}

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

__global__ void migrate3_scatter_kernel(const int* __restrict__ scode,
                                        const float* __restrict__ fields,
                                        float* __restrict__ out, int n_fields,
                                        int ncx, int cap, int ncy, int ncz) {
  const int plane = ncy * ncz;
  const int row = cap * plane;
  const int n_slots = ncx * row;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int code = scode[s];
  if (code < 0 || code >= 27 * cap) return;
  const int dcode = code / cap;
  const int a = code % cap;
  const int lane = s % plane;
  const int tx = wrap(s / row + dcode / 9 - 1, ncx);
  const int ty = wrap(lane / ncz + (dcode / 3) % 3 - 1, ncy);
  const int tz = wrap(lane % ncz + dcode % 3 - 1, ncz);
  const int t = (tx * cap + a) * plane + ty * ncz + tz;
  for (int f = 0; f < n_fields; ++f) {
    out[f * n_slots + t] = fields[f * n_slots + s];
  }
}

}  // namespace

// fields and out are (n_fields, ncx, cap, ncy * ncz) float32; scode is
// (ncx, cap, ncy * ncz) int32; fills points to n_fields host floats.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int jtps_migrate3(const int* scode, const float* fields, float* out,
                             const float* fills, int n_fields, int ncx, int cap,
                             int ncy, int ncz, int device, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fills f{};
  for (int k = 0; k < n_fields; ++k) f.v[k] = fills[k];
  const int n_slots = ncx * cap * ncy * ncz;
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_slots + threads - 1) / threads;
  migrate3_fill_kernel<<<dim3(blocks, n_fields), threads, 0, st>>>(out, f, n_slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  migrate3_scatter_kernel<<<blocks, threads, 0, st>>>(scode, fields, out, n_fields,
                                                       ncx, cap, ncy, ncz);
  return static_cast<int>(cudaGetLastError());
}
