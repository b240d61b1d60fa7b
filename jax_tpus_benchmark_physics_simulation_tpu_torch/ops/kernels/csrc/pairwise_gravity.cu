// All-pairs Plummer-softened gravitational accelerations (and per-particle
// potentials), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/pairwise_pallas.py:196 _gravity_kernel (built by
// make_gravity_accel_pallas).
//
// Computes, for every particle i of the (N, D) float32 positions (D = 2 or
// 3) with (N,) float32 masses, the sum over every other particle j of
//   dx    = x_j - x_i
//   r2    = softening^2 + dx_0^2 + dx_1^2 (+ dx_2^2), each square an FMA
//   inv_r = rsqrt(r2), inv_r3 = inv_r * inv_r * inv_r
//   a_i  += (g m_j) inv_r3 * dx                 (an FMA a component)
//   phi_i -= (g m_j) inv_r                      (WITH_POTENTIAL only; an FMA)
// Total potential energy = 0.5 * sum_i m_i phi_i (the caller takes it).
//
// What bounds it on an H100: N^2 (5d + 4) operations, N^2 (5d + 6) with the
// potential (chip_smoke._gravity_bounds: 4.3 GFLOP at N=16,384 in 2D with
// phi, 64 us at the card's 67 TFLOP/s float32 peak, which counts an FMA as
// two operations; 90 GFLOP at N=65,536 in 3D, 1.35 ms). Its bytes
// (positions and masses in, accelerations out) are a few MB at most. Two
// more limits lie near that bound. The rsqrt runs on the special-function
// unit, 16 results a clock an SM against an FMA's 128 (the CUDA programming
// guide's throughput table for compute capability 9.0): one a pair is
// N^2 / (16 x 132 SMs x 1.98 GHz), 0.064 ms at N=16,384 and 1.03 ms at
// N=65,536. And every other instruction of a pair issues on the 128-lane
// float32 pipe: 10 in 2D with phi (2 differences, 2 FMAs for r2, 3
// products, 3 FMAs), 13 in 3D, which is about 0.08 ms at N=16,384 2D and
// 1.7 ms at N=65,536 3D.
//
// Design: B8's tiled all-pairs loop (csrc/pairwise_lj.cu; "N-Body
// Simulations on GPUs", 0706.3060), built for those limits.
// - kRows = 4 i-particles a thread in blocks of kThreads = 128 (512 i a
//   block): one broadcast load of a staged j from shared memory feeds four
//   independent pair chains. A j-tile holds kTile = 512 records of one
//   float4 each, (x, y, g m_j, 0) in 2D or (x, y, z, g m_j) in 3D, with
//   g m_j formed once per j.
// - Explicit FMAs (__fmaf_rn) in r2 and in the accumulations. The library
//   is built with --fmad=false (_build.py), so every FMA is one that this
//   source writes and the other kernels keep their separate roundings.
// - rsqrt.approx.ftz.f32: rsqrtf's instruction, the TPU kernel's lax.rsqrt,
//   without the rescaling of a denormal input that rsqrtf adds around it
//   (three instructions a pair). Only an r2 below 2^-126 would take it:
//   |dx| below 1e-19 with no softening, where the plain version's
//   acceleration is not finite either.
// - The j == i select runs only on the tiles that hold some of the block's
//   own particles (a uniform branch); with softening 0 the diagonal would
//   otherwise give a NaN, and with softening > 0 a false phi term.
// - The pair loop unrolled 8 times, and at most 80 registers a thread (six
//   blocks an SM): on the H100 this beat B8's unroll 4 at 64 registers
//   (eight blocks an SM) at both shapes and in both variants, though the 2D
//   variants spill a few registers either way (tests/torch_gravity_designs.py).
// j is split into S slices of whole tiles along the grid's y axis (at most
// 32, chosen by the wrapper with B8's geometry: at N=16,384, 32 x 32 = 1024
// blocks, 1.3 rounds of six an SM); each block writes its partial sums to an
// (S, N, D+1) scratch buffer, and a second launch sums the S partials of
// each particle in slice order. No float atomics: two launches on one input
// are bit-equal. The last tile is cut to the particles that exist: no
// padding of N or of the coordinate axis. pairwise_cuda.py mirrors these
// constants (_geometry).
//
// Arithmetic against the plain version gravity_accel_pairwise_reference:
// the fused roundings and the summation order differ (the rsqrt is the
// same), so the kernel agrees with it to a tolerance (1e-5 of the largest
// |a| or |phi|), not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                 // threads of a block
constexpr int kRows = 4;                      // i-particles a thread
constexpr int kBlockRows = kThreads * kRows;  // i-particles a block
constexpr int kTile = 512;                    // j of a shared tile
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// coordinate d of a staged record
__device__ __forceinline__ float coord(const float4& v, int d) {
  return d == 0 ? v.x : (d == 1 ? v.y : v.z);
}

// g m_j of a staged record
template <int DIM>
__device__ __forceinline__ float gm_of(const float4& v) {
  return DIM == 2 ? v.z : v.w;
}

// One pair (i, j) added to i's sums. SELF: the tile may hold i itself, so
// j == i (not_self false) is masked.
template <int DIM, bool WITH_POTENTIAL, bool SELF>
__device__ __forceinline__ void add_pair(const float (&xi)[DIM], const float4& xj, bool not_self,
                                         float soft2, float (&acc)[DIM], float& acc_phi) {
  float dx[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) dx[d] = __fsub_rn(coord(xj, d), xi[d]);
  float r2 = soft2;
#pragma unroll
  for (int d = 0; d < DIM; ++d) r2 = __fmaf_rn(dx[d], dx[d], r2);
  const float inv_r = rsqrt_approx(SELF ? (not_self ? r2 : 1.0f) : r2);
  const float inv_r3 = __fmul_rn(__fmul_rn(inv_r, inv_r), inv_r);
  const float gm = gm_of<DIM>(xj);
  float amag = __fmul_rn(gm, inv_r3);
  if (SELF) amag = not_self ? amag : 0.0f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] = __fmaf_rn(amag, dx[d], acc[d]);
  if (WITH_POTENTIAL) {
    // phi - (g m_j) inv_r, one FMA; the diagonal adds (-0) * 1 = -0, which
    // leaves any sum as it is
    acc_phi = __fmaf_rn(SELF ? (not_self ? -gm : -0.0f) : -gm, inv_r, acc_phi);
  }
}

template <int DIM, bool WITH_POTENTIAL, bool SELF>
__device__ __forceinline__ void tile_pairs(const float4* tile, int len, int j0, const int (&ii)[kRows],
                                           const float (&xi)[kRows][DIM], float soft2,
                                           float (&acc)[kRows][DIM], float (&acc_phi)[kRows]) {
#pragma unroll 8
  for (int jj = 0; jj < len; ++jj) {
    const float4 xj = tile[jj];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      add_pair<DIM, WITH_POTENTIAL, SELF>(xi[k], xj, j0 + jj != ii[k], soft2, acc[k], acc_phi[k]);
    }
  }
}

template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kThreads, 6)
    pairwise_gravity_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                            float* __restrict__ partial, int n, int slice_len, float g, float soft2) {
  constexpr int W = DIM + 1;  // a partial record: D acceleration sums, phi
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kBlockRows;
  const int j_begin = blockIdx.y * slice_len;
  const int j_end = min(j_begin + slice_len, n);
  int ii[kRows];
  float xi[kRows][DIM];
  float acc[kRows][DIM];
  float acc_phi[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    ii[k] = i0 + k * kThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      xi[k][d] = ii[k] < n ? pos[ii[k] * DIM + d] : 0.0f;
      acc[k][d] = 0.0f;
    }
    acc_phi[k] = 0.0f;
  }

  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int len = min(kTile, j_end - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < len; k += kThreads) {
      const float* p = pos + (j0 + k) * DIM;
      const float gm = g * mass[j0 + k];
      tile[k] = DIM == 2 ? make_float4(p[0], p[1], gm, 0.0f) : make_float4(p[0], p[1], p[DIM - 1], gm);
    }
    __syncthreads();
    if (j0 < i0 + kBlockRows && i0 < j0 + len) {
      tile_pairs<DIM, WITH_POTENTIAL, true>(tile, len, j0, ii, xi, soft2, acc, acc_phi);
    } else {
      tile_pairs<DIM, WITH_POTENTIAL, false>(tile, len, j0, ii, xi, soft2, acc, acc_phi);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (ii[k] < n) {
      float* out = partial + (static_cast<size_t>(blockIdx.y) * n + ii[k]) * W;
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[d] = acc[k][d];
      out[DIM] = acc_phi[k];
    }
  }
}

// Sums the S partial records of each particle in slice order.
template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kReduceThreads)
    gravity_reduce_kernel(const float* __restrict__ partial, float* __restrict__ accel,
                          float* __restrict__ phi, int n, int slices) {
  constexpr int W = DIM + 1;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  for (int s = 0; s < slices; ++s) {
    const float* rec = partial + (static_cast<size_t>(s) * n + i) * W;
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] += rec[c];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) accel[i * DIM + d] = acc[d];
  if (WITH_POTENTIAL) phi[i] = acc[DIM];
}

template <int DIM, bool WITH_POTENTIAL>
cudaError_t launch(const float* pos, const float* mass, float* partial, float* accel, float* phi, int n,
                   int slices, int slice_len, float g, float soft2, cudaStream_t stream) {
  const int row_blocks = (n + kBlockRows - 1) / kBlockRows;
  pairwise_gravity_kernel<DIM, WITH_POTENTIAL>
      <<<dim3(row_blocks, slices), kThreads, 0, stream>>>(pos, mass, partial, n, slice_len, g, soft2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gravity_reduce_kernel<DIM, WITH_POTENTIAL>
      <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(partial, accel, phi, n,
                                                                                  slices);
  return cudaGetLastError();
}

}  // namespace

// Launches the pair kernel and the slice reduction on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError().
// partial is (slices, n, dim + 1) float32 scratch; slice_len must be a
// multiple of the 512-particle tile and slices * slice_len must cover n.
// phi is ignored unless with_potential != 0. dim must be 2 or 3.
extern "C" int jtps_pairwise_gravity(const float* pos, const float* mass, float* partial, float* accel,
                                     float* phi, int n, int dim, int slices, int slice_len, float g,
                                     float soft2, int with_potential, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dim != 2 && dim != 3) || n < 1 || slices < 1 || slice_len < kTile || slice_len % kTile != 0 ||
      static_cast<long long>(slices) * slice_len < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    err = with_potential ? launch<2, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
                         : launch<2, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  } else {
    err = with_potential ? launch<3, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
                         : launch<3, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  }
  return static_cast<int>(err);
}
