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
//   r2    = dx_0^2 + dx_1^2 (+ dx_2^2), left to right, then + softening^2
//   inv_r = rsqrt(r2), inv_r3 = inv_r * inv_r * inv_r
//   a_i  += (g m_j) inv_r3 * dx
//   phi_i -= (g m_j) inv_r                      (WITH_POTENTIAL only)
// Total potential energy = 0.5 * sum_i m_i phi_i (the caller takes it).
//
// Design: B8's tiled all-pairs loop ("N-Body Simulations on GPUs",
// 0706.3060), not the Pallas grid. Each thread owns one i-particle and
// walks j-tiles of kThreads records (x, y[, z], g m) staged in shared memory
// (every thread of the block reads the same record at once: a broadcast).
// j is split into S slices along the grid's y axis so that N=16,384 gives
// 64 x 16 = 1024 blocks for 132 SMs; each block writes its partial sums to
// an (S, N, D+1) scratch buffer, and a second launch sums the S partials
// of each particle in slice order. No float atomics: two launches on one
// input are bit-equal. The TPU's coordinate padding to 8, its rounding of N
// up to a block and its masked tiles are gone: the last tile is cut to the
// particles that exist, and j == i is skipped by a select.
//
// Arithmetic: rsqrtf, as the TPU kernel uses lax.rsqrt (its 2-ulp error
// stands in the tolerance against the plain version); no FMA contraction
// (--fmad=false, _build.py), so each other operation rounds as the plain
// PyTorch version gravity_accel_pairwise_reference does.
//
// What bounds it on an H100: N^2 (5d + 4) operations, N^2 (5d + 6) with the
// potential: d differences, d squares and d sums with the softening, the
// rsqrt, two products for inv_r^3, the magnitude (g m_j is formed once per
// staged j), d products and d sums, and for phi one product and one sum
// (4.3 GFLOP at N=16,384 in 2D with phi, 64 us at the card's 67 TFLOP/s
// float32 peak; 90 GFLOP at N=65,536 in 3D, 1.35 ms). The j == i selects
// are not counted. Its bytes (positions and masses in, accelerations out)
// are a few MB at most. The rsqrt runs on the special-function unit at a
// quarter of the FMA rate, and with --fmad=false every multiply and add
// issues alone, which caps this kernel below that bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // i-particles of a block, and j-tile length

template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kThreads)
    pairwise_gravity_kernel(const float* __restrict__ pos,
                            const float* __restrict__ mass,
                            float* __restrict__ partial, int n, int slice_len,
                            float g, float soft2) {
  constexpr int W = DIM + 1;  // a staged j (D coordinates, g m_j) and a
                              // partial record (D acceleration sums, phi)
  __shared__ float tile[kThreads * W];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int j_begin = blockIdx.y * slice_len;
  const int j_end = min(j_begin + slice_len, n);
  float xi[DIM];
  float acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    xi[d] = i < n ? pos[i * DIM + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float acc_phi = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int len = min(kThreads, j_end - j0);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < len) {
      const int j = j0 + threadIdx.x;
#pragma unroll
      for (int d = 0; d < DIM; ++d) tile[threadIdx.x * W + d] = pos[j * DIM + d];
      tile[threadIdx.x * W + DIM] = g * mass[j];
    }
    __syncthreads();
    for (int jj = 0; jj < len; ++jj) {
      const float* rec = tile + jj * W;
      float dx[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dx[d] = rec[d] - xi[d];
      float r2 = dx[0] * dx[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) r2 = r2 + dx[d] * dx[d];
      r2 = r2 + soft2;
      const bool valid = (j0 + jj) != i;
      const float inv_r = rsqrtf(valid ? r2 : 1.0f);
      const float inv_r3 = inv_r * inv_r * inv_r;
      const float amag = valid ? rec[DIM] * inv_r3 : 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc[d] += amag * dx[d];
      // a - b is a + (-b): the plain version's (-g m_j) inv_r, summed
      if (WITH_POTENTIAL) acc_phi -= valid ? rec[DIM] * inv_r : 0.0f;
    }
  }
  if (i < n) {
    float* out = partial + (static_cast<size_t>(blockIdx.y) * n + i) * W;
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[d] = acc[d];
    out[DIM] = acc_phi;
  }
}

// Sums the S partial records of each particle in slice order.
template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kThreads)
    gravity_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ accel, float* __restrict__ phi,
                          int n, int slices) {
  constexpr int W = DIM + 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
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
cudaError_t launch(const float* pos, const float* mass, float* partial,
                   float* accel, float* phi, int n, int slices, int slice_len,
                   float g, float soft2, cudaStream_t stream) {
  const int row_blocks = (n + kThreads - 1) / kThreads;
  pairwise_gravity_kernel<DIM, WITH_POTENTIAL>
      <<<dim3(row_blocks, slices), kThreads, 0, stream>>>(
          pos, mass, partial, n, slice_len, g, soft2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gravity_reduce_kernel<DIM, WITH_POTENTIAL>
      <<<row_blocks, kThreads, 0, stream>>>(partial, accel, phi, n, slices);
  return cudaGetLastError();
}

}  // namespace

// Launches the pair kernel and the slice reduction on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError().
// partial is (slices, n, dim + 1) float32 scratch; phi is ignored unless
// with_potential != 0. dim must be 2 or 3.
extern "C" int jtps_pairwise_gravity(const float* pos, const float* mass,
                                     float* partial, float* accel, float* phi,
                                     int n, int dim, int slices, int slice_len,
                                     float g, float soft2, int with_potential,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    err = with_potential
              ? launch<2, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
              : launch<2, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  } else if (dim == 3) {
    err = with_potential
              ? launch<3, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
              : launch<3, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
