// All-pairs Lennard-Jones 6-12 forces (and per-particle energies), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/pairwise_pallas.py:48 _lj_kernel (built by
// make_lj_force_pallas and make_lj_energy_pallas).
//
// Computes, for every particle i of the (N, D) float32 positions (D = 2 or
// 3), the sum over every other particle j of
//   dx  = x_i - x_j, with the minimum image dx - box * rint(dx * (1/box))
//         when HAS_BOX (rint rounds half to even, as jnp.round does)
//   r2  = dx_0^2 + dx_1^2 (+ dx_2^2), left to right
//   valid = j != i (and r2 < cutoff^2 when HAS_CUTOFF)
//   s6  = (sigma^2 / r2)^3, s12 = s6^2
//   f_i += 24 eps (2 s12 - s6) / r2 * dx
//   e_i += 4 eps (s12 - s6) - shift          (WITH_ENERGY only)
// Total energy = 0.5 * sum_i e_i (the wrapper takes it).
//
// Design: the tiled all-pairs loop of "N-Body Simulations on GPUs"
// (0706.3060), not the Pallas grid. Each thread owns one i-particle and
// walks j-tiles of kThreads particles staged through shared memory (every
// thread of the block reads the same tile element at once: a broadcast).
// One thread per row alone gives N/256 blocks, 64 at N=16,384, for 132 SMs,
// so j is split into S slices along the grid's y axis; each block writes
// its partial sums to an (S, N, D+1) scratch buffer, and a second launch
// sums the S partials of each particle in slice order. S is picked by the
// wrapper (pairwise_cuda.py): up to 16 slices of whole tiles, 1024 blocks
// of 256 threads at N=16,384, 4 tiles each. There are no float atomics, so
// two launches on one input are bit-equal. The last tile is cut to the
// particles that exist: no padding of N or of the coordinate axis.
//
// Arithmetic: IEEE division (no --use_fast_math) and no FMA contraction
// (--fmad=false, see _build.py), so each pair term is the same float32
// arithmetic, op for op, as the plain PyTorch version
// lj_force_pairwise_reference; the two differ only in summation order.
//
// What bounds it on an H100: N^2 (4d + 12) operations, the JAX package's
// own cost estimate (pairwise_pallas.py:139-143) with N in place of its
// padded n_pad: 5.4 GFLOP at N=16,384 in 2D, 0.080 ms at the card's
// 67 TFLOP/s float32 peak. Its bytes (positions in, forces out) are a few
// hundred KB. Each pair also takes two IEEE divides (sigma^2 / r2 and the
// force's / r2), each a reciprocal estimate, Newton steps and a range
// check of many instructions, so this first kernel sits well above that
// bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // i-particles of a block, and j-tile length

struct PairArgs {
  const float* pos;
  float* partial;
  float* force;
  float* energy;
  int n;
  int slices;
  int slice_len;
  float box;
  float inv_box;
  float cutoff2;
  float sigma2;
  float c24;  // 24 * epsilon
  float c4;   // 4 * epsilon
  float shift;
  cudaStream_t stream;
};

template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF>
__global__ void __launch_bounds__(kThreads)
    pairwise_lj_kernel(const float* __restrict__ pos,
                       float* __restrict__ partial, int n, int slice_len,
                       float box, float inv_box, float cutoff2, float sigma2,
                       float c24, float c4, float shift) {
  constexpr int W = DIM + 1;  // a partial record: D force sums, the energy
  __shared__ float tile[kThreads * DIM];
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
  float acc_e = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int len = min(kThreads, j_end - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < len * DIM; k += kThreads) {
      tile[k] = pos[j0 * DIM + k];
    }
    __syncthreads();
    for (int jj = 0; jj < len; ++jj) {
      float dx[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        float t = xi[d] - tile[jj * DIM + d];
        if (HAS_BOX) t = t - box * rintf(t * inv_box);
        dx[d] = t;
      }
      float r2 = dx[0] * dx[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) r2 = r2 + dx[d] * dx[d];
      bool valid = (j0 + jj) != i;
      if (HAS_CUTOFF) valid = valid && (r2 < cutoff2);
      const float r2s = valid ? r2 : 1.0f;
      const float inv = sigma2 / r2s;
      const float s6 = inv * inv * inv;
      const float s12 = s6 * s6;
      const float fmag = valid ? c24 * (2.0f * s12 - s6) / r2s : 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc[d] += fmag * dx[d];
      if (WITH_ENERGY) acc_e += valid ? c4 * (s12 - s6) - shift : 0.0f;
    }
  }
  if (i < n) {
    float* out = partial + (static_cast<size_t>(blockIdx.y) * n + i) * W;
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[d] = acc[d];
    out[DIM] = acc_e;
  }
}

// Sums the S partial records of each particle in slice order.
template <int DIM, bool WITH_ENERGY>
__global__ void __launch_bounds__(kThreads)
    pairwise_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ force,
                           float* __restrict__ energy, int n, int slices) {
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
  for (int d = 0; d < DIM; ++d) force[i * DIM + d] = acc[d];
  if (WITH_ENERGY) energy[i] = acc[DIM];
}

template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF>
cudaError_t launch(const PairArgs& a) {
  const int row_blocks = (a.n + kThreads - 1) / kThreads;
  pairwise_lj_kernel<DIM, WITH_ENERGY, HAS_BOX, HAS_CUTOFF>
      <<<dim3(row_blocks, a.slices), kThreads, 0, a.stream>>>(
          a.pos, a.partial, a.n, a.slice_len, a.box, a.inv_box, a.cutoff2,
          a.sigma2, a.c24, a.c4, a.shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pairwise_reduce_kernel<DIM, WITH_ENERGY>
      <<<row_blocks, kThreads, 0, a.stream>>>(a.partial, a.force, a.energy,
                                              a.n, a.slices);
  return cudaGetLastError();
}

template <int DIM, bool WITH_ENERGY, bool HAS_BOX>
cudaError_t pick_cutoff(const PairArgs& a, bool has_cutoff) {
  return has_cutoff ? launch<DIM, WITH_ENERGY, HAS_BOX, true>(a)
                    : launch<DIM, WITH_ENERGY, HAS_BOX, false>(a);
}

template <int DIM, bool WITH_ENERGY>
cudaError_t pick_box(const PairArgs& a, bool has_box, bool has_cutoff) {
  return has_box ? pick_cutoff<DIM, WITH_ENERGY, true>(a, has_cutoff)
                 : pick_cutoff<DIM, WITH_ENERGY, false>(a, has_cutoff);
}

template <int DIM>
cudaError_t pick_energy(const PairArgs& a, bool with_energy, bool has_box,
                        bool has_cutoff) {
  return with_energy ? pick_box<DIM, true>(a, has_box, has_cutoff)
                     : pick_box<DIM, false>(a, has_box, has_cutoff);
}

}  // namespace

// Launches the pair kernel and the slice reduction on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError().
// partial is (slices, n, dim + 1) float32 scratch; energy is ignored
// unless with_energy != 0. dim must be 2 or 3.
extern "C" int jtps_pairwise_lj(const float* pos, float* partial, float* force,
                                float* energy, int n, int dim, int slices,
                                int slice_len, float box, float inv_box,
                                float cutoff2, float sigma2, float c24,
                                float c4, float shift, int has_box,
                                int has_cutoff, int with_energy, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const PairArgs a{pos,       partial, force,   energy,
                   n,         slices,  slice_len, box,
                   inv_box,   cutoff2, sigma2,  c24,
                   c4,        shift,   static_cast<cudaStream_t>(stream)};
  err = dim == 2 ? pick_energy<2>(a, with_energy, has_box, has_cutoff)
                 : pick_energy<3>(a, with_energy, has_box, has_cutoff);
  return static_cast<int>(err);
}
