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
//   r2  = dx_0^2 + dx_1^2 (+ dx_2^2)
//   valid = j != i (and r2 < cutoff^2 when HAS_CUTOFF)
//   inv = sigma^2 / r2, s6 = inv^3, s12 = s6^2
//   f_i += 24 eps (2 s12 - s6) / r2 * dx
//        = s6 inv (2 fscale s6 - fscale) dx, fscale = 24 eps / sigma^2
//   e_i += 4 eps (s12 - s6) - shift          (WITH_ENERGY only)
// Total energy = 0.5 * sum_i e_i (the wrapper takes it).
//
// What bounds it on an H100: N^2 (4d + 12) operations, the JAX package's
// own cost estimate (pairwise_pallas.py:139-143) with N in place of its
// padded n_pad: 5.4 GFLOP at N=16,384 in 2D, 0.080 ms at the card's
// 67 TFLOP/s float32 peak (which counts an FMA as two operations). Its
// bytes (positions in, forces out) are a few hundred KB. So the kernel is
// bound by the instructions it issues a pair, and above all by those that
// run at 16 results a clock an SM against an FMA's 128 (the CUDA
// programming guide's throughput table for compute capability 9.0):
// reciprocals and conversions, rintf among them.
//
// Design: the tiled all-pairs loop of "N-Body Simulations on GPUs"
// (0706.3060), built for that bound.
// - One reciprocal a pair: rcp.approx (one quarter-rate instruction, at
//   most 1 ulp off), reused for s6, the force and the energy, in place of
//   two IEEE divides of many instructions each.
// - No rintf: the minimum image rounds by adding and subtracting 1.5 * 2^23
//   (exact round-half-even for |dx / box| < 2^22), two full-rate adds.
// - Explicit FMAs (__fmaf_rn) in r2, in the minimum image and in the
//   accumulations. The library is built with --fmad=false (_build.py), so
//   every FMA is one that this source writes and the other kernels keep
//   their separate roundings.
// - kRows = 4 i-particles a thread: one broadcast load of a staged j
//   (float2 in 2D, float4 in 3D) feeds four independent pair chains.
// - The j == i select runs only on the tiles that hold some of the block's
//   own particles (a uniform branch); elsewhere a pair without a cutoff
//   takes no select at all.
// Blocks of kThreads = 128 threads take kBlockRows = 512 i-particles; j is
// split into S slices of whole kTile = 512 tiles along the grid's y axis
// (at most 32, chosen by the wrapper: at N=16,384, 32 x 32 = 1024 blocks,
// about 7.8 an SM, all resident at once at 64 registers a thread, so no SM
// runs a second, partly empty round). Each block writes
// its partial sums to an (S, N, D+1) scratch buffer, and a second launch
// sums the S partials of each particle in slice order. There are no float
// atomics, so two launches on one input are bit-equal. The last tile is cut
// to the particles that exist: no padding of N or of the coordinate axis.
// pairwise_cuda.py mirrors these constants (_lj_geometry).
//
// Arithmetic against the plain version lj_force_pairwise_reference: the
// reciprocal (1 ulp), the fused roundings and the summation order differ,
// so the kernel agrees with it to a tolerance (forces within 1e-4 of the
// largest |f|, energy sums at rtol 1e-5), not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                   // threads of a block
constexpr int kRows = 4;                        // i-particles a thread
constexpr int kBlockRows = kThreads * kRows;    // i-particles a block
constexpr int kTile = 512;                      // j of a shared tile
constexpr int kReduceThreads = 256;
constexpr float kRound = 12582912.0f;           // 1.5 * 2^23

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

struct Consts {
  float box, inv_box, cutoff2, sigma2, two_fscale, fscale, c4, shift;
};

template <int DIM>
struct Staged;
template <>
struct Staged<2> {
  using type = float2;
  __device__ static float2 load(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static float at(const float2& v, int d) { return d == 0 ? v.x : v.y; }
};
template <>
struct Staged<3> {
  using type = float4;
  __device__ static float4 load(const float* p) { return make_float4(p[0], p[1], p[2], 0.0f); }
  __device__ static float at(const float4& v, int d) { return d == 0 ? v.x : (d == 1 ? v.y : v.z); }
};

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One pair (i, j) added to i's sums. SELF: the tile may hold i itself, so
// j == i (not_self false) is masked.
template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF, bool SELF>
__device__ __forceinline__ void add_pair(const float (&xi)[DIM],
                                         const typename Staged<DIM>::type& xj,
                                         bool not_self, const Consts& c,
                                         float (&acc)[DIM], float& acc_e) {
  float dx[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    float t = __fsub_rn(xi[d], Staged<DIM>::at(xj, d));
    if (HAS_BOX) {
      const float k = __fsub_rn(__fmaf_rn(t, c.inv_box, kRound), kRound);
      t = __fmaf_rn(-c.box, k, t);
    }
    dx[d] = t;
  }
  float r2 = __fmul_rn(dx[0], dx[0]);
#pragma unroll
  for (int d = 1; d < DIM; ++d) r2 = __fmaf_rn(dx[d], dx[d], r2);
  bool valid = true;
  if (SELF) valid = not_self;
  if (HAS_CUTOFF) valid = valid && (r2 < c.cutoff2);
  // r2 == 0 only for j == i here (or two particles on one point, where the
  // plain version is not finite either)
  const float r2s = SELF ? (not_self ? r2 : 1.0f) : r2;
  const float inv = __fmul_rn(c.sigma2, rcp_approx(r2s));
  const float s6 = __fmul_rn(__fmul_rn(inv, inv), inv);
  float fmag = __fmul_rn(__fmul_rn(s6, inv), __fmaf_rn(c.two_fscale, s6, -c.fscale));
  if (SELF || HAS_CUTOFF) fmag = valid ? fmag : 0.0f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] = __fmaf_rn(fmag, dx[d], acc[d]);
  if (WITH_ENERGY) {
    float pe = __fmaf_rn(c.c4, __fmaf_rn(s6, s6, -s6), -c.shift);
    if (SELF || HAS_CUTOFF) pe = valid ? pe : 0.0f;
    acc_e = __fadd_rn(acc_e, pe);
  }
}

template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF, bool SELF>
__device__ __forceinline__ void tile_pairs(const typename Staged<DIM>::type* tile, int len, int j0,
                                           const int (&ii)[kRows], float (&xi)[kRows][DIM],
                                           const Consts& c, float (&acc)[kRows][DIM],
                                           float (&acc_e)[kRows]) {
#pragma unroll 4
  for (int jj = 0; jj < len; ++jj) {
    const typename Staged<DIM>::type xj = tile[jj];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      add_pair<DIM, WITH_ENERGY, HAS_BOX, HAS_CUTOFF, SELF>(xi[k], xj, j0 + jj != ii[k], c, acc[k],
                                                          acc_e[k]);
    }
  }
}

template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF>
__global__ void __launch_bounds__(kThreads, 8)
    pairwise_lj_kernel(const float* __restrict__ pos, float* __restrict__ partial, int n,
                       int slice_len, Consts c) {
  using V = typename Staged<DIM>::type;
  constexpr int W = DIM + 1;  // a partial record: D force sums, the energy
  __shared__ V tile[kTile];
  const int i0 = blockIdx.x * kBlockRows;
  const int j_begin = blockIdx.y * slice_len;
  const int j_end = min(j_begin + slice_len, n);
  int ii[kRows];
  float xi[kRows][DIM];
  float acc[kRows][DIM];
  float acc_e[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    ii[k] = i0 + k * kThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      xi[k][d] = ii[k] < n ? pos[ii[k] * DIM + d] : 0.0f;
      acc[k][d] = 0.0f;
    }
    acc_e[k] = 0.0f;
  }

  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int len = min(kTile, j_end - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < len; k += kThreads) tile[k] = Staged<DIM>::load(pos + (j0 + k) * DIM);
    __syncthreads();
    if (j0 < i0 + kBlockRows && i0 < j0 + len) {
      tile_pairs<DIM, WITH_ENERGY, HAS_BOX, HAS_CUTOFF, true>(tile, len, j0, ii, xi, c, acc, acc_e);
    } else {
      tile_pairs<DIM, WITH_ENERGY, HAS_BOX, HAS_CUTOFF, false>(tile, len, j0, ii, xi, c, acc, acc_e);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (ii[k] < n) {
      float* out = partial + (static_cast<size_t>(blockIdx.y) * n + ii[k]) * W;
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[d] = acc[k][d];
      out[DIM] = acc_e[k];
    }
  }
}

// Sums the S partial records of each particle in slice order.
template <int DIM, bool WITH_ENERGY>
__global__ void __launch_bounds__(kReduceThreads)
    pairwise_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ force,
                           float* __restrict__ energy, int n, int slices) {
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
  for (int d = 0; d < DIM; ++d) force[i * DIM + d] = acc[d];
  if (WITH_ENERGY) energy[i] = acc[DIM];
}

template <int DIM, bool WITH_ENERGY, bool HAS_BOX, bool HAS_CUTOFF>
cudaError_t launch(const PairArgs& a) {
  const float fscale = a.c24 / a.sigma2;
  const Consts c{a.box, a.inv_box, a.cutoff2, a.sigma2, 2.0f * fscale, fscale, a.c4, a.shift};
  const int row_blocks = (a.n + kBlockRows - 1) / kBlockRows;
  pairwise_lj_kernel<DIM, WITH_ENERGY, HAS_BOX, HAS_CUTOFF>
      <<<dim3(row_blocks, a.slices), kThreads, 0, a.stream>>>(a.pos, a.partial, a.n, a.slice_len, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pairwise_reduce_kernel<DIM, WITH_ENERGY>
      <<<(a.n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, a.stream>>>(
          a.partial, a.force, a.energy, a.n, a.slices);
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
// partial is (slices, n, dim + 1) float32 scratch; slice_len must be a
// multiple of the 512-particle tile and slices * slice_len must cover n.
// energy is ignored unless with_energy != 0. dim must be 2 or 3.
extern "C" int jtps_pairwise_lj(const float* pos, float* partial, float* force,
                                float* energy, int n, int dim, int slices,
                                int slice_len, float box, float inv_box,
                                float cutoff2, float sigma2, float c24,
                                float c4, float shift, int has_box,
                                int has_cutoff, int with_energy, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dim != 2 && dim != 3) || n < 1 || slices < 1 || slice_len < kTile ||
      slice_len % kTile != 0 || static_cast<long long>(slices) * slice_len < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const PairArgs a{pos,       partial, force,   energy,
                   n,         slices,  slice_len, box,
                   inv_box,   cutoff2, sigma2,  c24,
                   c4,        shift,   static_cast<cudaStream_t>(stream)};
  err = dim == 2 ? pick_energy<2>(a, with_energy, has_box, has_cutoff)
                 : pick_energy<3>(a, with_energy, has_box, has_cutoff);
  return static_cast<int>(err);
}
