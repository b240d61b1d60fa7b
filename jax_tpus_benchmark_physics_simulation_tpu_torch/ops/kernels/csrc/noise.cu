// The Langevin windows' noise (2D and 3D grid engines), for NVIDIA Hopper
// (sm_90a): counter-based, keyed by particle and step.
//
// Replaces no TPU kernel. The JAX package draws a window's noise from
// jax.random with folded keys; the port drew it from a torch.Generator
// seeded once a window, a draw a grid slot. Here the noise of particle p,
// axis k, at global step t is a pure function of (stream seed, t, p, k):
//
//   words  w = Philox4x32-10(counter = (t mod 2^32, t >> 32, p, 0),
//                            key = (seed mod 2^32, (seed >> 32) mod 2^32))
//   pair   u1 = (w0 + 1) * 2^-32, u2 = w1 * 2^-32, r = sqrt(-2 ln u1),
//          z0 = r cos(2 pi u2), z1 = r sin(2 pi u2)
//   3D     z2 = r' cos(2 pi u2') from w2, w3 by the same pair rule
//
// (Philox4x32-10 as curand_Philox4x32_10 computes it, which is Random123's
// philox4x32_10: counter 0, key 0 gives 6627e8d5 e169c58d bc57ac4c
// 9b00dbd8.) So a particle's kicks do not depend on the slot the binning
// gave it, on the device, on the rank that holds it or on how the steps are
// cut into windows and blocks. noise_cuda.py holds the plain PyTorch
// version.
//
// Arithmetic, in float32: u1 = (float(w0) + 1) * 2^-32 (float(w) rounds to
// nearest, so u1 lies in (0, 1]), u2 = float(w1) * 2^-32, the accurate
// logf and sqrtf (no fast-math; -prec-sqrt holds by default), sincospif of
// 2 u2, whose argument needs no reduction by pi, and one product for each
// output. Every step rounds on its own (__fadd_rn, __fmul_rn).
//
// A thread a slot: it reads the slot's particle id and writes the slot of
// each of the D output planes, exactly 0 where the id is negative (an empty
// slot), so the window's velocities stay exactly at rest there with no
// occupancy mask. The planes are (D, n) contiguous.
//
// What bounds it on an H100: bytes, (4 + 4 D) a slot: at N=1M's 2.37M
// slots in 2D 28.5 MB, 8.5 us at 3.35 TB/s. Philox is 98 integer
// operations a particle (10 rounds of two 32 x 32 -> 64 products, as a low
// and a high half each, and four xors; nine key bumps of two adds), and
// Box-Muller a few tens a pair: ~0.1 G operations a launch at N=1M, for
// the ~42% of slots that hold a particle (port_bench/counts/noise.py).

#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPowMinus32 = 2.3283064365386963e-10f;  // 2^-32, exact

// z0 = r cos(2 pi u2), z1 = r sin(2 pi u2) from the words (a, b)
__device__ __forceinline__ void box_muller(unsigned a, unsigned b, float& z0, float& z1) {
  const float u1 = __fmul_rn(__fadd_rn(__uint2float_rn(a), 1.0f), kTwoPowMinus32);
  const float u2 = __fmul_rn(__uint2float_rn(b), kTwoPowMinus32);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincospif(__fmul_rn(2.0f, u2), &s, &c);
  z0 = __fmul_rn(r, c);
  z1 = __fmul_rn(r, s);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    langevin_noise_kernel(const int* __restrict__ pid, float* __restrict__ out, long long n, uint2 key,
                          unsigned t_lo, unsigned t_hi) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = pid[i];
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (p >= 0) {
    const uint4 w = curand_Philox4x32_10(make_uint4(t_lo, t_hi, static_cast<unsigned>(p), 0u), key);
    box_muller(w.x, w.y, z[0], z[1]);
    if (D == 3) box_muller(w.z, w.w, z[2], z[3]);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) out[k * n + i] = z[k];
}

}  // namespace

// The (dim, n) float32 noise of the n slots whose int32 particle ids are
// `pid` (negative: empty, noise 0) at global step (t_hi << 32) + t_lo under
// the stream key (k0, k1). Runs on `stream`, returns cudaGetLastError().
extern "C" int jtps_langevin_noise(const void* pid, void* out, long long n, int dim, unsigned k0, unsigned k1,
                                   unsigned t_lo, unsigned t_hi, int device, void* stream) {
  if (n < 0 || (dim != 2 && dim != 3) || (n + kThreads - 1) / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pid);
  float* o = static_cast<float*>(out);
  const uint2 key = make_uint2(k0, k1);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (dim == 2) langevin_noise_kernel<2><<<blocks, kThreads, 0, st>>>(p, o, n, key, t_lo, t_hi);
  else langevin_noise_kernel<3><<<blocks, kThreads, 0, st>>>(p, o, n, key, t_lo, t_hi);
  return static_cast<int>(cudaGetLastError());
}
