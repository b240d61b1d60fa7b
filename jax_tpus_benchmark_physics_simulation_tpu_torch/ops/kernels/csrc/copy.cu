// Copy of a 1-D buffer, for NVIDIA Hopper (sm_90a): the explicit-copy
// variant of the op suite's bandwidth benchmark.
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// bench/ops.py:71 _copy_kernel (built by make_bandwidth_op(mode=
// "pallas_copy")), which moves a buffer HBM -> VMEM -> HBM one 512Ki-element
// chunk a grid step. The JAX chunk keeps its meaning only in the wrapper,
// as the truncation of the buffer to whole chunks; the blocks here are the
// card's own.
//
// Design: a grid-stride loop over 16-byte vectors (uint4), neighbouring
// threads on neighbouring addresses, four independent loads in flight per
// thread before their stores; one wave of blocks (8 resident 256-thread
// blocks on each of 132 SMs). The data type does not matter to a copy, so
// one kernel serves float32 and bfloat16; a tail of fewer than 16 bytes is
// copied byte by byte. The wrapper (copy_cuda.py) checks 16-byte alignment.
//
// What bounds it on an H100: bytes. Each byte is read once and written
// once: 2 x 256 MiB / 3.35 TB/s = 0.160 ms for a 256 MiB buffer.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads)
    copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                long long n_vec, int tail_bytes) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; k + 3 * stride < n_vec; k += 4 * stride) {
    const uint4 a = src[k];
    const uint4 b = src[k + stride];
    const uint4 c = src[k + 2 * stride];
    const uint4 d = src[k + 3 * stride];
    dst[k] = a;
    dst[k + stride] = b;
    dst[k + 2 * stride] = c;
    dst[k + 3 * stride] = d;
  }
  for (; k < n_vec; k += stride) dst[k] = src[k];
  if (blockIdx.x == 0 && threadIdx.x < tail_bytes) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src + n_vec);
    unsigned char* t = reinterpret_cast<unsigned char*>(dst + n_vec);
    t[threadIdx.x] = s[threadIdx.x];
  }
}

}  // namespace

// Copies n_bytes from src to dst (both 16-byte aligned) on `stream` and
// returns cudaGetLastError().
extern "C" int jtps_copy(const void* src, void* dst, long long n_bytes,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = n_bytes / 16;
  const int tail = static_cast<int>(n_bytes - n_vec * 16);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  copy_kernel<<<static_cast<int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec, tail);
  return static_cast<int>(cudaGetLastError());
}
