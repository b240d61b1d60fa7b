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
// What bounds it on an H100: bytes. Each byte is read once and written
// once: 2 x 256 MiB / 3.35 TB/s = 0.160 ms for a 256 MiB buffer. The
// yardstick, dst.copy_ (a device-to-device cudaMemcpyAsync), keeps the
// memory busy with reads and writes of the same offsets at once.
//
// Design: one 16-byte vector a thread, 1024-thread blocks, one block for
// each 16 KB of the buffer, so that the block scheduler, not a loop, streams
// the buffer: every load is in flight at once in its block, neighbouring
// threads on neighbouring addresses, and each block writes the offsets it
// reads. Persistent grids that walk the buffer (contiguous spans a block
// with streaming cache hints, tiles a grid apart, or Hopper's bulk copy
// through a ring of shared-memory stages) were slower on the card
// (PERF.md, B10).
//
// The data type does not matter to a copy, so one kernel serves float32 and
// bfloat16. A last block shorter than the others, and a tail of fewer than
// 16 bytes (byte by byte, by the last block), are copied in the kernel. The
// wrapper (copy_cuda.py) checks 16-byte alignment.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    copy_flat_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     long long n_vec, int tail_bytes) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k < n_vec) dst[k] = src[k];
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < tail_bytes) {
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
  if (n_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = n_bytes / 16;
  const int tail = static_cast<int>(n_bytes - n_vec * 16);
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  copy_flat_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec, tail);
  return static_cast<int>(cudaGetLastError());
}
