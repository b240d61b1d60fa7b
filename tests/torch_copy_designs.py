"""Kernel B10 against the two other copy designs it was chosen over, on the
card: each bit-equal to its source, then timed in 7 interleaved repeats of 20
calls (``utils.profiling.interleaved_ms``) beside ``dst.copy_``, at 256 MiB of
float32 and of bfloat16.

    python tests/torch_copy_designs.py OUT_DIR

The two designs are built here, from the source below, with ``nvcc`` into
``OUT_DIR``; the port does not ship them:

- ``span``: a persistent grid of two 256-thread blocks an SM, each block one
  contiguous span of the buffer cut on 16-byte boundaries, eight 16-byte
  streaming loads (``__ldcs``) in flight a thread before their streaming
  stores (``__stcs``);
- ``bulk``: one block an SM, in which one thread drives Hopper's bulk copy:
  ``cp.async.bulk`` global -> shared into a ring of eight 16 KB stages, each
  completed on an mbarrier, then ``cp.async.bulk`` shared -> global; the
  block takes every gridDim-th stage-sized chunk, and a stage is loaded
  again once its store has read it.

Both copy a last short span or stage and a tail of fewer than 16 bytes in
the kernel, as B10 (``ops/kernels/csrc/copy.cu``) does."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void copy_tail(const void* src, void* dst,
                                          long long n_vec, int tail_bytes) {
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < tail_bytes) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src) + 16 * n_vec;
    unsigned char* t = reinterpret_cast<unsigned char*>(dst) + 16 * n_vec;
    t[threadIdx.x] = s[threadIdx.x];
  }
}

constexpr int kSpanThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kSpanThreads)
    copy_span_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     long long n_vec, int tail_bytes) {
  const long long per = (n_vec + gridDim.x - 1) / gridDim.x;
  const long long lo = min(n_vec, per * blockIdx.x);
  const long long hi = min(n_vec, lo + per);
  long long k = lo + threadIdx.x;
  for (; k + (kUnroll - 1) * kSpanThreads < hi; k += kUnroll * kSpanThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(src + k + u * kSpanThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcs(dst + k + u * kSpanThreads, v[u]);
  }
  for (; k < hi; k += kSpanThreads) __stcs(dst + k, __ldcs(src + k));
  copy_tail(src, dst, n_vec, tail_bytes);
}

constexpr int kStages = 8;
constexpr int kStageBytes = 16 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
    copy_bulk_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     long long n_vec, int tail_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bar[kStages];
  copy_tail(src, dst, n_vec, tail_bytes);
  if (threadIdx.x != 0) return;
  const long long bytes = 16 * n_vec;
  const long long all_chunks = (bytes + kStageBytes - 1) / kStageBytes;
  const int n_chunks = blockIdx.x < all_chunks
      ? static_cast<int>((all_chunks - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[s])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  auto offset = [&](int i) {
    return (blockIdx.x + static_cast<long long>(i) * gridDim.x) * kStageBytes;
  };
  auto chunk_bytes = [&](int i) {
    return static_cast<unsigned>(min(static_cast<long long>(kStageBytes), bytes - offset(i)));
  };
  auto load = [&](int i) {
    const int s = i % kStages;
    const unsigned b = smem_addr(&bar[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(chunk_bytes(i)) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(ring + s * kStageBytes)), "l"(src + offset(i)),
        "r"(chunk_bytes(i)), "r"(b) : "memory");
  };
  for (int i = 0; i < kStages && i < n_chunks; ++i) load(i);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    const unsigned parity = (i / kStages) & 1;
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(smem_addr(&bar[s])), "r"(parity) : "memory");
    } while (!done);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + offset(i)), "r"(smem_addr(ring + s * kStageBytes)),
                 "r"(chunk_bytes(i)) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // stage (i - 1) % kStages takes chunk i - 1 + kStages once store i - 1
    // has read it (store i may still be reading)
    const int next = i - 1 + kStages;
    if (i >= 1 && next < n_chunks) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(next);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// design 0: span, 1: bulk; returns cudaGetLastError()
extern "C" int design_copy(const void* src, void* dst, long long n_bytes,
                           int design, void* stream) {
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const long long n_vec = n_bytes / 16;
  const int tail = static_cast<int>(n_bytes - n_vec * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    copy_span_kernel<<<2 * n_sm, kSpanThreads, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec, tail);
  } else {
    const int smem = kStages * kStageBytes;
    cudaFuncSetAttribute(copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    copy_bulk_kernel<<<n_sm, 32, smem, s>>>(static_cast<const char*>(src),
                                            static_cast<char*>(dst), n_vec, tail);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

DESIGNS = ("span", "bulk")


def build(out_dir: Path):
    """``design_copy`` from ``SOURCE``, built with B10's nvcc flags."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "copy_designs.cu", out_dir / "libcopy_designs.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).design_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import copy_cuda
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms, spread

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    fn = build(Path(sys.argv[1]))

    def copy(src, design):
        dst = torch.empty_like(src)
        status = fn(src.data_ptr(), dst.data_ptr(), src.numel() * src.element_size(),
                    DESIGNS.index(design), torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{design}: CUDA error {status}")
        return dst

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, n_el in ((torch.float32, 64 << 20), (torch.bfloat16, 128 << 20)):
        src = torch.randn(n_el, generator=torch.Generator(device=dev).manual_seed(21), device=dev).to(dtype)
        # the whole buffer; 3 stages, 1001 vectors and 4 bytes; 3.5 stages an
        # SM and 4 bytes
        sizes = [n_el] + [b // src.element_size() for b in (3 * 16384 + 16 * 1001 + 4, 7 * n_sm * 16384 // 2 + 4)]
        for design in DESIGNS:
            for k in sizes:
                if not torch.equal(copy(src[:k], design), src[:k]):
                    raise AssertionError(f"{design} {dtype}: {k} elements not bit-equal")
        dst = torch.empty_like(src)
        t = interleaved_ms({"B10": lambda: copy_cuda.chunked_copy(src),
                             **{d: (lambda d=d: copy(src, d)) for d in DESIGNS},
                             "copy_": lambda: dst.copy_(src)})
        print(f"{dtype} 256 MiB, bit-equal on {sizes} elements; medians of 7 interleaved repeats of 20 calls: "
              + ", ".join(f"{name} {spread(v)} ({v[0] / t['copy_'][0]:.4f}x copy_)" for name, v in t.items()),
              flush=True)
        del src, dst
    return 0


if __name__ == "__main__":
    sys.exit(main())
