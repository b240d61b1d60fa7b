"""Kernel B8 against the design it replaced, on the card, at the all-pairs
main path's shape (N=16,384, 2D, PBC, no cutoff, on positions 100 steps
into the melt from the lattice): each within 1e-4 * max |f| of the plain
version (energy sums at rtol 1e-5), then both variants timed in 7
interleaved repeats of 20 calls (``utils.profiling.interleaved_ms``).

    python tests/torch_pairwise_designs.py OUT_DIR

The previous design is built here, from the source below, with the port's
nvcc flags (``--fmad=false``) into ``OUT_DIR``; the port does not ship it:
one thread an i-particle in 256-thread blocks, 256-particle j-tiles of
scalars in shared memory, 16 j slices summed by a second launch, and per
pair ``rintf`` for the minimum image and two IEEE divides (``sigma^2 /
r2`` and the force's ``/ r2``), every product and sum rounded alone."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // i-particles of a block, and j-tile length

// 2D, a periodic box, no cutoff
template <bool WITH_ENERGY>
__global__ void __launch_bounds__(kThreads)
    previous_lj_kernel(const float* __restrict__ pos, float* __restrict__ partial, int n,
                       int slice_len, float box, float inv_box, float sigma2, float c24,
                       float c4) {
  constexpr int DIM = 2, W = 3;
  __shared__ float tile[kThreads * DIM];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int j_begin = blockIdx.y * slice_len;
  const int j_end = min(j_begin + slice_len, n);
  float xi[DIM], acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    xi[d] = i < n ? pos[i * DIM + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float acc_e = 0.0f;
  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int len = min(kThreads, j_end - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < len * DIM; k += kThreads) tile[k] = pos[j0 * DIM + k];
    __syncthreads();
    for (int jj = 0; jj < len; ++jj) {
      float dx[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        float t = xi[d] - tile[jj * DIM + d];
        t = t - box * rintf(t * inv_box);
        dx[d] = t;
      }
      const float r2 = dx[0] * dx[0] + dx[1] * dx[1];
      const bool valid = (j0 + jj) != i;
      const float r2s = valid ? r2 : 1.0f;
      const float inv = sigma2 / r2s;
      const float s6 = inv * inv * inv;
      const float s12 = s6 * s6;
      const float fmag = valid ? c24 * (2.0f * s12 - s6) / r2s : 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc[d] += fmag * dx[d];
      if (WITH_ENERGY) acc_e += valid ? c4 * (s12 - s6) : 0.0f;
    }
  }
  if (i < n) {
    float* out = partial + (static_cast<size_t>(blockIdx.y) * n + i) * W;
    out[0] = acc[0];
    out[1] = acc[1];
    out[2] = acc_e;
  }
}

template <bool WITH_ENERGY>
__global__ void __launch_bounds__(kThreads)
    previous_reduce_kernel(const float* __restrict__ partial, float* __restrict__ force,
                           float* __restrict__ energy, int n, int slices) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < slices; ++s) {
    const float* rec = partial + (static_cast<size_t>(s) * n + i) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += rec[c];
  }
  force[i * 2] = acc[0];
  force[i * 2 + 1] = acc[1];
  if (WITH_ENERGY) energy[i] = acc[2];
}

}  // namespace

extern "C" int previous_pairwise_lj(const float* pos, float* partial, float* force,
                                    float* energy, int n, int slices, int slice_len,
                                    float box, float sigma2, float c24, float c4,
                                    int with_energy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(row_blocks, slices);
  if (with_energy) {
    previous_lj_kernel<true><<<grid, kThreads, 0, s>>>(pos, partial, n, slice_len, box, 1.0f / box, sigma2, c24, c4);
    previous_reduce_kernel<true><<<row_blocks, kThreads, 0, s>>>(partial, force, energy, n, slices);
  } else {
    previous_lj_kernel<false><<<grid, kThreads, 0, s>>>(pos, partial, n, slice_len, box, 1.0f / box, sigma2, c24, c4);
    previous_reduce_kernel<false><<<row_blocks, kThreads, 0, s>>>(partial, force, energy, n, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(out_dir: Path):
    """``previous_pairwise_lj`` from ``SOURCE``, built with the port's nvcc
    flags."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "pairwise_designs.cu", out_dir / "libpairwise_designs.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).previous_pairwise_lj
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    from chip_smoke import _pairwise_bounds
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms, spread
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    fn = build(Path(sys.argv[1]))
    dev = torch.device("cuda")
    cfg = override(MDConfig(), n=16_384, rho=0.8, kt=1.0, dt=1e-3, cutoff=None, init="lattice", eq_steps=100)
    pos = lj_fluid.equilibrate(cfg, lj_fluid.init_state(cfg, dev))[0].position
    n = cfg.n
    p = pairwise_cuda.PairwiseParams(box=cfg.box_size)
    slices, slice_len = pairwise_cuda._cut(n, 256, 16)

    def previous(with_energy):
        partial = torch.empty((slices, n, 3), dtype=torch.float32, device=dev)
        f = torch.empty_like(pos)
        e = torch.empty(n, dtype=torch.float32, device=dev)
        status = fn(pos.data_ptr(), partial.data_ptr(), f.data_ptr(), e.data_ptr(), n, slices, slice_len,
                    p.box, p.sigma * p.sigma, 24.0 * p.epsilon, 4.0 * p.epsilon, int(with_energy),
                    torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"previous design: CUDA error {status}")
        return (f, e) if with_energy else (f,)

    for with_energy in (False, True):
        want = pairwise_cuda.lj_force_pairwise_reference(pos, p, with_energy)
        fmax = float(want[0].abs().max())
        for name, got in (("B8", pairwise_cuda.lj_force_pairwise(pos, p, with_energy)),
                          ("previous", previous(with_energy))):
            err = float((got[0] - want[0]).abs().max())
            if not err <= 1e-4 * fmax:
                raise AssertionError(f"{name} (energy {with_energy}): forces max abs diff {err:.3e} > 1e-4 * {fmax:.3e}")
            if with_energy:
                se, sr = float(got[1].double().sum()), float(want[1].double().sum())
                if not abs(se - sr) <= 1e-5 * abs(sr):
                    raise AssertionError(f"{name}: energy sum {se} vs {sr}, beyond rtol 1e-5")
    t = interleaved_ms({"B8": lambda: pairwise_cuda.lj_force_pairwise(pos, p),
                         "previous": lambda: previous(False),
                         "B8 energy": lambda: pairwise_cuda.lj_force_pairwise(pos, p, True),
                         "previous energy": lambda: previous(True)})
    bound, bound_e = _pairwise_bounds(n, 2)
    print(f"N={n} 2D PBC, both designs within 1e-4 * max |f| of the plain version (energy sums at rtol 1e-5); "
          f"medians of 7 interleaved repeats of 20 calls: "
          + ", ".join(f"{name} {spread(v)}" for name, v in t.items())
          + f"; bound {bound[0]:.5f} ms ({bound[1]}), with the energy {bound_e[0]:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
