"""Kernel B9 (all-pairs softened gravity) against the design it replaced,
on the card: both within 1e-5 * max |.| of the plain version, then timed in
7 interleaved repeats of 20 calls (``utils.profiling.interleaved_ms``).

    python tests/torch_gravity_designs.py OUT_DIR

The previous design is built here, from the source below, with the port's
nvcc flags (``--fmad=false``) into ``OUT_DIR``; the port does not ship it:
one thread an i-particle in 256-thread blocks, 256-particle j-tiles of
scalars ``(x, y[, z], g m)`` in shared memory, 16 j slices summed by a
second launch, ``rsqrtf`` and the ``j == i`` select on every pair, every
product and sum rounded alone. The inputs are ``chip_smoke.py``'s phase 20:
N=16,384 in 2D and N=65,536 in 3D, positions normal * 10 and masses 0.5 +
U(0, 1) from a numpy seed, softening 0.1, g 1, with and without the
potential. ``chip_smoke.py`` builds the previous design with
:func:`build` and times it beside B9.
"""

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

template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kThreads)
    previous_gravity_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                            float* __restrict__ partial, int n, int slice_len, float g, float soft2) {
  constexpr int W = DIM + 1;
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
    __syncthreads();
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

template <int DIM, bool WITH_POTENTIAL>
__global__ void __launch_bounds__(kThreads)
    previous_reduce_kernel(const float* __restrict__ partial, float* __restrict__ accel,
                           float* __restrict__ phi, int n, int slices) {
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
void launch(const float* pos, const float* mass, float* partial, float* accel, float* phi, int n,
            int slices, int slice_len, float g, float soft2, cudaStream_t s) {
  const int row_blocks = (n + kThreads - 1) / kThreads;
  previous_gravity_kernel<DIM, WITH_POTENTIAL>
      <<<dim3(row_blocks, slices), kThreads, 0, s>>>(pos, mass, partial, n, slice_len, g, soft2);
  previous_reduce_kernel<DIM, WITH_POTENTIAL><<<row_blocks, kThreads, 0, s>>>(partial, accel, phi, n, slices);
}

}  // namespace

extern "C" int previous_pairwise_gravity(const float* pos, const float* mass, float* partial, float* accel,
                                         float* phi, int n, int dim, int slices, int slice_len, float g,
                                         float soft2, int with_potential, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    with_potential ? launch<2, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
                   : launch<2, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  } else {
    with_potential ? launch<3, true>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s)
                   : launch<3, false>(pos, mass, partial, accel, phi, n, slices, slice_len, g, soft2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

THREADS, MAX_SLICES = 256, 16  # the previous design's block and tile, and its j slices


def build(out_dir: Path):
    """``previous_pairwise_gravity`` from ``SOURCE``, built with the port's
    nvcc flags."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "gravity_designs.cu", out_dir / "libgravity_designs.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).previous_pairwise_gravity
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def previous(fn, pos, m, g: float = 1.0, softening: float = 0.0, with_potential: bool = False):
    """One call of the previous design: ``(a,)`` or ``(a, phi)``."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda

    n, dim = pos.shape
    slices, slice_len = pairwise_cuda._cut(n, THREADS, MAX_SLICES)
    partial = torch.empty((slices, n, dim + 1), dtype=torch.float32, device=pos.device)
    a = torch.empty_like(pos)
    phi = torch.empty(n, dtype=torch.float32, device=pos.device)
    status = fn(pos.data_ptr(), m.data_ptr(), partial.data_ptr(), a.data_ptr(), phi.data_ptr(), n, dim, slices,
                slice_len, g, softening * softening, int(with_potential), torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"previous B9 design: CUDA error {status}")
    return (a, phi) if with_potential else (a,)


def bodies(n: int, dim: int, seed: int, device):
    """Positions normal * 10 and masses 0.5 + U(0, 1), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.standard_normal((n, dim)) * 10.0).astype(np.float32)).to(device)
    return pos, torch.from_numpy((0.5 + rng.random(n)).astype(np.float32)).to(device)


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import pairwise_cuda
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms, spread
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.roofline import gravity_bounds

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    fn = build(Path(sys.argv[1]))
    dev = torch.device("cuda")
    for n, dim in ((16_384, 2), (65_536, 3)):
        pos, m = bodies(n, dim, 2020 + dim, dev)
        for phi in (False, True):
            want = pairwise_cuda.gravity_accel_pairwise_reference(pos, m, 1.0, 0.1, phi)
            for name, got in (("B9", pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, 0.1, phi)),
                              ("previous", previous(fn, pos, m, 1.0, 0.1, phi))):
                for a, b in zip(got, want):
                    err, scale = float((a - b).abs().max()), float(b.abs().max())
                    if not err <= 1e-5 * scale:
                        raise AssertionError(f"{name} N={n} (potential {phi}): max abs diff {err:.3e} > 1e-5 * "
                                             f"{scale:.3e}")
        t = interleaved_ms({
            "B9": lambda: pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, 0.1),
            "previous": lambda: previous(fn, pos, m, 1.0, 0.1),
            "B9 potential": lambda: pairwise_cuda.gravity_accel_pairwise(pos, m, 1.0, 0.1, True),
            "previous potential": lambda: previous(fn, pos, m, 1.0, 0.1, True),
        }, reps=20 if n < 65_536 else 3)
        bound, bound_p = gravity_bounds(n, dim)
        print(f"N={n} {dim}D: B9 and the previous design within 1e-5 * max |.| of the plain "
              f"version; medians of 7 interleaved "
              f"repeats: " + ", ".join(f"{k} {spread(v)}" for k, v in t.items())
              + f"; bound {bound[0]:.5f} ms ({bound[1]}), with the potential {bound_p[0]:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
