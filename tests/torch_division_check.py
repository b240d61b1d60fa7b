"""The counted kernels' division (``div_rn_normal`` in
``ops/kernels/csrc/pair_math.cuh``, which the counted 3D kernel and the 2D
tile kernel share) against IEEE division ``a / b`` (div.rn.f32, as B5's
and B1's loops divide), bit for bit, on the card, for every float32 ``b``
in ``[a * 2^-46, 64)`` and ``a`` = sigma^2 for sigma in 1.0 (every
configuration of the repository), 0.9, 1.1 and 2.0. Below ``a * 2^-46``
both divisions give an s6 that overflows to inf, so the kernels clamp
``r2`` there; 64 is past every cutoff^2 in use (2.5^2, and (2.5 sigma)^2
at sigma 2 is 25).

    python tests/torch_division_check.py OUT_DIR

Builds a checker that includes ``pair_math.cuh`` with the port's nvcc
flags into ``OUT_DIR`` (the port does not ship it), prints the card and,
for each ``a``, the number of ``b`` tested and of mismatches, and exits 1
if any ``b`` differs."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "pair_math.cuh"

namespace {

__global__ void compare_division(float a, unsigned lo, unsigned hi,
                                 unsigned long long* mismatches, unsigned* first) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long k = lo + blockIdx.x * blockDim.x + threadIdx.x; k < hi; k += stride) {
    const float b = __uint_as_float(static_cast<unsigned>(k));
    const float want = a / b;
    const float got = div_rn_normal(a, b);
    if (__float_as_uint(want) != __float_as_uint(got)) {
      atomicAdd(mismatches, 1ULL);
      atomicMin(first, static_cast<unsigned>(k));
    }
  }
}

}  // namespace

// counts the b in [lo, hi) (float32 bit patterns) where div_rn_normal(a, b)
// differs from a / b; *first gets the smallest such pattern (or ~0u)
extern "C" int check_division(float a, unsigned lo, unsigned hi,
                              unsigned long long* count, unsigned* first) {
  unsigned long long* d_count = nullptr;
  unsigned* d_first = nullptr;
  cudaMalloc(&d_count, sizeof(unsigned long long));
  cudaMalloc(&d_first, sizeof(unsigned));
  cudaMemset(d_count, 0, sizeof(unsigned long long));
  cudaMemset(d_first, 0xff, sizeof(unsigned));
  compare_division<<<132 * 16, 256>>>(a, lo, hi, d_count, d_first);
  cudaMemcpy(count, d_count, sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaMemcpy(first, d_first, sizeof(unsigned), cudaMemcpyDeviceToHost);
  cudaFree(d_count);
  cudaFree(d_first);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import numpy as np

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "division_check.cu", out_dir / "libdivision_check.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).check_division
    fn.argtypes = [ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_ulonglong),
                   ctypes.POINTER(ctypes.c_uint)]
    fn.restype = ctypes.c_int
    bits = lambda v: int(np.float32(v).view(np.uint32))  # noqa: E731
    bad = 0
    for sigma in (1.0, 0.9, 1.1, 2.0):
        a = np.float32(sigma) * np.float32(sigma)
        lo, hi = bits(a * np.float32(2.0**-46)), bits(64.0)
        count, first = ctypes.c_ulonglong(0), ctypes.c_uint(0)
        status = fn(float(a), lo, hi, ctypes.byref(count), ctypes.byref(first))
        if status:
            raise RuntimeError(f"check_division: CUDA error {status}")
        bad += count.value
        where = "" if not count.value else f", first at b = {np.uint32(first.value).view(np.float32)!r}"
        print(f"a = sigma^2 = {a!r} (sigma {sigma}): {hi - lo} values of b in [a * 2^-46, 64), "
              f"{count.value} mismatches{where}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
