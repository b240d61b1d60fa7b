"""The allocation kernels' float32 steps (``alloc_wrap``,
``alloc_floor_div`` and ``alloc_cell_of`` in
``ops/kernels/csrc/alloc_math.cuh``) against the PyTorch operations of the
eager allocation on the card, bit for bit: ``torch.remainder(x, box)``,
``torch.div(x, box / cps, rounding_mode="floor")`` and the cell index
``torch.div(torch.remainder(x, box), box / cps, rounding_mode="floor")
.to(torch.int32).clamp(0, cps - 1)``, for every float32 ``x`` with ``|x| <
box + skin`` (every value a coordinate can hold at a rebuild: the drift
since the last one is under skin/2) at both benchmark cells' box, cells a
side and skin.

    python tests/torch_alloc_check.py OUT_DIR

Builds a checker that includes ``alloc_math.cuh`` with the port's nvcc
flags into ``OUT_DIR`` (the port does not ship it), prints the card and,
for each cell and function, the number of ``x`` tested and of mismatches,
and exits 1 if any differs."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = ("lj2d-n1m", "lj3d-inlj-2m")
CHUNK = 1 << 27

SOURCE = r"""
#include "alloc_math.cuh"

namespace {

__global__ void compare_alloc_math(unsigned lo, long long n, float box, float cell, float inv_cell, int cps,
                                   const float* w_ref, const float* q_ref, const int* c_ref,
                                   unsigned long long* bad, unsigned* first) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < n; k += stride) {
    const unsigned bits = lo + static_cast<unsigned>(k);
    const float x = __uint_as_float(bits);
    const float w = alloc_wrap(x, box);
    const bool miss[3] = {__float_as_uint(w) != __float_as_uint(w_ref[k]),
                          __float_as_uint(alloc_floor_div(x, cell, inv_cell)) != __float_as_uint(q_ref[k]),
                          alloc_cell_of(w, cell, inv_cell, cps) != c_ref[k]};
    for (int f = 0; f < 3; ++f) {
      if (miss[f]) {
        atomicAdd(bad + f, 1ULL);
        atomicMin(first + f, bits);
      }
    }
  }
}

}  // namespace

// counts, for the n float32 bit patterns from lo, where the wrap, the floor
// division and the cell index differ from the references; first[f] gets the
// smallest such pattern (or ~0u). 1 / cell is rounded here as the
// allocation's launcher rounds it.
extern "C" int check_alloc_math(unsigned lo, long long n, float box, float cell, int cps, const float* w_ref,
                                const float* q_ref, const int* c_ref, unsigned long long* bad, unsigned* first) {
  const float inv_cell = 1.0f / cell;
  compare_alloc_math<<<132 * 16, 256>>>(lo, n, box, cell, inv_cell, cps, w_ref, q_ref, c_ref, bad, first);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
    from port_bench import harness

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "alloc_check.cu", out_dir / "liballoc_check.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).check_alloc_math
    fn.argtypes = [ctypes.c_uint, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    names = ("torch.remainder", "torch.div floor", "cell index")
    total_bad = 0
    for name in CELLS:
        cell = harness.load_cell(name)
        cfg = MDConfig(**{**cell.config["md"], **cell.traffic.get("md", {})})
        md = lj_fluid._make_grid_md(cfg, dev)
        box, cps, width = md.box, md.cps, md.box / md.cps
        hi = int(torch.tensor(box + md.skin, dtype=torch.float32).view(torch.int32))  # |x| below this pattern
        bad = torch.zeros(3, dtype=torch.int64, device=dev)
        first = torch.full((3,), -1, dtype=torch.int32, device=dev)
        tested = 0
        for sign in (0, 1 << 31):
            for lo in range(0, hi, CHUNK):
                n = min(CHUNK, hi - lo)
                start = sign + lo
                signed = start - (1 << 32) if start >= 1 << 31 else start
                x = torch.arange(signed, signed + n, dtype=torch.int32, device=dev).view(torch.float32)
                w = torch.remainder(x, box)
                q = torch.div(x, width, rounding_mode="floor")
                c = torch.div(w, width, rounding_mode="floor").to(torch.int32).clamp(0, cps - 1)
                status = fn(start, n, box, width, cps, w.data_ptr(), q.data_ptr(), c.data_ptr(), bad.data_ptr(),
                            first.data_ptr())
                if status:
                    raise RuntimeError(f"check_alloc_math: CUDA error {status}")
                torch.cuda.synchronize()
                tested += n
        bad_h, first_h = bad.tolist(), [v & 0xFFFFFFFF for v in first.tolist()]
        total_bad += sum(bad_h)
        for f, what in enumerate(names):
            where = "" if not bad_h[f] else (
                f", first at x = {torch.tensor([first_h[f]], dtype=torch.int64).to(torch.int32).view(torch.float32)}")
            print(f"{name} (box {box!r}, cps {cps}, cell {width!r}, skin {md.skin!r}): {what}: {tested} float32 "
                  f"values with |x| < box + skin, {bad_h[f]} mismatches{where}", flush=True)
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
