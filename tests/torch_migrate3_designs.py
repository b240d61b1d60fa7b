"""Kernel B6 (the 3D rebuild permutation and its mover flag) against the
design it replaced, on the card: both checked against the plain versions,
then timed in turns in one process.

    python tests/torch_migrate3_designs.py OUT_DIR

The previous design is built here, from the source below, with ``nvcc``
into ``OUT_DIR``; the port does not ship it. One rebuild of it was:

- a ``torch.stack`` of the F field planes into one (F, ncx, cap, ncy * ncz)
  tensor;
- a fill launch that writes ``fills[f]`` into every one of the F x ncx x
  cap x ncy * ncz output slots (grid: slot blocks x fields);
- a scatter launch, one thread a source slot, that writes the slot's F
  fields to the target its code names (B6 halo: from the ``(rows + 2)``
  extended rows, a write outside the local rows dropped);
- the mover flag in plain PyTorch (``migrate_cuda3.mover_overflow``: a
  compare, a division, ``!=``, ``&``, a sum, ``>`` and ``any``).

The states are ``chip_smoke.py``'s: phase 7's (3D N=100k, 19 cells per side,
90 steps from an equilibrated run) and phase 25's (18 cells per side, 90
steps into the melt, at one rank's shape with the halo rows). On each, the
previous design and the port's B6, B7 and B6 halo are torch.equal to the
plain versions with the same mover flag, then timed in 7 interleaved
repeats of 20 calls, each queued behind a spin of the card
(``utils.profiling.cuda_ms(lead=True)``): the whole previous rebuild step,
its fill alone, its scatter alone, the flag alone, and the port's kernel.
``chip_smoke.py`` builds the previous design with :func:`build` and times it
beside B6, B7 and B6 halo.
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

constexpr int kMaxFields = 16;

struct Fills {
  float v[kMaxFields];
};

__global__ void fill_kernel(float* __restrict__ out, Fills fills, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  out[static_cast<long long>(blockIdx.y) * n_slots + i] = fills.v[blockIdx.y];
}

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// halo != 0: scode and fields carry one halo x-row on each side (ncx + 2
// rows), out the ncx local rows; a target outside them is dropped
__global__ void scatter_kernel(const int* __restrict__ scode, const float* __restrict__ fields,
                               float* __restrict__ out, int n_fields, int ncx, int cap, int ncy,
                               int ncz, int halo) {
  const int plane = ncy * ncz;
  const int row = cap * plane;
  const int n_src = (ncx + 2 * halo) * row;
  const int n_out = ncx * row;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_src) return;
  const int code = scode[s];
  if (code < 0 || code >= 27 * cap) return;
  const int dcode = code / cap;
  const int a = code % cap;
  const int lane = s % plane;
  int tx = s / row + dcode / 9 - 1;
  if (halo) {
    tx -= 1;  // extended row + dx - 1
    if (tx < 0 || tx >= ncx) return;
  } else {
    tx = wrap(tx, ncx);
  }
  const int ty = wrap(lane / ncz + (dcode / 3) % 3 - 1, ncy);
  const int tz = wrap(lane % ncz + dcode % 3 - 1, ncz);
  const int t = (tx * cap + a) * plane + ty * ncz + tz;
  for (int f = 0; f < n_fields; ++f) out[f * n_out + t] = fields[f * n_src + s];
}

}  // namespace

// what: 0 the fill then the scatter (the previous B6 launcher), 1 the fill
// alone, 2 the scatter alone
extern "C" int design_migrate3(const int* scode, const float* fields, float* out,
                               const float* fills, int n_fields, int ncx, int cap, int ncy,
                               int ncz, int halo, int what, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  Fills f{};
  for (int k = 0; k < n_fields; ++k) f.v[k] = fills[k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int n_out = ncx * cap * ncy * ncz;
  if (what != 2) {
    fill_kernel<<<dim3((n_out + threads - 1) / threads, n_fields), threads, 0, st>>>(out, f, n_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (what != 1) {
    const int n_src = (ncx + 2 * (halo != 0)) * cap * ncy * ncz;
    scatter_kernel<<<(n_src + threads - 1) / threads, threads, 0, st>>>(
        scode, fields, out, n_fields, ncx, cap, ncy, ncz, halo != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(out_dir: Path):
    """``design_migrate3`` from ``SOURCE``, built with the port's nvcc
    flags."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "migrate3_designs.cu", out_dir / "libmigrate3_designs.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).design_migrate3
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def previous(fn, scode, fields, fills, k_mov=None, halo=False, what=0):
    """One rebuild of the previous design: the stack (``fields`` a list of
    planes), the fill and the scatter (``what`` 1: the fill alone, 2: the
    scatter alone, into an uninitialised output) and, with ``k_mov``, the
    plain flag. Returns ``(out, mov_of)``."""
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3

    stacked = torch.stack(fields) if isinstance(fields, (list, tuple)) else fields
    n_fields, ext_rows, cap, plane = stacked.shape
    rows = ext_rows - 2 if halo else ext_rows
    c = int(round(plane ** 0.5))
    out = torch.empty((n_fields, rows, cap, plane), dtype=stacked.dtype, device=stacked.device)
    status = fn(scode.data_ptr(), stacked.data_ptr(), out.data_ptr(), (ctypes.c_float * n_fields)(*fills),
                n_fields, rows, cap, c, c, int(halo), what, torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"previous B6 design: CUDA error {status}")
    mov_of = None if k_mov is None else migrate_cuda3.mover_overflow(scode[1:-1] if halo else scode, k_mov)
    return out, mov_of


def config3():
    """``chip_smoke.py``'s 3D N=100k configuration (phase 6)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override

    return override(MDConfig(), n=100_000, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, init="lattice",
                    force_impl="grid", compensated=True, eq_steps=2000, prod_steps=2000, sample_every=100,
                    dim=3)


def state7(dev):
    """Phase 7's state: 90 fixed-cadence steps from the final state of the
    3D N=100k main path. Returns ``(md, state)``."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    cfg3 = config3()
    res3 = lj_fluid.run(cfg3, device=dev)
    md3 = lj_fluid._make_grid_md(cfg3, dev)
    gs = md3.init(res3.state.position, res3.state.velocity)
    return md3, md3.make_production_run_fixed(90, res3.cadence or 9)(gs)


def state_melt(dev, cfg):
    """Phase 25's kind of state for ``cfg``: 90 steps at cadence 9 into the
    melt from the lattice. Returns ``(md, state)``."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    md = lj_fluid._make_grid_md(cfg, dev)
    st = lj_fluid.init_state(cfg, dev)
    return md, md.make_production_run_fixed(90, 9)(md.init(st.position, st.velocity))


def config25():
    """Phase 25's configuration: N=100k rounded for devices [1, 2], the skin
    rounded to 2 devices (18 cells per side)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling

    cfg3 = config3()
    cfg = override(cfg3, n=scaling._round_to_divisible_n(cfg3.n, cfg3, [1, 2]))
    return override(cfg, skin=lj_fluid.resolve_skin(cfg, "grid", n_devices=2))


def rebuild_inputs(md, gs):
    """The rebuild's inputs on ``gs``, as ``GridMD3._rebuild_migrate`` makes
    them: the code grid, the allocation's occupancy, the 16 field planes
    (Kahan residuals included) and their fills."""
    import torch

    xw, yw, zw, scode, occ_new, _, _ = md._migration_dest(gs)
    planes = [xw, yw, zw, gs.vxg, gs.vyg, gs.vzg, gs.fxg, gs.fyg, gs.fzg, gs.pid.to(torch.float32),
              gs.crx, gs.cry, gs.crz, gs.cvx, gs.cvy, gs.cvz]
    fills = [md.sentinel] + [0.0] * 8 + [-1.0] + [0.0] * 6
    return scode, occ_new, planes, fills


def main() -> int:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import halo_blocks
    from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.profiling import interleaved_ms, spread

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    fn = build(Path(sys.argv[1]))
    dev = torch.device("cuda")

    md, gs = state7(dev)
    scode, occ, planes, fills = rebuild_inputs(md, gs)
    k_mov = md.migrate_k_mov
    stacked = torch.stack(planes)
    want = migrate_cuda3.migrate3_reference(scode, stacked, fills)
    want_flag = bool(migrate_cuda3.mover_overflow(scode, k_mov))
    for label, (out, flag) in (("previous", previous(fn, scode, planes, fills, k_mov)),
                               ("B6", migrate_cuda3.migrate3(scode, planes, fills, k_mov, occ=occ)),
                               ("B7", migrate_cuda3.migrate3(scode, planes, fills, occ=occ))):
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: not torch.equal to migrate3_reference")
        if label != "B7" and bool(flag) != want_flag:
            raise AssertionError(f"{label}: mover flag {bool(flag)}, mover_overflow {want_flag}")
    t = interleaved_ms({
        "B6": lambda: migrate_cuda3.migrate3(scode, planes, fills, k_mov, occ=occ),
        "B7": lambda: migrate_cuda3.migrate3(scode, planes, fills, occ=occ),
        "previous B6": lambda: previous(fn, scode, planes, fills, k_mov),
        "previous B7": lambda: previous(fn, scode, planes, fills),
        "stack": lambda: torch.stack(planes),
        "fill": lambda: previous(fn, scode, stacked, fills, what=1),
        "scatter": lambda: previous(fn, scode, stacked, fills, what=2),
        "mover_overflow": lambda: migrate_cuda3.mover_overflow(scode, k_mov),
    }, lead=True)
    print(f"N={md.n} grid {tuple(gs.xg.shape)}, {len(planes)} fields, mover flag {want_flag} (k_mov {k_mov}); "
          f"previous, B6, B7 torch.equal to the plain version; medians of 7 interleaved repeats of 20 calls "
          f"(lead): " + ", ".join(f"{k} {spread(v)}" for k, v in t.items()), flush=True)

    md25, g25 = state_melt(dev, config25())
    scode25, occ25, planes25, fills25 = rebuild_inputs(md25, g25)
    stacked25 = torch.stack(planes25)
    (ch,), (fh,) = halo_blocks(scode25, 1), halo_blocks(stacked25, 1, dim=1)
    want_h = migrate_cuda3.migrate3_halo_reference(ch, fh, fills25)
    want_hf = bool(migrate_cuda3.mover_overflow(scode25, k_mov))
    for label, (out, flag) in (("previous halo", previous(fn, ch, fh, fills25, k_mov, halo=True)),
                               ("B6 halo", migrate_cuda3.migrate3_halo(ch, fh, fills25, k_mov=k_mov, occ=occ25))):
        if not torch.equal(out, want_h) or bool(flag) != want_hf:
            raise AssertionError(f"{label}: not torch.equal to migrate3_halo_reference, or another flag")
    th = interleaved_ms({
        "B6 halo": lambda: migrate_cuda3.migrate3_halo(ch, fh, fills25, k_mov=k_mov, occ=occ25),
        "previous B6 halo": lambda: previous(fn, ch, fh, fills25, k_mov, halo=True),
        "fill": lambda: previous(fn, ch, fh, fills25, halo=True, what=1),
        "scatter": lambda: previous(fn, ch, fh, fills25, halo=True, what=2),
        "mover_overflow": lambda: migrate_cuda3.mover_overflow(ch[1:-1], k_mov),
    }, lead=True)
    print(f"N={md25.n} one rank's halo shape {tuple(ch.shape)} -> {tuple(scode25.shape)}, mover flag {want_hf}; "
          f"previous and B6 halo torch.equal to the plain version; medians of 7 interleaved repeats of 20 calls "
          f"(lead): " + ", ".join(f"{k} {spread(v)}" for k, v in th.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
