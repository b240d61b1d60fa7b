// 2D Lennard-Jones 6-12 forces on the cell grid, for NVIDIA Hopper (sm_90a):
// kernels B1 (the unpacked layout) and B3 (R cell rows packed per block).
//
// Replaces the TPU kernels jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/cell_pallas.py:_newton_kernel (B1, built by
// make_grid_force_kernel) and cell_pallas_packed.py:_packed_kernel (B3,
// built by make_grid_force_kernel_packed).
//
// Layout: x, y and every output are (G, cap, R * cps) float32, row-major,
// with G = cps / R blocks of R physical cell rows each. Slot (g, a, lane)
// holds slot a of the cell (cx, cy) = (g * R + lane / cps, lane % cps), so
// it sits at (g * cap + a) * R * cps + lane. B1 is R = 1: (cps, cap, cps).
// Empty slots hold the sentinel x = 2.5 * box, y = 0, so the validity test
// 0 < r2 < cutoff^2 rejects every pair that touches one without any
// occupancy mask.
//
// Design: one thread per target slot. It loops over the 9 neighbour cells x
// cap partner slots and sums the force on its own slot (and, in the energy
// variant, the shifted pair energy e and the pair virial w, each pair being
// counted on both partners as the TPU kernels do). No Newton halving, no
// reaction outputs, no atomics: the result is deterministic. The packed
// form (PACKED = true) differs only in where a cell's slots sit; the TPU's
// lane rolls, block-crossing row patches and 128-lane padding have no
// counterpart here. With PACKED = false, R is the constant 1 and the index
// arithmetic is B1's.
//
// Periodic seams: positions are not wrapped between rebuilds, so a particle
// may sit up to skin/2 outside [0, box). The seam is handled per neighbour
// offset, as the TPU kernels do: a partner whose cell row (column) wraps
// gets +-box on x (y). There is no per-pair minimum image: it would map the
// x sentinel 2.5*box back into the box and create phantom forces.
//
// What bounds it on an H100: at N=100k (B1) the grid is 121 x 16 x 121 =
// 234k slots, at N=1M (B3, R=7) 55 x 16 x 2695 = 2.37M, and each thread
// evaluates 9 * 16 = 144 partners, each with one IEEE division. The two
// coordinate planes (1.9 MB; 19 MB at N=1M) sit in the 50 MB L2, and the
// partner reads of a warp are contiguous along cy (a warp that straddles
// two cell rows reads one more partner row), so memory traffic is small;
// the bound is the pair arithmetic and the divide. The design keeps the
// pair math to one divide (inv = sigma2 / r2, reused for s6, the force and
// the virial) and lets every thread stream its partners from L2 in
// coalesced rows.
//
// Built with --fmad=false (see _build.py): every pair term is then the same
// float32 arithmetic, op for op, as the plain PyTorch version's eager ops,
// so the kernel and the plain version differ only in summation order.

#include <cuda_runtime.h>

namespace {

template <bool WITH_ENERGY, bool PACKED>
__global__ void cell_force_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ fx,
                                  float* __restrict__ fy,
                                  float* __restrict__ e,
                                  float* __restrict__ w,
                                  int cps, int cap, int rows_per_block,
                                  float box, float cutoff2, float sigma2,
                                  float fscale, float epsilon, float shift) {
  const int R = PACKED ? rows_per_block : 1;
  const int lanes = R * cps;
  const int row = cap * lanes;  // one block of R cell rows
  const int n_slots = (cps / R) * row;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int lane = i % lanes;
  const int cx = PACKED ? (i / row) * R + lane / cps : i / row;
  const int cy = PACKED ? lane % cps : lane;
  const float xi = x[i];
  const float yi = y[i];
  const float two_fscale = 2.0f * fscale;
  const float four_eps = 4.0f * epsilon;
  const float wscale = fscale * sigma2;  // 24 * epsilon
  float acc_x = 0.0f, acc_y = 0.0f, acc_e = 0.0f, acc_w = 0.0f;

  for (int dx = -1; dx <= 1; ++dx) {
    int nx = cx + dx;
    float off_x = 0.0f;
    if (nx < 0) {
      nx += cps;
      off_x = -box;
    } else if (nx >= cps) {
      nx -= cps;
      off_x = box;
    }
    // slot 0 of cell (nx, 0)
    const int base_x = PACKED ? (nx / R) * row + (nx % R) * cps : nx * row;
    for (int dy = -1; dy <= 1; ++dy) {
      int ny = cy + dy;
      float off_y = 0.0f;
      if (ny < 0) {
        ny += cps;
        off_y = -box;
      } else if (ny >= cps) {
        ny -= cps;
        off_y = box;
      }
      const float* xp = x + base_x + ny;
      const float* yp = y + base_x + ny;
      // per-offset partial sums, added to the totals in offset order, as
      // the plain version sums its pair blocks
      float part_x = 0.0f, part_y = 0.0f, part_e = 0.0f, part_w = 0.0f;
      for (int b = 0; b < cap; ++b) {
        const float ddx = xi - (xp[b * lanes] + off_x);
        const float ddy = yi - (yp[b * lanes] + off_y);
        const float r2 = ddx * ddx + ddy * ddy;
        // the self pair and empty-empty pairs give r2 == 0, so inv is
        // inf and the terms inf/NaN: the selects below drop them
        const bool valid = (r2 > 0.0f) && (r2 < cutoff2);
        const float inv = sigma2 / r2;
        const float s6 = inv * inv * inv;
        if (WITH_ENERGY) {
          const float s12 = s6 * s6;
          const float fmag = valid ? (2.0f * s12 - s6) * inv * fscale : 0.0f;
          part_x += fmag * ddx;
          part_y += fmag * ddy;
          part_e += valid ? four_eps * (s12 - s6) - shift : 0.0f;
          part_w += valid ? (2.0f * s12 - s6) * wscale : 0.0f;
        } else {
          const float fmag = valid ? s6 * inv * (two_fscale * s6 - fscale) : 0.0f;
          part_x += fmag * ddx;
          part_y += fmag * ddy;
        }
      }
      acc_x += part_x;
      acc_y += part_y;
      if (WITH_ENERGY) {
        acc_e += part_e;
        acc_w += part_w;
      }
    }
  }
  fx[i] = acc_x;
  fy[i] = acc_y;
  if (WITH_ENERGY) {
    e[i] = acc_e;
    w[i] = acc_w;
  }
}

template <bool PACKED>
int launch(const float* x, const float* y, float* fx, float* fy, float* e,
           float* w, int cps, int cap, int rows_per_block, float box,
           float cutoff2, float sigma2, float fscale, float epsilon,
           float shift, int with_energy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = cps * cap * cps;
  const int threads = 256;
  const int blocks = (n_slots + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    cell_force_kernel<true, PACKED><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, rows_per_block, box, cutoff2, sigma2,
        fscale, epsilon, shift);
  } else {
    cell_force_kernel<false, PACKED><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, rows_per_block, box, cutoff2, sigma2,
        fscale, epsilon, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1: launches the kernel on `stream` (a cudaStream_t passed as a pointer)
// and returns cudaGetLastError(). e and w are ignored unless with_energy != 0.
extern "C" int jtps_cell_force(const float* x, const float* y, float* fx,
                               float* fy, float* e, float* w, int cps, int cap,
                               float box, float cutoff2, float sigma2,
                               float fscale, float epsilon, float shift,
                               int with_energy, int device, void* stream) {
  return launch<false>(x, y, fx, fy, e, w, cps, cap, 1, box, cutoff2, sigma2,
                       fscale, epsilon, shift, with_energy, device, stream);
}

// B3: the same on the packed (cps / R, cap, R * cps) layout; R must divide
// cps.
extern "C" int jtps_cell_force_packed(const float* x, const float* y,
                                      float* fx, float* fy, float* e, float* w,
                                      int cps, int cap, int rows_per_block,
                                      float box, float cutoff2, float sigma2,
                                      float fscale, float epsilon, float shift,
                                      int with_energy, int device,
                                      void* stream) {
  if (rows_per_block < 1 || cps % rows_per_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, y, fx, fy, e, w, cps, cap, rows_per_block, box,
                      cutoff2, sigma2, fscale, epsilon, shift, with_energy,
                      device, stream);
}

extern "C" const char* jtps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
