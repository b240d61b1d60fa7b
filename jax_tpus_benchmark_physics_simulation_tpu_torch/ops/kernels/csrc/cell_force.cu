// 2D Lennard-Jones 6-12 forces on the cell grid, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/cell_pallas.py:_newton_kernel (built by make_grid_force_kernel).
//
// Layout: x, y and every output are (cps, cap, cps) float32, row-major:
// slot (cx, a, cy) sits at (cx * cap + a) * cps + cy. Empty slots hold the
// sentinel x = 2.5 * box, y = 0, so the validity test 0 < r2 < cutoff^2
// rejects every pair that touches one without any occupancy mask.
//
// Design: one thread per target slot. It loops over the 9 neighbour cells x
// cap partner slots and sums the force on its own slot (and, in the energy
// variant, the shifted pair energy e and the pair virial w, each pair being
// counted on both partners as the TPU kernel does). No Newton halving, no
// reaction outputs, no atomics: the result is deterministic.
//
// Periodic seams: positions are not wrapped between rebuilds, so a particle
// may sit up to skin/2 outside [0, box). The seam is handled per neighbour
// offset, as the TPU kernel does: a partner whose cell row (column) wraps
// gets +-box on x (y). There is no per-pair minimum image: it would map the
// x sentinel 2.5*box back into the box and create phantom forces.
//
// What bounds it on an H100: at N=100k the grid is 121 x 16 x 121 = 234k
// slots and each thread evaluates 9 * 16 = 144 partners, 33.7M pair terms
// a step, each with one IEEE division. The two coordinate planes (1.9 MB)
// sit in the 50 MB L2, and the partner reads of a warp are contiguous along
// cy, so memory traffic is small; the bound is the pair arithmetic and the
// divide. The design keeps the pair math to one divide (inv = sigma2 / r2,
// reused for s6, the force and the virial) and lets every thread stream its
// partners from L2 in coalesced rows.
//
// Built with --fmad=false (see _build.py): every pair term is then the same
// float32 arithmetic, op for op, as the plain PyTorch version's eager ops,
// so the kernel and the plain version differ only in summation order.

#include <cuda_runtime.h>

namespace {

template <bool WITH_ENERGY>
__global__ void cell_force_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ fx,
                                  float* __restrict__ fy,
                                  float* __restrict__ e,
                                  float* __restrict__ w,
                                  int cps, int cap, float box, float cutoff2,
                                  float sigma2, float fscale, float epsilon,
                                  float shift) {
  const int row = cap * cps;
  const int n_slots = cps * row;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int cx = i / row;
  const int cy = i % cps;
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
      const float* xp = x + nx * row + ny;
      const float* yp = y + nx * row + ny;
      // per-offset partial sums, added to the totals in offset order, as
      // the plain version sums its pair blocks
      float part_x = 0.0f, part_y = 0.0f, part_e = 0.0f, part_w = 0.0f;
      for (int b = 0; b < cap; ++b) {
        const float ddx = xi - (xp[b * cps] + off_x);
        const float ddy = yi - (yp[b * cps] + off_y);
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

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t passed as a pointer) and
// returns cudaGetLastError(). e and w are ignored unless with_energy != 0.
extern "C" int jtps_cell_force(const float* x, const float* y, float* fx,
                               float* fy, float* e, float* w, int cps, int cap,
                               float box, float cutoff2, float sigma2,
                               float fscale, float epsilon, float shift,
                               int with_energy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = cps * cap * cps;
  const int threads = 256;
  const int blocks = (n_slots + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    cell_force_kernel<true><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, box, cutoff2, sigma2, fscale, epsilon,
        shift);
  } else {
    cell_force_kernel<false><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, box, cutoff2, sigma2, fscale, epsilon,
        shift);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jtps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
