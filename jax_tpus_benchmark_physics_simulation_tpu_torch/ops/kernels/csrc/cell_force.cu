// 2D Lennard-Jones 6-12 forces on the cell grid, for NVIDIA Hopper (sm_90a):
// kernels B1 (the unpacked layout), B1 halo (the unpacked layout on one
// rank's rows of a row-sharded grid) and B3 (R cell rows packed per block).
//
// Replaces the TPU kernels jax_tpus_benchmark_physics_simulation_tpu/
// ops/kernels/cell_pallas.py:_newton_kernel (B1, built by
// make_grid_force_kernel; B1 halo is its explicit-halo form, the `.raw` call
// at cell_pallas.py:346 that parallel/grid_md_sharded.py runs on each
// device's rows) and cell_pallas_packed.py:_packed_kernel (B3, built by
// make_grid_force_kernel_packed).
//
// Layout: x, y and every output are (G, cap, R * cps) float32, row-major,
// with G = cps / R blocks of R physical cell rows each. Slot (g, a, lane)
// holds slot a of the cell (cx, cy) = (g * R + lane / cps, lane % cps), so
// it sits at (g * cap + a) * R * cps + lane. B1 is R = 1: (cps, cap, cps).
// Empty slots hold the sentinel x = 2.5 * box, y = 0, so the validity test
// 0 < r2 < cutoff^2 rejects every pair that touches one without any
// occupancy mask.
//
// Both designs sum, for each target slot, the force on it (and, in the
// energy variant, the shifted pair energy e and the pair virial w, each
// pair being counted on both partners as the TPU kernels do), visiting the
// 9 neighbour cells in the same order with per-offset partial sums added in
// offset order. No Newton halving, no reaction outputs, no atomics: the
// result is deterministic. The TPU's lane rolls, block-crossing row patches
// and 128-lane padding have no counterpart here.
//
// B1 (cell_force_kernel): one thread per target slot, occupied or not. It
// loops over the 9 neighbour cells x cap partner slots. With PACKED = false,
// R is the constant 1 and the index arithmetic is B1's. Its PACKED = true
// form, the same loop on the packed layout, is not launched: B3 below
// visits particle pairs only. The template stays as it is so that B1's
// code does not change while B1 is B3's bit-exact yardstick.
//
// B1 halo: x and y are (n_rows + 2, cap, cps), one rank's n_rows cell rows
// with the previous rank's last row before them and the next rank's first
// row after them; the outputs are (n_rows, cap, cps), the local rows only.
// The caller has already put the x seam into the halo rows (-box on the
// first rank's previous row, +box on the last rank's next row), so the
// kernel neither wraps nor offsets rows; the column (y) seam is handled as
// in B1. With no Newton halving there are no reaction rows to send back. A
// slot visits its 9 cells in B1's order with the same float32 operations
// (fl(x + box) made by the caller is the fl(x + box) B1 makes), so the halo
// form over P row blocks is bit-equal to B1 on the whole grid.
//
// B3 (cell_force_counted_kernel): visits particle pairs only. It takes a
// (cps, cps) int32 grid of per-cell counts, which the engine makes once per
// rebuild: after a rebuild a cell's particles fill slots 0 .. count-1 and
// no particle changes slot until the next one. One block takes a strip of
// W cells of one cell row. It stages the strip's three neighbour rows
// (W + 2 columns, seam offsets added, occupied slots only) and their counts
// in shared memory, lays its occupied targets out compactly by a prefix sum
// of the strip's counts, and gives each thread one occupied target (a warp
// holds the targets of about five neighbouring cells). The thread loops over
// b < count of each neighbour cell. The results go through shared memory
// so that the block writes its strip's slots in coalesced rows, empty slots
// as 0.0f.
//
// Periodic seams: positions are not wrapped between rebuilds, so a particle
// may sit up to skin/2 outside [0, box). The seam is handled per neighbour
// offset, as the TPU kernels do: a partner whose cell row (column) wraps
// gets +-box on x (y). There is no per-pair minimum image: it would map the
// x sentinel 2.5*box back into the box and create phantom forces.
//
// What bounds them on an H100. B1: at N=100k the grid is 121 x 16 x 121 =
// 234k slots and each thread evaluates 9 * 16 = 144 partners, each with
// one IEEE division. The two coordinate planes (1.9 MB) sit in the 50 MB
// L2, and the partner reads of a warp are contiguous along cy, so memory
// traffic is small; the bound is the pair arithmetic and the divide. The
// design keeps the pair math to one divide (inv = sigma2 / r2, reused for
// s6, the force and the virial) and lets every thread stream its partners
// from L2 in coalesced rows. B3: at N=1M (55 x 16 x 2695, about 6.75
// particles a cell) the full-capacity loop made 341M pair evaluations for
// 59.7M particle pairs, 82% of them on empty slots, and 58% of its threads
// were empty targets. Visiting only particle pairs leaves the same pair
// arithmetic on a sixth of the work; what bounds it then is that arithmetic
// and the spread of the 9 counts among a warp's threads (a warp's loop over
// one neighbour cell runs as long as its fullest cell), with the partners
// read from shared memory rather than L2.
//
// Bit-equality: a pair that the full-capacity loop evaluates but B3 skips
// (an empty partner, or an empty target) adds an exact +-0.0f to a partial
// sum that is never -0.0f, and within an offset B3 keeps b ascending, so B3
// is bit-equal to B1 on the unpacked view, slot for slot.
//
// Built with --fmad=false (see _build.py): every pair term is then the same
// float32 arithmetic, op for op, as the plain PyTorch version's eager ops,
// so the kernels and the plain version differ only in summation order.

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
                                  int n_rows, int halo,
                                  float box, float cutoff2, float sigma2,
                                  float fscale, float epsilon, float shift) {
  const int R = PACKED ? rows_per_block : 1;
  const int lanes = R * cps;
  const int row = cap * lanes;  // one block of R cell rows
  const int n_slots = PACKED ? (cps / R) * row : n_rows * row;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int lane = i % lanes;
  const int cx = PACKED ? (i / row) * R + lane / cps : i / row;
  const int cy = PACKED ? lane % cps : lane;
  // halo form: input row cx + 1 holds output row cx
  const float xi = x[halo ? i + row : i];
  const float yi = y[halo ? i + row : i];
  const float two_fscale = 2.0f * fscale;
  const float four_eps = 4.0f * epsilon;
  const float wscale = fscale * sigma2;  // 24 * epsilon
  float acc_x = 0.0f, acc_y = 0.0f, acc_e = 0.0f, acc_w = 0.0f;

  for (int dx = -1; dx <= 1; ++dx) {
    int nx = cx + dx;
    float off_x = 0.0f;
    if (halo) {
      nx += 1;  // the halo rows carry their seam offset already
    } else if (nx < 0) {
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

// n_rows: the output's cell rows (cps, or a rank's rows with halo != 0)
template <bool PACKED>
int launch(const float* x, const float* y, float* fx, float* fy, float* e,
           float* w, int cps, int cap, int rows_per_block, int n_rows,
           int halo, float box, float cutoff2, float sigma2, float fscale,
           float epsilon, float shift, int with_energy, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = n_rows * cap * cps;
  const int threads = 256;
  const int blocks = (n_slots + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    cell_force_kernel<true, PACKED><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, rows_per_block, n_rows, halo, box,
        cutoff2, sigma2, fscale, epsilon, shift);
  } else {
    cell_force_kernel<false, PACKED><<<blocks, threads, 0, s>>>(
        x, y, fx, fy, e, w, cps, cap, rows_per_block, n_rows, halo, box,
        cutoff2, sigma2, fscale, epsilon, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// B3's shared memory for a strip of W cells: the staged x and y of 3 rows x
// (W + 2) columns x (cap + 1) slots (the extra slot spreads the cells over
// the banks), the results (2, or 4 with the energy, x W x cap), the staged
// counts, the prefix of the targets and each target's cell.
struct StripSmem {
  int W, cap, n_out;
  __host__ __device__ int cells() const { return 3 * (W + 2); }
  __host__ __device__ int stage() const { return cells() * (cap + 1); }
  __host__ __device__ int floats() const { return 2 * stage() + n_out * W * cap; }
  __host__ __device__ int bytes() const {
    return 4 * floats() + 4 * (cells() + W + 1) + W * cap;
  }
};

template <bool WITH_ENERGY>
__global__ void cell_force_counted_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ counts, float* __restrict__ fx,
    float* __restrict__ fy, float* __restrict__ e, float* __restrict__ w,
    int cps, int cap, int rows_per_block, int W, float box, float cutoff2,
    float sigma2, float fscale, float epsilon, float shift) {
  extern __shared__ float smem[];
  const StripSmem L{W, cap, WITH_ENERGY ? 4 : 2};
  const int n_cols = W + 2;
  float* sx = smem;
  float* sy = sx + L.stage();
  float* sres = sy + L.stage();  // n_out planes of (cap, W)
  int* scnt = reinterpret_cast<int*>(smem + L.floats());  // (3, W + 2)
  int* sstart = scnt + L.cells();                          // (W + 1)
  unsigned char* tcell = reinterpret_cast<unsigned char*>(sstart + W + 1);

  const int R = rows_per_block;
  const int lanes = R * cps;
  const int cx = blockIdx.y;
  const int cy0 = blockIdx.x * W;
  const int nc = min(W, cps - cy0);  // target cells in this strip
  const int tid = threadIdx.x;
  // slot 0 of cell (row, 0)
  auto row_base = [&](int row) { return (row / R) * cap * lanes + (row % R) * cps; };

  // 1. counts of the 3 x (nc + 2) staged cells, clamped to [0, cap]
  for (int j = tid; j < 3 * n_cols; j += blockDim.x) {
    const int r = j / n_cols, col = j % n_cols;
    int cnt = 0;
    if (col < nc + 2) {
      const int nx = (cx + r - 1 + cps) % cps;
      const int ny = (cy0 + col - 1 + cps) % cps;
      cnt = min(max(counts[nx * cps + ny], 0), cap);
    }
    scnt[j] = cnt;
  }
  __syncthreads();

  // 2. warp 0: prefix of the middle row's counts, each target's cell
  if (tid < 32) {
    const int c = tid;
    const int v = c < nc ? scnt[n_cols + c + 1] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (c >= d) incl += t;
    }
    if (c == 0) sstart[0] = 0;
    if (c < nc) {
      sstart[c + 1] = incl;
      for (int a = incl - v; a < incl; ++a) tcell[a] = static_cast<unsigned char>(c);
    }
  }
  // 3. every thread: the occupied slots of the staged cells, seam offsets
  // added as the full-capacity loop adds them to each partner
  for (int j = tid; j < 3 * cap * n_cols; j += blockDim.x) {
    const int col = j % n_cols;
    const int b = (j / n_cols) % cap;
    const int r = j / (n_cols * cap);
    if (b >= scnt[r * n_cols + col]) continue;
    int nx = cx + r - 1;
    float off_x = 0.0f;
    if (nx < 0) {
      nx += cps;
      off_x = -box;
    } else if (nx >= cps) {
      nx -= cps;
      off_x = box;
    }
    int ny = cy0 + col - 1;
    float off_y = 0.0f;
    if (ny < 0) {
      ny += cps;
      off_y = -box;
    } else if (ny >= cps) {
      ny -= cps;
      off_y = box;
    }
    const int src = row_base(nx) + b * lanes + ny;
    const int dst = (r * n_cols + col) * (cap + 1) + b;
    sx[dst] = x[src] + off_x;
    sy[dst] = y[src] + off_y;
  }
  __syncthreads();

  // 4. one thread per occupied target
  const float two_fscale = 2.0f * fscale;
  const float four_eps = 4.0f * epsilon;
  const float wscale = fscale * sigma2;  // 24 * epsilon
  const int total = sstart[nc];
  const int base_t = row_base(cx) + cy0;
  for (int t = tid; t < total; t += blockDim.x) {
    const int c = tcell[t];
    const int a = t - sstart[c];
    const float xi = x[base_t + a * lanes + c];
    const float yi = y[base_t + a * lanes + c];
    float acc_x = 0.0f, acc_y = 0.0f, acc_e = 0.0f, acc_w = 0.0f;
    for (int r = 0; r < 3; ++r) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int cell = r * n_cols + c + 1 + dy;
        const int n = scnt[cell];
        const float* xp = sx + cell * (cap + 1);
        const float* yp = sy + cell * (cap + 1);
        float part_x = 0.0f, part_y = 0.0f, part_e = 0.0f, part_w = 0.0f;
        for (int b = 0; b < n; ++b) {
          // B1's pair terms, op for op
          const float ddx = xi - xp[b];
          const float ddy = yi - yp[b];
          const float r2 = ddx * ddx + ddy * ddy;
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
    const int o = a * W + c;
    sres[o] = acc_x;
    sres[W * cap + o] = acc_y;
    if (WITH_ENERGY) {
      sres[2 * W * cap + o] = acc_e;
      sres[3 * W * cap + o] = acc_w;
    }
  }
  __syncthreads();

  // 5. the strip's slots in rows of nc consecutive cells; empty ones 0.0f,
  // what the full-capacity loop sums for them
  for (int j = tid; j < cap * nc; j += blockDim.x) {
    const int a = j / nc, c = j % nc;
    const bool occ = a < scnt[n_cols + c + 1];
    const int o = a * W + c;
    const int dst = base_t + a * lanes + c;
    fx[dst] = occ ? sres[o] : 0.0f;
    fy[dst] = occ ? sres[W * cap + o] : 0.0f;
    if (WITH_ENERGY) {
      e[dst] = occ ? sres[2 * W * cap + o] : 0.0f;
      w[dst] = occ ? sres[3 * W * cap + o] : 0.0f;
    }
  }
}

}  // namespace

// B1: launches the kernel on `stream` (a cudaStream_t passed as a pointer)
// and returns cudaGetLastError(). e and w are ignored unless with_energy != 0.
extern "C" int jtps_cell_force(const float* x, const float* y, float* fx,
                               float* fy, float* e, float* w, int cps, int cap,
                               float box, float cutoff2, float sigma2,
                               float fscale, float epsilon, float shift,
                               int with_energy, int device, void* stream) {
  return launch<false>(x, y, fx, fy, e, w, cps, cap, 1, cps, 0, box, cutoff2,
                       sigma2, fscale, epsilon, shift, with_energy, device,
                       stream);
}

// B1 halo: x and y are (n_rows + 2, cap, cps) with the halo rows attached
// (seam offsets included), fx, fy, e and w are (n_rows, cap, cps).
extern "C" int jtps_cell_force_halo(const float* x, const float* y, float* fx,
                                    float* fy, float* e, float* w, int n_rows,
                                    int cps, int cap, float box, float cutoff2,
                                    float sigma2, float fscale, float epsilon,
                                    float shift, int with_energy, int device,
                                    void* stream) {
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, y, fx, fy, e, w, cps, cap, 1, n_rows, 1, box,
                       cutoff2, sigma2, fscale, epsilon, shift, with_energy,
                       device, stream);
}

// B3: the same function on the packed (cps / R, cap, R * cps) layout, R
// dividing cps, visiting particle pairs only: counts is the (cps, cps)
// int32 grid of occupied slots per cell, which must hold slots
// 0 .. count-1 of each cell and no other.
extern "C" int jtps_cell_force_packed(const float* x, const float* y,
                                      const int* counts, float* fx, float* fy,
                                      float* e, float* w, int cps, int cap,
                                      int rows_per_block, float box,
                                      float cutoff2, float sigma2,
                                      float fscale, float epsilon, float shift,
                                      int with_energy, int device,
                                      void* stream) {
  if (rows_per_block < 1 || cps % rows_per_block != 0 || cps < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // strips of 32 cells; narrower where that leaves fewer than two blocks an
  // SM (N=16,384: 49 rows of 49 cells) or needs more than 48 KB
  int W = 32;
  while (W > 4 && static_cast<long long>(cps) * ((cps + W - 1) / W) < 2LL * n_sm) W /= 2;
  const int n_out = with_energy ? 4 : 2;
  while (W > 1 && StripSmem{W, cap, n_out}.bytes() > 48 * 1024) W /= 2;
  const int smem = StripSmem{W, cap, n_out}.bytes();
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = W >= 4 ? 8 * W : 32;  // about 6.75 targets a cell
  const dim3 grid((cps + W - 1) / W, cps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    cell_force_counted_kernel<true><<<grid, threads, smem, s>>>(
        x, y, counts, fx, fy, e, w, cps, cap, rows_per_block, W, box, cutoff2,
        sigma2, fscale, epsilon, shift);
  } else {
    cell_force_counted_kernel<false><<<grid, threads, smem, s>>>(
        x, y, counts, fx, fy, e, w, cps, cap, rows_per_block, W, box, cutoff2,
        sigma2, fscale, epsilon, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jtps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
