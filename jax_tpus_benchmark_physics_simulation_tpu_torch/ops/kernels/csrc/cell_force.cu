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
// Every design sums, for each target slot, the force on it (and, in the
// energy variant, the shifted pair energy e and the pair virial w, each
// pair being counted on both partners as the TPU kernels do), visiting the
// 9 neighbour cells in the same order with per-offset partial sums added in
// offset order. No Newton halving, no reaction outputs, no atomics: the
// result is deterministic. The TPU's lane rolls, block-crossing row patches
// and 128-lane padding have no counterpart here.
//
// B1 and B1 halo as launched (cell_force_tile_kernel): particle pairs only.
// One block takes a tile of H cell rows x W columns. It stages the tile's
// (H + 2) x (W + 2) neighbour cells in shared memory, seam offsets added,
// occupied slots only, and counts each staged cell as its number of
// non-sentinel slots: the engines fill a cell's slots from 0 at every
// rebuild, and a halo row across the x seam carries the sentinel -+ box
// (fl32, as the exchange adds it), which is no particle's x either. A
// block-wide prefix sum of the tile's counts lays its occupied targets out
// compactly, cell row by cell row, one thread each (a warp holds the
// targets of about five neighbouring cells of one row). The thread visits
// the 9 offsets in the loop's order (dx, then dy), takes b < count
// ascending within an offset and adds the per-offset partial sums in offset
// order. Its division is the loop's sigma2 / r2 bit for bit without the
// divide's slow-path branch (div_rn_normal, pair_math.cuh). The results go
// through shared memory and out in coalesced rows, empty slots as 0.0f.
// The staging step reads the row before and the row after the local rows
// through their own pointers: the whole-grid form passes its own last and
// first rows with -box / +box on x, the halo form a rank's exchanged edge
// rows (x seam included) with no offset, so no caller copies the halo rows
// next to its local ones. Each staged cell is read (H + 2) / H times over
// the tiles that need it; H, W and the block size: jtps_cell_force_tile.
// Tiles above 48 KB of shared memory take the dynamic opt-in (up to 227 KB
// a block on an H100).
//
// B1's loop (cell_force_kernel, launched by jtps_cell_force_loop and
// jtps_cell_force_halo_loop; no path runs it): one thread per target slot,
// occupied or not, over the 9 neighbour cells x cap partner slots with one
// IEEE divide a pair. With PACKED = false, R is the constant 1 and the
// index arithmetic is B1's; the PACKED = true form is not launched. The
// loop stays as it is: it is the tile kernel's and B3's bit-exact and
// timing yardstick. Its halo form takes x and y as (n_rows + 2, cap, cps),
// the halo rows attached.
//
// B1 halo: one rank's n_rows cell rows, with the previous rank's last row
// before them and the next rank's first row after them; the outputs are
// (n_rows, cap, cps), the local rows only. The caller has already put the x
// seam into the halo rows (-box on the first rank's previous row, +box on
// the last rank's next row), so the kernel neither wraps nor offsets rows;
// the column (y) seam is handled as in B1. With no Newton halving there are
// no reaction rows to send back. A slot visits its 9 cells in B1's order
// with the same float32 operations (fl(x + box) made by the caller is the
// fl(x + box) B1 makes), so the halo form over P row blocks is bit-equal
// to B1 on the whole grid.
//
// B3 (cell_force_counted_kernel): visits particle pairs only. It takes a
// (cps, cps) int32 grid of per-cell counts, which the engine makes once per
// rebuild: after a rebuild a cell's particles fill slots 0 .. count-1 and
// no particle changes slot until the next one. One block takes a strip of
// W cells of one cell row. It stages the strip's three neighbour rows
// (W + 2 columns, seam offsets added, occupied slots only) and their counts
// in shared memory, lays its occupied targets out compactly by a prefix sum
// of the strip's counts, and gives each thread one occupied target. The
// thread loops over b < count of each neighbour cell, with the loop's IEEE
// divide. The results go through shared memory so that the block writes
// its strip's slots in coalesced rows, empty slots as 0.0f.
//
// B3's list form (the same symbol, cell_force_counted_kernel<false>, with
// a list pointer) and its build, cell_list_build_kernel, replace no TPU
// kernel: the JAX package has no neighbour list on the grid path. A
// binning lasts ~27 steps at N=1M (4-step windows at gate 0.40), and the
// window's skin/2 flag keeps every particle within skin/2 of its binned
// place meanwhile, so the pairs that can come inside the cutoff before the
// next binning are those within cutoff + skin at the binning. At rho 0.8 on
// 385 cells a side (cell side 2.904) a target has ~61 staged candidates,
// ~20 partners within 2.9125 and ~16 inside the cutoff; the build stages
// the strip as B3 does and writes each target's partners within the list
// radius (List2 below), and the list form walks that list, reading the
// partners' coordinates (which change every step) from the planes. A
// target with more partners than the list's capacity runs the counted
// loop.
//
// Periodic seams: positions are not wrapped between rebuilds, so a particle
// may sit up to skin/2 outside [0, box). The seam is handled per neighbour
// offset, as the TPU kernels do: a partner whose cell row (column) wraps
// gets +-box on x (y). There is no per-pair minimum image: it would map the
// x sentinel 2.5*box back into the box and create phantom forces.
//
// What bounds them on an H100. B1's loop: at N=100k the grid is 121 x 16 x
// 121 = 234k slots and each thread evaluates 9 * 16 = 144 partners, each
// with two L2 loads and one IEEE division (33.7M evaluations for about 6.2M
// particle pairs, 6.8 particles a cell: more than 80% of the work on empty
// slots). The two coordinate planes (1.9 MB) sit in the 50 MB L2, so memory
// traffic is small; the bound is the pair arithmetic. The tile kernel does
// the particle pairs only, from shared memory, with the divide's latency
// overlapped; what is left is that arithmetic, the spread of the 9 counts
// among a warp's threads (a warp's loop over one neighbour cell runs as
// long as its fullest cell), and at N=100k the launch itself. B3: at N=1M
// (55 x 16 x 2695, about 6.75 particles a cell) the full-capacity loop made
// 341M pair evaluations for 59.7M particle pairs, and 58% of its threads
// were empty targets; B3 leaves the same pair arithmetic on a sixth of the
// work.
//
// Bit-equality: a pair that the full-capacity loop evaluates but the tile
// kernel or B3 skips (an empty partner, or an empty target) adds an exact
// +-0.0f to a partial sum that is never -0.0f, and within an offset both
// keep b ascending, so both are bit-equal to B1's loop slot for slot (B3 on
// the unpacked view).
//
// Built with --fmad=false (see _build.py): every pair term is then the same
// float32 arithmetic, op for op, as the plain PyTorch version's eager ops,
// so the kernels and the plain version differ only in summation order.

#include <cuda_runtime.h>

#include "pair_math.cuh"

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
// the banks; none where the coordinates are not staged, as in the list
// form, which leaves the room to the L1 cache its partner reads go
// through), the results (2, or 4 with the energy, x W x cap), the staged
// counts, the prefix of the targets and each target's cell.
struct StripSmem {
  int W, cap, n_out;
  bool coords = true;
  __host__ __device__ int cells() const { return 3 * (W + 2); }
  __host__ __device__ int stage() const { return coords ? cells() * (cap + 1) : 0; }
  __host__ __device__ int floats() const { return 2 * stage() + n_out * W * cap; }
  __host__ __device__ int bytes() const {
    return 4 * floats() + 4 * (cells() + W + 1) + W * cap;
  }
};

// The partner list of one binning for B3: the list form of
// cell_force_counted_kernel<false> walks it, cell_list_build_kernel writes
// it, both in strips of the same width. A strip's targets (its cells in
// order, slots ascending: the counted kernel's numbering t) are targets
// first[s] + t of the list, s = blockIdx.y * gridDim.x + blockIdx.x the
// strip; the build takes each strip's first target from a counter as its
// block starts, so the strips' ranges are disjoint and hold every target,
// in whatever order the blocks ran. For each target the list holds its
// partners whose distance at the binning is below the list radius, in the
// counted loop's order: the 9 offsets o = (dx + 1) * 3 + (dy + 1)
// ascending, then slot b ascending. Entries are 16 bits, o << 7 | b, four
// to a 64-bit group; the groups lie [group][target] after T counts, so a
// warp's 32 consecutive targets read 256 consecutive bytes a group. A
// partial last group is padded with the target itself (o = 4, b = a): r2 =
// 0 is no valid pair, so it adds an exact +0. counts[g]: the number of
// entries, or kListFull where the target has more than k partners (its
// entries are then incomplete and the force kernel runs the counted loop
// for it). T, a multiple of 4, is the room for targets; a target numbered
// T or above is never listed and runs the counted loop.
struct List2 {
  const unsigned short* words;  // null: the counted loop
  const int* first;             // a strip's first target
  int k, T;
};
constexpr unsigned short kListFull = 0xFFFF;
constexpr int kListSlotBits = 7;   // b (below cap)
constexpr int kListMaxCap = 64;    // the build's bitmask of a cell's slots

// B3's strip: steps 1 to 3 of cell_force_counted_kernel, which the list
// build shares. One block takes W cells of cell row blockIdx.y from column
// blockIdx.x * W.
struct Strip2 {
  float* sx;
  float* sy;
  float* sres;           // n_out planes of (cap, W)
  int* scnt;             // (3, W + 2)
  int* sstart;           // (W + 1)
  unsigned char* tcell;  // each target's cell
  int n_cols, nc, cx, cy0, cps, cap, R, lanes;

  __device__ Strip2(float* smem, const StripSmem& L, int cps_, int cap_, int R_)
      : sx(smem), sy(smem + L.stage()), sres(smem + 2 * L.stage()),
        scnt(reinterpret_cast<int*>(smem + L.floats())), sstart(scnt + L.cells()),
        tcell(reinterpret_cast<unsigned char*>(sstart + L.W + 1)), n_cols(L.W + 2),
        nc(min(L.W, cps_ - static_cast<int>(blockIdx.x) * L.W)), cx(blockIdx.y), cy0(blockIdx.x * L.W),
        cps(cps_), cap(cap_), R(R_), lanes(R_ * cps_) {}

  // slot 0 of cell (row, 0)
  __device__ int row_base(int row) const { return (row / R) * cap * lanes + (row % R) * cps; }

  // 1. counts of the 3 x (nc + 2) staged cells, clamped to [0, cap]
  // 2. warp 0: prefix of the middle row's counts, each target's cell
  // 3. (coords) every thread: the occupied slots of the staged cells, seam
  // offsets added as the full-capacity loop adds them to each partner
  __device__ void load(const float* __restrict__ x, const float* __restrict__ y,
                       const int* __restrict__ counts, float box, bool coords = true) {
    const int tid = threadIdx.x;
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
    // four slots' loads in flight a thread
#pragma unroll 4
    for (int j = tid; coords && j < 3 * cap * n_cols; j += blockDim.x) {
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
  }
};

// the block's strip (List2)
__device__ inline int strip_index() { return blockIdx.y * gridDim.x + blockIdx.x; }

// B3. The list form (force-only; list.words not null): each target walks
// its entries of the binning's partner list instead of every candidate,
// flushing its per-offset partial sum into the total where an entry's
// offset changes. Its pairs are a subset of the counted loop's in the same
// order; every pair it leaves out adds an exact +-0 to a partial sum that
// is never -0 (it lay beyond the list radius at the binning, so beyond the
// cutoff while no particle has moved skin/2), and an offset without
// entries adds +0: the totals are the counted loop's bits. The list form
// stages no coordinates: it reads each listed partner from the planes (19
// MB at N=1M, which the 50 MB L2 holds), a group's four partners loaded
// before any of its pairs, with the seam offset the staging adds, so the
// same float32 values (tests/torch_cell_list2_designs.py: 0.091 ms a call
// at N=1M against 0.112 walking the strip staged in shared memory, whose
// staging and writes alone took 0.059). A target marked full runs the
// counted loop on partners read the same way. Its division is the loop's
// sigma2 / r2 bit for bit without the divide's slow-path branch
// (div_rn_normal), as in the tile kernel.
template <bool WITH_ENERGY>
__global__ void cell_force_counted_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ counts, float* __restrict__ fx,
    float* __restrict__ fy, float* __restrict__ e, float* __restrict__ w,
    int cps, int cap, int rows_per_block, int W, float box, float cutoff2,
    float sigma2, float fscale, float epsilon, float shift, List2 list) {
  extern __shared__ float smem[];
  const bool listed = !WITH_ENERGY && list.words != nullptr;
  const StripSmem L{W, cap, WITH_ENERGY ? 4 : 2, !listed};
  Strip2 S(smem, L, cps, cap, rows_per_block);
  S.load(x, y, counts, box, L.coords);
  const float* sx = S.sx;
  const float* sy = S.sy;
  float* sres = S.sres;
  const int* scnt = S.scnt;
  const int n_cols = S.n_cols, nc = S.nc, cx = S.cx, cy0 = S.cy0, lanes = S.lanes;
  const int tid = threadIdx.x;

  // 4. one thread per occupied target
  const float two_fscale = 2.0f * fscale;
  const float four_eps = 4.0f * epsilon;
  const float wscale = fscale * sigma2;  // 24 * epsilon
  const float r2_lo = sigma2 * 0x1p-46f;  // see div_rn_normal
  const int total = S.sstart[nc];
  const int base_t = S.row_base(cx) + cy0;
  const int g0 = listed ? list.first[strip_index()] : 0;
  // the list form's partner rows: the row bases of dx = -1, 0, 1 and the
  // x seams of the first and last
  const int rb0 = S.row_base(cx == 0 ? cps - 1 : cx - 1), rb1 = S.row_base(cx);
  const int rb2 = S.row_base(cx == cps - 1 ? 0 : cx + 1);
  const float ox0 = cx == 0 ? -box : 0.0f, ox2 = cx == cps - 1 ? box : 0.0f;
  for (int t = tid; t < total; t += blockDim.x) {
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * lanes + c];
    const float yi = y[base_t + a * lanes + c];
    float acc_x = 0.0f, acc_y = 0.0f, acc_e = 0.0f, acc_w = 0.0f;
    if (listed) {
      // the partner columns of dy = -1, 0, 1 and their y seams
      const int cy = cy0 + c;
      const int cm = cy == 0 ? cps - 1 : cy - 1, cq = cy == cps - 1 ? 0 : cy + 1;
      const float oy0 = cy == 0 ? -box : 0.0f, oy2 = cy == cps - 1 ? box : 0.0f;
      // slot b of the cell at offset o, seam offsets added as the staging
      // adds them
      auto partner = [&](int o, int b, float& xs, float& ys) {
        const int r = o / 3, d = o - 3 * r;
        const int src = (r == 0 ? rb0 : r == 1 ? rb1 : rb2) + (d == 0 ? cm : d == 1 ? cy : cq) + b * lanes;
        xs = x[src] + (r == 0 ? ox0 : r == 1 ? 0.0f : ox2);
        ys = y[src] + (d == 0 ? oy0 : d == 1 ? 0.0f : oy2);
      };
      float part_x = 0.0f, part_y = 0.0f;
      // the loop's pair terms, op for op
      auto pair = [&](float xs, float ys) {
        const float ddx = xi - xs;
        const float ddy = yi - ys;
        const float r2 = ddx * ddx + ddy * ddy;
        const bool valid = (r2 > 0.0f) && (r2 < cutoff2);
        const float inv = div_rn_normal(sigma2, fmaxf(r2, r2_lo));
        const float s6 = inv * inv * inv;
        const float fmag = valid ? s6 * inv * (two_fscale * s6 - fscale) : 0.0f;
        part_x += fmag * ddx;
        part_y += fmag * ddy;
      };
      const int g = g0 + t;
      const int n_list = g < list.T ? list.words[g] : kListFull;
      if (n_list != kListFull) {
        // `part` flushes into `acc` where the offset changes (acc + 0.0f is
        // acc: acc is never -0)
        int cur = -1;
        const int n_groups = (n_list + 3) >> 2;
        const unsigned long long* gp = reinterpret_cast<const unsigned long long*>(list.words + list.T) + g;
        unsigned long long next = n_groups > 0 ? gp[0] : 0ull;
        for (int q = 0; q < n_groups; ++q) {
          const unsigned long long grp = next;
          // the next group's load overlaps this group's pairs
          if (q + 1 < n_groups) next = gp[static_cast<long long>(q + 1) * list.T];
          float xs[4], ys[4];
          int os[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned int entry = static_cast<unsigned int>((grp >> (16 * k)) & 0xFFFFu);
            os[k] = static_cast<int>(entry >> kListSlotBits);
            partner(os[k], static_cast<int>(entry & ((1u << kListSlotBits) - 1)), xs[k], ys[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool flush = os[k] != cur;
            cur = os[k];
            acc_x += flush ? part_x : 0.0f;
            acc_y += flush ? part_y : 0.0f;
            part_x = flush ? 0.0f : part_x;
            part_y = flush ? 0.0f : part_y;
            pair(xs[k], ys[k]);
          }
        }
        acc_x += part_x;
        acc_y += part_y;
      } else {
        // a full target: the counted loop, partners from the planes
        for (int o = 0; o < 9; ++o) {
          const int n = scnt[(o / 3) * n_cols + c + o % 3];
          part_x = 0.0f;
          part_y = 0.0f;
          for (int b = 0; b < n; ++b) {
            float xs, ys;
            partner(o, b, xs, ys);
            pair(xs, ys);
          }
          acc_x += part_x;
          acc_y += part_y;
        }
      }
    } else {
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

// The partner list of one binning (List2 above): B3's steps 1 to 3, the
// strip's first target from the counter sync[2] (first[s]), then each
// target tests its 9 x count staged candidates in the counted loop's
// order with the pair terms' own float32 r2 and keeps those with
// !(r2 >= rlist2) (a NaN distance is kept, as the counted loop would add
// its NaN), itself excepted; a pair of two particles on one spot is kept.
// The first k entries are written, four at a time; a target with more is
// marked kListFull and counted. *full_out = *full_in + the targets marked
// full: each block adds its count to sync[0], and the last block to finish
// (sync[1], a counter that atomicInc wraps back to 0) writes the sum and
// clears sync[0] and sync[2], so the three words are 0 before and after a
// launch.
__global__ void cell_list_build_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                       const int* __restrict__ counts, int cps, int cap,
                                       int rows_per_block, int W, float box, float rlist2,
                                       unsigned short* __restrict__ words, int* __restrict__ first,
                                       int k, int T, const int* __restrict__ full_in,
                                       int* __restrict__ full_out, unsigned int* __restrict__ sync) {
  extern __shared__ float smem[];
  const StripSmem L{W, cap, 2};
  Strip2 S(smem, L, cps, cap, rows_per_block);
  // the block's count of full targets and its first target, in the
  // results' room, which the build does not use
  int& sfull = *reinterpret_cast<int*>(S.sres);
  int& sfirst = *(reinterpret_cast<int*>(S.sres) + 1);
  if (threadIdx.x == 0) sfull = 0;
  S.load(x, y, counts, box);
  const int n_cols = S.n_cols;
  const int total = S.sstart[S.nc];
  if (threadIdx.x == 0) {
    sfirst = static_cast<int>(atomicAdd(&sync[2], static_cast<unsigned int>(total)));
    first[strip_index()] = sfirst;
  }
  __syncthreads();
  const int base_t = S.row_base(S.cx) + S.cy0;
  const int g0 = sfirst;
  unsigned long long* groups = reinterpret_cast<unsigned long long*>(words + T);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int g = g0 + t;
    if (g >= T) continue;  // no room: the force kernel runs the counted loop
    const int c = S.tcell[t];
    const int a = t - S.sstart[c];
    const float xi = x[base_t + a * S.lanes + c];
    const float yi = y[base_t + a * S.lanes + c];
    // each offset's kept partners first as a bitmask, without a branch,
    // then its entries from the set bits, ascending, into the top of a
    // four-entry queue; every fourth entry stores the queue, which then
    // holds entries n - 4 to n - 1 in order
    int n = 0;
    unsigned long long buf = 0;
    for (int o = 0; o < 9; ++o) {
      const int cell = (o / 3) * n_cols + c + o % 3;
      const int cnt = S.scnt[cell];
      const int base = cell * (cap + 1);
      unsigned long long bits = 0;
#pragma unroll 4
      for (int b = 0; b < cnt; ++b) {
        const float ddx = xi - S.sx[base + b];
        const float ddy = yi - S.sy[base + b];
        const float r2 = ddx * ddx + ddy * ddy;
        bits |= static_cast<unsigned long long>(r2 >= rlist2 ? 0 : 1) << b;
      }
      if (o == 4) bits &= ~(1ull << a);  // the target itself
      const unsigned long long off = static_cast<unsigned long long>(o << kListSlotBits) << 48;
      while (bits) {
        const int b = __ffsll(static_cast<long long>(bits)) - 1;
        bits &= bits - 1;
        buf = (buf >> 16) | off | (static_cast<unsigned long long>(b) << 48);
        ++n;
        if ((n & 3) == 0 && n <= k) groups[static_cast<long long>((n >> 2) - 1) * T + g] = buf;
      }
    }
    if (n <= k && (n & 3) != 0) {
      const unsigned long long pad = static_cast<unsigned long long>((4 << kListSlotBits) | a) << 48;
      for (int q = n & 3; q < 4; ++q) buf = (buf >> 16) | pad;
      groups[static_cast<long long>(n >> 2) * T + g] = buf;
    }
    if (n > k) atomicAdd(&sfull, 1);
    words[g] = n <= k ? static_cast<unsigned short>(n) : kListFull;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sfull) atomicAdd(&sync[0], static_cast<unsigned int>(sfull));
    __threadfence();
    const unsigned int n_blocks = gridDim.x * gridDim.y;
    if (atomicInc(&sync[1], n_blocks - 1) == n_blocks - 1) {
      // the last block: every other block's count came before its own
      *full_out = *full_in + static_cast<int>(atomicExch(&sync[0], 0u));
      atomicExch(&sync[2], 0u);
    }
  }
}

// B3's strip: 32 cells; narrower where that leaves fewer than two blocks an
// SM (N=16,384: 49 rows of 49 cells) or needs more than 48 KB. Returns 0
// where not even one cell fits.
int packed_strip(int cps, int cap, int n_out, int n_sm) {
  int W = 32;
  while (W > 4 && static_cast<long long>(cps) * ((cps + W - 1) / W) < 2LL * n_sm) W /= 2;
  while (W > 1 && StripSmem{W, cap, n_out}.bytes() > 48 * 1024) W /= 2;
  return StripSmem{W, cap, n_out}.bytes() > 48 * 1024 ? 0 : W;
}

// about 6.75 targets a cell
inline int packed_threads(int W) { return W >= 4 ? 8 * W : 32; }

// B3 and its list form (list.words not null, force-only; strip: the
// list's, which must be the strip this launch takes) on `stream`.
int launch_packed(const float* x, const float* y, const int* counts, float* fx, float* fy, float* e,
                  float* w, int cps, int cap, int rows_per_block, float box, float cutoff2,
                  float sigma2, float fscale, float epsilon, float shift, int with_energy,
                  const List2& list, int device, void* stream, int strip = 0) {
  if (rows_per_block < 1 || cps % rows_per_block != 0 || cps < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = with_energy ? 4 : 2;
  const int W = packed_strip(cps, cap, n_out, n_sm);
  // the list form walks a list built in strips of `strip` cells
  if (W == 0 || (strip != 0 && strip != W)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = StripSmem{W, cap, n_out, list.words == nullptr || with_energy}.bytes();
  const dim3 grid((cps + W - 1) / W, cps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    cell_force_counted_kernel<true><<<grid, packed_threads(W), smem, s>>>(
        x, y, counts, fx, fy, e, w, cps, cap, rows_per_block, W, box, cutoff2,
        sigma2, fscale, epsilon, shift, List2{nullptr, nullptr, 0, 0});
  } else {
    cell_force_counted_kernel<false><<<grid, packed_threads(W), smem, s>>>(
        x, y, counts, fx, fy, e, w, cps, cap, rows_per_block, W, box, cutoff2,
        sigma2, fscale, epsilon, shift, list);
  }
  return static_cast<int>(cudaGetLastError());
}

// The partner list's checks, shared by its build and its force call: a
// layout B3 takes, a capacity the build's bitmask and the slot field hold,
// k a positive multiple of 4 below kListFull, T a positive multiple of 4.
bool list2_args_ok(int cps, int cap, int rows_per_block, int k, int T) {
  return rows_per_block >= 1 && cps >= 1 && cps % rows_per_block == 0 && cap >= 1 && cap <= kListMaxCap &&
         k > 0 && k % 4 == 0 && k < kListFull && T > 0 && T % 4 == 0;
}

// The tile kernel's parameters: n_rows output cell rows of cps cells; the x
// seam added to the row before the local rows (off_prev) and to the row
// after them (off_next): -box and +box on the whole grid, 0 in the halo
// form, whose edge rows carry it already.
struct TileParams {
  int n_rows, cps, cap;
  float box, sentinel, cutoff2, sigma2, fscale, epsilon, shift;
  float off_prev, off_next;
};

// One coordinate's rows: the row before the local rows, the first local
// row (n_rows of them follow), the row after them; each row (cap, cps).
struct Rows {
  const float* prev;
  const float* local;
  const float* next;
};

// The tile kernel's shared memory for H x W target cells: the staged x and
// y of (H + 2) x (W + 2) cells x (cap + 1) slots (the extra slot spreads
// the cells over the banks), the results (2, or 4 with the energy, x H x
// cap x W), the staged counts, the prefix of the targets, one partial sum a
// warp for the prefix, and each target's cell.
struct TileSmem {
  int H, W, cap, n_out;
  __host__ __device__ int cells() const { return (H + 2) * (W + 2); }
  __host__ __device__ int stage() const { return cells() * (cap + 1); }
  __host__ __device__ int results() const { return n_out * H * cap * W; }
  __host__ __device__ int bytes() const {
    return 4 * (2 * stage() + results() + cells() + H * W + 1 + 32) + 2 * H * W * cap;
  }
};

// about half a cell's slots a target cell (6.8 particles a cell at cap 16
// on the engines' grids), at least one thread a cell and two warps
__host__ __device__ inline int tile_threads(int H, int W, int cap) {
  const int n = max(H * W, H * W * cap / 2);
  return min(1024, max(64, (n + 31) / 32 * 32));
}

// B1 and B1 halo as launched: the function cell_force_kernel computes, over
// particle pairs only. One block takes the tile of cell rows blockIdx.y * H
// and columns blockIdx.x * W; blockDim.x is a multiple of 32, at least H * W
// and at most 1024.
template <bool WITH_ENERGY>
__global__ void cell_force_tile_kernel(Rows xr, Rows yr, float* __restrict__ fx,
                                       float* __restrict__ fy, float* __restrict__ e,
                                       float* __restrict__ w, TileParams p, int H, int W) {
  extern __shared__ float smem[];
  const TileSmem L{H, W, p.cap, WITH_ENERGY ? 4 : 2};
  const int cap = p.cap, cps = p.cps;
  const int n_cols = W + 2;
  const int plane = H * cap * W;  // one result grid of the tile
  float* sx = smem;
  float* sy = sx + L.stage();
  float* sres = sy + L.stage();                            // n_out planes of (H, cap, W)
  int* scnt = reinterpret_cast<int*>(sres + L.results());  // (H + 2, W + 2)
  int* sstart = scnt + L.cells();                          // (H * W + 1)
  int* swarp = sstart + H * W + 1;                         // (32)
  unsigned short* tcell = reinterpret_cast<unsigned short*>(swarp + 32);

  const int row = cap * cps;  // floats in one cell row
  const int cx0 = blockIdx.y * H;
  const int cy0 = blockIdx.x * W;
  const int nr = min(H, p.n_rows - cx0);  // target rows in this tile
  const int nc = min(W, cps - cy0);       // target columns
  const int tid = threadIdx.x;

  for (int j = tid; j < L.cells(); j += blockDim.x) scnt[j] = 0;
  __syncthreads();

  // 1. the occupied slots of the (nr + 2) x (nc + 2) staged cells, seam
  // offsets added as the loop adds them to each partner; a cell's count is
  // its number of non-sentinel slots
  const float sent_lo = p.sentinel - p.box;
  const float sent_hi = p.sentinel + p.box;
  const int n_stage = (nr + 2) * cap * n_cols;
#pragma unroll 4
  for (int j = tid; j < n_stage; j += blockDim.x) {
    const int col = j % n_cols;
    const int b = (j / n_cols) % cap;
    const int r = j / (n_cols * cap);
    if (col >= nc + 2) continue;
    const int g = cx0 + r - 1;  // local cell row: -1 and n_rows are the edge rows
    const float* xs_row;
    const float* ys_row;
    float off_x;
    if (g < 0) {
      xs_row = xr.prev;
      ys_row = yr.prev;
      off_x = p.off_prev;
    } else if (g >= p.n_rows) {
      xs_row = xr.next;
      ys_row = yr.next;
      off_x = p.off_next;
    } else {
      xs_row = xr.local + g * row;
      ys_row = yr.local + g * row;
      off_x = 0.0f;
    }
    float off_y;
    const int src = b * cps + wrap_cell(cy0 + col - 1, cps, p.box, &off_y);
    const float xs = xs_row[src];
    if (xs == p.sentinel || xs == sent_lo || xs == sent_hi) continue;
    const int cell = r * n_cols + col;
    const int dst = cell * (cap + 1) + b;
    sx[dst] = xs + off_x;
    sy[dst] = ys_row[src] + off_y;
    atomicAdd(&scnt[cell], 1);
  }
  __syncthreads();

  // 2. prefix of the target cells' counts, in (tile row, column) order:
  // each warp scans 32 cells, warp 0 scans the warps' sums
  const int lane = tid & 31, warp = tid >> 5;
  int v = 0;
  if (tid < H * W && tid / W < nr && tid % W < nc) v = scnt[(tid / W + 1) * n_cols + tid % W + 1];
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) swarp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < (blockDim.x >> 5) ? swarp[lane] : 0;
    int sum = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, sum, d);
      if (lane >= d) sum += t;
    }
    swarp[lane] = sum - own;  // the warps before this one
  }
  __syncthreads();
  if (tid < H * W) {
    const int end = incl + swarp[warp];
    if (tid == 0) sstart[0] = 0;
    sstart[tid + 1] = end;
    for (int a = end - v; a < end; ++a) tcell[a] = static_cast<unsigned short>(tid);
  }
  __syncthreads();

  // 3. one thread per occupied target
  const float two_fscale = 2.0f * p.fscale;
  const float four_eps = 4.0f * p.epsilon;
  const float wscale = p.fscale * p.sigma2;  // 24 * epsilon
  const float r2_lo = p.sigma2 * 0x1p-46f;   // see div_rn_normal
  const int total = sstart[H * W];
  for (int t = tid; t < total; t += blockDim.x) {
    const int tc = tcell[t];
    const int a = t - sstart[tc];
    const int tr = tc / W, c = tc - tr * W;
    const int src = (cx0 + tr) * row + a * cps + cy0 + c;
    const float xi = xr.local[src];
    const float yi = yr.local[src];
    float acc_x = 0.0f, acc_y = 0.0f, acc_e = 0.0f, acc_w = 0.0f;
    // the 9 offsets in the loop's order: dx, then dy
    for (int dr = 0; dr < 3; ++dr) {
      for (int dc = 0; dc < 3; ++dc) {
        const int cell = (tr + dr) * n_cols + c + dc;
        const int n = scnt[cell];
        const float* xp = sx + cell * (cap + 1);
        const float* yp = sy + cell * (cap + 1);
        float part_x = 0.0f, part_y = 0.0f, part_e = 0.0f, part_w = 0.0f;
#pragma unroll 4
        for (int b = 0; b < n; ++b) {
          // cell_force_kernel's pair terms, op for op
          const float ddx = xi - xp[b];
          const float ddy = yi - yp[b];
          const float r2 = ddx * ddx + ddy * ddy;
          const bool valid = (r2 > 0.0f) && (r2 < p.cutoff2);
          // the loop's sigma2 / r2, bit for bit where it matters
          const float inv = div_rn_normal(p.sigma2, fmaxf(r2, r2_lo));
          const float s6 = inv * inv * inv;
          if (WITH_ENERGY) {
            const float s12 = s6 * s6;
            const float fmag = valid ? (2.0f * s12 - s6) * inv * p.fscale : 0.0f;
            part_x += fmag * ddx;
            part_y += fmag * ddy;
            part_e += valid ? four_eps * (s12 - s6) - p.shift : 0.0f;
            part_w += valid ? (2.0f * s12 - s6) * wscale : 0.0f;
          } else {
            const float fmag = valid ? s6 * inv * (two_fscale * s6 - p.fscale) : 0.0f;
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
    const int o = (tr * cap + a) * W + c;
    sres[o] = acc_x;
    sres[plane + o] = acc_y;
    if (WITH_ENERGY) {
      sres[2 * plane + o] = acc_e;
      sres[3 * plane + o] = acc_w;
    }
  }
  __syncthreads();

  // 4. the tile's slots, all cap of them, in rows of nc consecutive cells;
  // empty ones 0.0f, what the loop sums for them
  for (int j = tid; j < nr * cap * nc; j += blockDim.x) {
    const int c = j % nc;
    const int a = (j / nc) % cap;
    const int tr = j / (nc * cap);
    const bool occ = a < scnt[(tr + 1) * n_cols + c + 1];
    const int o = occ ? (tr * cap + a) * W + c : 0;
    const int dst = (cx0 + tr) * row + a * cps + cy0 + c;
    fx[dst] = occ ? sres[o] : 0.0f;
    fy[dst] = occ ? sres[plane + o] : 0.0f;
    if (WITH_ENERGY) {
      e[dst] = occ ? sres[2 * plane + o] : 0.0f;
      w[dst] = occ ? sres[3 * plane + o] : 0.0f;
    }
  }
}

// Lets the tile kernel take more than the default 48 KB of dynamic shared
// memory, once for each device; returns the device's limit.
template <bool WITH_ENERGY>
cudaError_t tile_opt_in(int device, int* limit) {
  static bool done[64] = {};
  cudaError_t err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  if (!done[device]) {
    err = cudaFuncSetAttribute(cell_force_tile_kernel<WITH_ENERGY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

// ceil(n / ceil(n / target)): the widest of the near-equal parts of n that
// are at most target wide
inline int balanced(int n, int target) {
  const int k = (n + target - 1) / target;
  return (n + k - 1) / k;
}

// The default tile: W the balanced width of at most TILE_W columns, H the
// balanced height of at most TILE_H rows, made lower while its blocks are
// not all resident on the card at once (the occupancy calculator, with
// this kernel's registers and shared memory) or its shared memory exceeds
// the device's limit.
constexpr int TILE_H = 4;
constexpr int TILE_W = 32;

template <bool WITH_ENERGY>
cudaError_t pick_tile(int n_rows, int cps, int cap, int device, int* H, int* W) {
  int limit = 0, n_sm = 0;
  cudaError_t err = tile_opt_in<WITH_ENERGY>(device, &limit);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_out = WITH_ENERGY ? 4 : 2;
  const int w = balanced(cps, TILE_W);
  for (int target = TILE_H; target >= 1; --target) {
    const int h = balanced(n_rows, target);
    const int smem = TileSmem{h, w, cap, n_out}.bytes();
    if (smem > limit) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cell_force_tile_kernel<WITH_ENERGY>, tile_threads(h, w, cap), smem);
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>((n_rows + h - 1) / h) * ((cps + w - 1) / w);
    if (target == 1 || static_cast<long long>(per_sm) * n_sm >= blocks) {
      *H = h;
      *W = w;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <bool WITH_ENERGY>
cudaError_t launch_tile_variant(Rows xr, Rows yr, float* fx, float* fy, float* e, float* w,
                                const TileParams& p, int H, int W, int device, cudaStream_t s) {
  int limit = 0;
  cudaError_t err = tile_opt_in<WITH_ENERGY>(device, &limit);
  if (err != cudaSuccess) return err;
  if (H == 0 && W == 0) {
    err = pick_tile<WITH_ENERGY>(p.n_rows, p.cps, p.cap, device, &H, &W);
    if (err != cudaSuccess) return err;
  }
  if (H < 1 || W < 1 || H > p.n_rows || W > p.cps || H * W > 1024 || H * W * p.cap > 65536)
    return cudaErrorInvalidValue;
  const int smem = TileSmem{H, W, p.cap, WITH_ENERGY ? 4 : 2}.bytes();
  if (smem > limit) return cudaErrorInvalidValue;
  const dim3 grid((p.cps + W - 1) / W, (p.n_rows + H - 1) / H);
  cell_force_tile_kernel<WITH_ENERGY><<<grid, tile_threads(H, W, p.cap), smem, s>>>(
      xr, yr, fx, fy, e, w, p, H, W);
  return cudaGetLastError();
}

int launch_tile(Rows xr, Rows yr, float* fx, float* fy, float* e, float* w, int n_rows, int cps,
                int cap, float box, float sentinel, float cutoff2, float sigma2, float fscale,
                float epsilon, float shift, int halo, int with_energy, int tile_h, int tile_w,
                int device, void* stream) {
  if (n_rows < 1 || cps < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // +0.0f in the halo form, as the loop adds it (-0.0f would keep a -0.0f x)
  const float off_prev = halo ? 0.0f : -box, off_next = halo ? 0.0f : box;
  const TileParams p{n_rows, cps, cap, box, sentinel, cutoff2, sigma2, fscale, epsilon, shift,
                     off_prev, off_next};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = with_energy ? launch_tile_variant<true>(xr, yr, fx, fy, e, w, p, tile_h, tile_w, device, s)
                    : launch_tile_variant<false>(xr, yr, fx, fy, e, w, p, tile_h, tile_w, device, s);
  return static_cast<int>(err);
}

}  // namespace

// B1 (the tile kernel): launches it on `stream` (a cudaStream_t passed as a
// pointer) and returns cudaGetLastError(). x and y are (cps, cap, cps); e
// and w are ignored unless with_energy != 0. sentinel is the x of an empty
// slot; a cell's particles must fill its slots from 0. tile_h x tile_w is
// the tile of target cells a block takes (both 0: jtps_cell_force_tile's).
extern "C" int jtps_cell_force(const float* x, const float* y, float* fx, float* fy, float* e,
                               float* w, int cps, int cap, float box, float sentinel,
                               float cutoff2, float sigma2, float fscale, float epsilon,
                               float shift, int with_energy, int tile_h, int tile_w, int device,
                               void* stream) {
  const long long row = static_cast<long long>(cap) * cps;
  const Rows xr{x + (cps - 1) * row, x, x};
  const Rows yr{y + (cps - 1) * row, y, y};
  return launch_tile(xr, yr, fx, fy, e, w, cps, cps, cap, box, sentinel, cutoff2, sigma2, fscale,
                     epsilon, shift, 0, with_energy, tile_h, tile_w, device, stream);
}

// B1 halo (the tile kernel): x and y are one rank's (n_rows, cap, cps) rows,
// x_prev / y_prev the previous rank's last row and x_next / y_next the next
// rank's first row, (cap, cps) each, x seam included; fx, fy, e and w are
// (n_rows, cap, cps). Otherwise as jtps_cell_force.
extern "C" int jtps_cell_force_halo(const float* x_prev, const float* x, const float* x_next,
                                    const float* y_prev, const float* y, const float* y_next,
                                    float* fx, float* fy, float* e, float* w, int n_rows, int cps,
                                    int cap, float box, float sentinel, float cutoff2,
                                    float sigma2, float fscale, float epsilon, float shift,
                                    int with_energy, int tile_h, int tile_w, int device,
                                    void* stream) {
  return launch_tile(Rows{x_prev, x, x_next}, Rows{y_prev, y, y_next}, fx, fy, e, w, n_rows, cps,
                     cap, box, sentinel, cutoff2, sigma2, fscale, epsilon, shift, 1, with_energy,
                     tile_h, tile_w, device, stream);
}

// The tile (*tile_h cell rows x *tile_w columns) and threads a block that
// the tile kernel takes by default on n_rows x cps cells of cap slots.
extern "C" int jtps_cell_force_tile(int n_rows, int cps, int cap, int with_energy, int device,
                                    int* tile_h, int* tile_w, int* threads) {
  if (n_rows < 1 || cps < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = with_energy ? pick_tile<true>(n_rows, cps, cap, device, tile_h, tile_w)
                    : pick_tile<false>(n_rows, cps, cap, device, tile_h, tile_w);
  if (err == cudaSuccess) *threads = tile_threads(*tile_h, *tile_w, cap);
  return static_cast<int>(err);
}

// B1's loop: launches cell_force_kernel on the whole (cps, cap, cps) grid.
extern "C" int jtps_cell_force_loop(const float* x, const float* y, float* fx, float* fy,
                                    float* e, float* w, int cps, int cap, float box,
                                    float cutoff2, float sigma2, float fscale, float epsilon,
                                    float shift, int with_energy, int device, void* stream) {
  return launch<false>(x, y, fx, fy, e, w, cps, cap, 1, cps, 0, box, cutoff2,
                       sigma2, fscale, epsilon, shift, with_energy, device,
                       stream);
}

// B1 halo's loop: x and y are (n_rows + 2, cap, cps) with the halo rows
// attached (seam offsets included), fx, fy, e and w are (n_rows, cap, cps).
extern "C" int jtps_cell_force_halo_loop(const float* x, const float* y, float* fx, float* fy,
                                         float* e, float* w, int n_rows, int cps, int cap,
                                         float box, float cutoff2, float sigma2, float fscale,
                                         float epsilon, float shift, int with_energy, int device,
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
  return launch_packed(x, y, counts, fx, fy, e, w, cps, cap, rows_per_block, box, cutoff2, sigma2,
                       fscale, epsilon, shift, with_energy, List2{nullptr, nullptr, 0, 0}, device,
                       stream);
}

// B3's list form, force-only: cell_force_counted_kernel<false> walking the
// partner list (List2) that jtps_cell_list_build wrote on this binning in
// strips of `strip` cells (jtps_cell_force_packed_strip), `words` its T *
// (k + 1) 16-bit words (8-byte aligned), `first` its strips' first
// targets. Other arguments as jtps_cell_force_packed.
extern "C" int jtps_cell_force_packed_listed(const float* x, const float* y, const int* counts,
                                             float* fx, float* fy, int cps, int cap,
                                             int rows_per_block, float box, float cutoff2,
                                             float sigma2, float fscale, float epsilon, float shift,
                                             const unsigned short* words, const int* first, int k,
                                             int T, int strip, int device, void* stream) {
  if (!list2_args_ok(cps, cap, rows_per_block, k, T) || words == nullptr || first == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_packed(x, y, counts, fx, fy, nullptr, nullptr, cps, cap, rows_per_block, box,
                       cutoff2, sigma2, fscale, epsilon, shift, 0, List2{words, first, k, T}, device,
                       stream, strip);
}

// The strip B3 takes (*strip cells) on cps x cps cells of cap slots, in
// its force-only variant and list form and in the list's build
// (packed_strip).
extern "C" int jtps_cell_force_packed_strip(int cps, int cap, int device, int* strip) {
  if (cps < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *strip = packed_strip(cps, cap, 2, n_sm);
  return *strip > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The partner list of the binning the grids hold (cell_list_build_kernel),
// in strips of `strip` cells, which must be jtps_cell_force_packed_strip's:
// k entries a target, room for T targets, partners with !(r2 >= rlist2).
// `words` holds T * (k + 1) 16-bit words (List2), 8-byte aligned; `first`
// is written with each strip's first target (cps * ceil(cps / strip)
// words). *full_out = *full_in + the targets marked full; sync is three
// device words that are 0, and are left 0. Returns cudaGetLastError().
extern "C" int jtps_cell_list_build(const float* x, const float* y, const int* counts, int cps,
                                    int cap, int rows_per_block, float box, float rlist2,
                                    unsigned short* words, int* first, int k, int T, int strip,
                                    const int* full_in, int* full_out, unsigned int* sync,
                                    int device, void* stream) {
  if (!list2_args_ok(cps, cap, rows_per_block, k, T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = packed_strip(cps, cap, 2, n_sm);
  if (W == 0 || W != strip) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cps + W - 1) / W, cps);
  cell_list_build_kernel<<<grid, packed_threads(W), StripSmem{W, cap, 2}.bytes(),
                           static_cast<cudaStream_t>(stream)>>>(
      x, y, counts, cps, cap, rows_per_block, W, box, rlist2, words, first, k, T, full_in, full_out,
      sync);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jtps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
