// The rebuild's allocation over the 3^D migration classes (2D and 3D grid
// engines, A1), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's allocation is jnp code that
// XLA fuses (ops/kernels/grid_md.py:253 _migration_dest, grid_md3.py:308
// _migration_dest3). The port ran it as eager PyTorch
// (alloc_cuda.allocation_reference): (3^D, rows, cap, plane) class masks,
// a cumsum along the slot axis, two gathers and a masked sum, ~100 launches
// a 3D rebuild and 505-MB int32 class tensors at in.lj's 4.67M slots.
//
// The grid is (G, cap, R * plane) with plane = cps^(D-1) cells a cell row
// and R rows a block (R > 1 only in 2D's packed layout): cell c = row *
// plane + col (row-major over the unpacked (rows, plane) view) is lane
// c % (R * plane) of block row c / (R * plane), and its slot a lies at
// ((c / lanes) * cap + a) * lanes + c % lanes. Every pass reads and writes
// the grids in that layout. Class j = sum_k (d_k + 1) 3^(D-1-k) is the
// migration direction d (itertools.product's order), 13 (2D: 4) the stayers.
//
//   K1 alloc_classes_kernel, a thread a source cell, over its slots in
//      order: wraps each coordinate (written to the D wrapped planes for
//      every slot), finds an occupied slot's cell and direction (a far
//      mover, a direction outside {-1, 0, 1} on some axis, stays in the
//      stayers' class and raises the flag), and writes the slot's word
//      rank << 5 | class, rank its exclusive rank within its class in its
//      cell (the thread's running count of that class, in shared memory),
//      or -1 for an empty slot; then the cell's 3^D class counts, a
//      (3^D, rows, plane) int32 array.
//   The caller extends the counts by one row at each end
//   (GridEngine._row_ext: the periodic neighbours, or the neighbour ranks'
//   rows in the row-sharded engines, whose row0 offsets the row index).
//   K2 alloc_bases_kernel, a thread a target cell T: over the classes in
//      order, the exclusive prefix of counts_ext[j, T - d_j] (the movers of
//      class j that arrive from their one source cell), written as the
//      (3^D, rows, plane) bases; the clamped total, the count grid; the new
//      occupancy (1 below the total, 0 above) in the grid's layout; and the
//      state's overflow folded into the flag (K1 has ended, K3 not begun).
//   The caller extends the bases likewise.
//   K3 alloc_codes_kernel, a thread a slot: an occupied slot's target slot
//      bases_ext[j, S + d_j] + rank, its code j * cap + target in place of
//      its word, or -1 and the flag where the target cell is full.
//
// The outputs are those of the eager allocation, bit for bit: the floating
// point steps (the wrap, the cell index) are PyTorch's own arithmetic
// (alloc_math.cuh), and the rest is integer work that places the classes
// in the same order, so every code, count and occupancy is the same integer.
//
// What bounds it on an H100: bytes. At in.lj (46 cells a side, cap 48,
// 4.67M slots, 27 classes) K1 reads 4 planes and writes 4 (149 MB) and
// 10.5 MB of counts; K2 reads the counts (from L2 for the most part) and
// writes the bases, the occupancy and the count grid (30 MB); K3 reads the
// words and the bases and writes the codes (48 MB): ~240 MB, ~70 us at
// 3.35 TB/s. The least an allocation can move, the D + 1 planes in and the
// D wrapped planes, codes, occupancy and counts out, is ~178 MB (53 us);
// the word plane between K1 and K3 and the bases are the price of the two
// exchanges. Design: a thread walks its cell's slots, which lie a plane
// apart, so a warp's loads and stores are 32 consecutive lanes of one slot
// row (coalesced); it loads four slots' planes before it uses any.

#include <cuda_runtime.h>

#include "alloc_math.cuh"

namespace {

constexpr int kMaxDim = 3;
constexpr int kClassBits = 5;  // alloc_cuda.CLASS_BITS: the class in a word's low bits
constexpr int kClassThreads = 128;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Planes {
  const float* p[kMaxDim];
};

struct OutPlanes {
  float* p[kMaxDim];
};

struct Grid {
  int cap;    // slots a cell
  int lanes;  // cells a block row: R * plane
  int plane;  // cells a cell row: cps^(D-1)
  int rows;   // cell rows held
  int cps;    // cells a side
  int cells;  // rows * plane
};

template <int D>
constexpr int kClasses = D == 3 ? 27 : 9;

// First slot of cell c.
__device__ __forceinline__ int first_slot(const Grid& g, int c) {
  return (c / g.lanes) * g.cap * g.lanes + c % g.lanes;
}

// Direction of class j on axis k, in {-1, 0, 1}.
template <int D>
__device__ __forceinline__ int class_dir(int j, int k) {
  int div = 1;
#pragma unroll
  for (int m = D - 1; m > k; --m) div *= 3;
  return (j / div) % 3 - 1;
}

// Index into an extended (rows + 2, plane) array of the cell at row `row`
// (held rows 0 .. rows - 1), column `col`, moved by s times class j's
// direction: rows through the extension, the plane's axes periodically.
template <int D>
__device__ __forceinline__ int moved_cell(const Grid& g, int row, int col, int j, int s) {
  const int r = row + 1 + s * class_dir<D>(j, 0);
  int c;
  if constexpr (D == 3) {
    const int cy = (col / g.cps + s * class_dir<D>(j, 1) + g.cps) % g.cps;
    const int cz = (col % g.cps + s * class_dir<D>(j, 2) + g.cps) % g.cps;
    c = cy * g.cps + cz;
  } else {
    c = (col + s * class_dir<D>(j, 1) + g.cps) % g.cps;
  }
  return r * g.plane + c;
}

template <int D>
__global__ void __launch_bounds__(kClassThreads)
    alloc_classes_kernel(Planes pos, const float* __restrict__ occ, OutPlanes wrapped, int* __restrict__ word,
                         int* __restrict__ counts, unsigned char* __restrict__ flag, Grid g, int row0, float box,
                         float cell, float inv_cell) {
  constexpr int K = kClasses<D>;
  constexpr int kStay = (K - 1) / 2;
  __shared__ int cnt[K][kClassThreads];  // [class][thread]: a warp's lanes on distinct banks
  const int c = blockIdx.x * kClassThreads + threadIdx.x;
  if (c >= g.cells) return;
#pragma unroll
  for (int j = 0; j < K; ++j) cnt[j][threadIdx.x] = 0;
  const int col = c % g.plane;
  int home[D];
  home[0] = row0 + c / g.plane;
  if constexpr (D == 3) {
    home[1] = col / g.cps;
    home[2] = col % g.cps;
  } else {
    home[1] = col;
  }
  const int first = first_slot(g, c);
  bool far_any = false;
  for (int a0 = 0; a0 < g.cap; a0 += kUnroll) {
    float o[kUnroll], x[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (a0 + u < g.cap) {
        const int i = first + (a0 + u) * g.lanes;
        o[u] = occ[i];
#pragma unroll
        for (int k = 0; k < D; ++k) x[u][k] = pos.p[k][i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (a0 + u >= g.cap) break;
      const int i = first + (a0 + u) * g.lanes;
      int j = 0;
      bool far = false;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float w = alloc_wrap(x[u][k], box);
        wrapped.p[k][i] = w;
        const int d = (alloc_cell_of(w, cell, inv_cell, g.cps) - home[k] + 1 + g.cps) % g.cps - 1;
        far = far || d < -1 || d > 1;
        j = j * 3 + d + 1;
      }
      if (!(o[u] > 0.5f)) {
        word[i] = -1;
        continue;
      }
      if (far) {
        far_any = true;
        j = kStay;
      }
      const int r = cnt[j][threadIdx.x];
      cnt[j][threadIdx.x] = r + 1;
      word[i] = r << kClassBits | j;
    }
  }
  if (far_any) *flag = 1;
#pragma unroll
  for (int j = 0; j < K; ++j) counts[j * g.cells + c] = cnt[j][threadIdx.x];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    alloc_bases_kernel(const int* __restrict__ counts_ext, const unsigned char* __restrict__ overflow_in,
                       unsigned char* __restrict__ flag, int* __restrict__ bases, int* __restrict__ tot_out,
                       float* __restrict__ occ_new, Grid g) {
  constexpr int K = kClasses<D>;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c == 0 && *overflow_in) *flag = 1;
  if (c >= g.cells) return;
  const int row = c / g.plane, col = c % g.plane;
  const int ext = (g.rows + 2) * g.plane;
  int base = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bases[j * g.cells + c] = base;
    base += counts_ext[j * ext + moved_cell<D>(g, row, col, j, -1)];
  }
  const int tot = min(base, g.cap);
  tot_out[c] = tot;
  const int first = first_slot(g, c);
  for (int a = 0; a < g.cap; ++a) occ_new[first + a * g.lanes] = a < tot ? 1.0f : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    alloc_codes_kernel(const int* __restrict__ bases_ext, int* __restrict__ code, unsigned char* __restrict__ flag,
                       Grid g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.cells * g.cap) return;
  const int w = code[i];
  if (w < 0) return;
  const int j = w & ((1 << kClassBits) - 1);
  const int c = (i / (g.cap * g.lanes)) * g.lanes + i % g.lanes;
  const int target = bases_ext[j * (g.rows + 2) * g.plane + moved_cell<D>(g, c / g.plane, c % g.plane, j, 1)] +
                     (w >> kClassBits);
  if (target < g.cap) {
    code[i] = j * g.cap + target;
  } else {
    code[i] = -1;
    *flag = 1;
  }
}

// The grid from the launcher's arguments, or false where they do not
// describe one.
bool make_grid(int dim, int n_blocks, int cap, int lanes, int plane, int cps, Grid* g) {
  if (dim < 2 || dim > kMaxDim || n_blocks < 1 || cap < 1 || cps < 1 || plane != (dim == 3 ? cps * cps : cps) ||
      lanes < plane || lanes % plane != 0)
    return false;
  const long long rows = static_cast<long long>(n_blocks) * (lanes / plane);
  const long long slots = rows * plane * cap;
  if (slots >= (1LL << 31) || 27LL * (rows + 2) * plane >= (1LL << 31) || cap >= (1 << (31 - kClassBits)))
    return false;
  *g = Grid{cap, lanes, plane, static_cast<int>(rows), cps, static_cast<int>(rows * plane)};
  return true;
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// K1: pos and wrapped are kMaxDim plane pointers (null past dim), occ the
// occupancy, all (n_blocks, cap, lanes) float32; word the (n_blocks, cap,
// lanes) int32 words (K3 turns them into codes in place), counts the
// (3^dim, rows, plane) int32 class counts, flag one byte, zeroed here
// first. box and cell are the float32 box and cell width (the Python
// floats rounded); 1 / cell is rounded here, as ATen rounds it.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int jtps_alloc_classes(int dim, const void* const* pos, const float* occ, void* const* wrapped, int* word,
                                  int* counts, unsigned char* flag, int n_blocks, int cap, int lanes, int plane,
                                  int cps, int row0, float box, float cell, int device, void* stream) {
  Grid g;
  if (!make_grid(dim, n_blocks, cap, lanes, plane, cps, &g) || row0 < 0 || row0 + g.rows > cps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(flag, 0, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Planes in{};
  OutPlanes out{};
  for (int k = 0; k < dim; ++k) {
    in.p[k] = static_cast<const float*>(pos[k]);
    out.p[k] = static_cast<float*>(wrapped[k]);
  }
  const float inv_cell = 1.0f / cell;
  const unsigned blocks = blocks_for(g.cells, kClassThreads);
  if (dim == 3)
    alloc_classes_kernel<3><<<blocks, kClassThreads, 0, st>>>(in, occ, out, word, counts, flag, g, row0, box, cell,
                                                              inv_cell);
  else
    alloc_classes_kernel<2><<<blocks, kClassThreads, 0, st>>>(in, occ, out, word, counts, flag, g, row0, box, cell,
                                                              inv_cell);
  return static_cast<int>(cudaGetLastError());
}

// K2: counts_ext the (3^dim, rows + 2, plane) class counts with a row past
// each end; overflow_in the state's overflow (one byte); bases (3^dim,
// rows, plane) and tot (rows, plane) int32, occ_new (n_blocks, cap, lanes)
// float32 out. Launches on `stream` and returns cudaGetLastError().
extern "C" int jtps_alloc_bases(int dim, const int* counts_ext, const unsigned char* overflow_in, unsigned char* flag,
                                int* bases, int* tot, float* occ_new, int n_blocks, int cap, int lanes, int plane,
                                int cps, int device, void* stream) {
  Grid g;
  if (!make_grid(dim, n_blocks, cap, lanes, plane, cps, &g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(g.cells, kThreads);
  if (dim == 3)
    alloc_bases_kernel<3><<<blocks, kThreads, 0, st>>>(counts_ext, overflow_in, flag, bases, tot, occ_new, g);
  else
    alloc_bases_kernel<2><<<blocks, kThreads, 0, st>>>(counts_ext, overflow_in, flag, bases, tot, occ_new, g);
  return static_cast<int>(cudaGetLastError());
}

// K3: bases_ext the (3^dim, rows + 2, plane) bases with a row past each
// end; code the words K1 wrote, turned into codes in place.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int jtps_alloc_codes(int dim, const int* bases_ext, int* code, unsigned char* flag, int n_blocks, int cap,
                                int lanes, int plane, int cps, int device, void* stream) {
  Grid g;
  if (!make_grid(dim, n_blocks, cap, lanes, plane, cps, &g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(static_cast<long long>(g.cells) * g.cap, kThreads);
  if (dim == 3)
    alloc_codes_kernel<3><<<blocks, kThreads, 0, st>>>(bases_ext, code, flag, g);
  else
    alloc_codes_kernel<2><<<blocks, kThreads, 0, st>>>(bases_ext, code, flag, g);
  return static_cast<int>(cudaGetLastError());
}
