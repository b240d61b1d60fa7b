// The BAOAB Langevin window's elementwise updates (2D and 3D grid engines),
// for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the window's updates to
// XLA, which fuses them inside its jitted while_loop. In eager PyTorch the
// same updates (ops/kernels/grid_engine.py, GridEngine._make_window,
// Langevin) were ~30 elementwise launches a 2D Kahan step, each reading and
// writing whole grid planes; this kernel does a step's updates in one pass
// over the planes. The step's noise xi stays a launch of its own
// (csrc/noise.cu), whose (D, n) output this pass reads.
//
// A window of n steps is n step launches and one closing launch, each an
// elementwise pass over the grid's slots (any layout: the planes are flat):
//
//   step (MODE kFirst on the window's first step, kStep after it):
//     kick   kFirst: vh = v + h * f                (the half-kick in)
//            kStep:  vh = vh + dt * f              (the previous step's force)
//     O, A   vp = c1 * vh + c2 * xi
//            inc = h * (vh + vp)                   (the two half-drifts)
//            vh = vp
//            pos, cr = kadd(pos, cr, inc)          (plain: pos = pos + inc)
//            disp = disp + inc
//     max    dmax2 = max(dmax2, |disp|^2), and on the first step also the
//            window's starting |disp|^2
//   close (kClose, once a window, after the last step's force):
//     kick   vh = vh + dt * f
//     unkick v = vh - h * f
//
// with kadd(x, c, inc) = (t, (t - x) - y), y = inc - c, t = x + y; c1 =
// exp(-gamma dt), c2 = sqrt(kT (1 - c1^2)), dt and h = 0.5 * dt the float32
// values PyTorch rounds the window's Python doubles to, and |disp|^2 = (dx *
// dx + dy * dy) (+ dz * dz). The velocity takes no Kahan residual (the OU
// map rescales it). Every operation rounds on its own (__fadd_rn,
// __fmul_rn; the library also builds with --fmad=false), in the order of
// the eager ops, so each output slot is bit-identical to the plain PyTorch
// version, empty slots included (their f, xi, v and disp are 0).
//
// dmax2 is one float32 on the card. Each thread keeps its running max as the
// float's bits, which order as the floats do for the non-negative values a
// sum of squares takes; a NaN maps to 0x7fc00000, above +inf, so a NaN
// anywhere leaves dmax2 NaN (as torch.maximum and torch.max propagate it)
// and trips the gate and the skin flag, ~(dmax2 <= t). A block reduces its
// threads' maxima (warp reductions, then shared memory) and one thread
// takes atomicMax on the scalar; the launcher zeroes the scalar before the
// window's first step on the same stream.
//
// In and out planes are separate pointers: the wrapper (baoab_cuda.py)
// points every field's first write in a window at a new buffer, so nothing
// the window was given is written, and later launches at the same buffer
// (in place: each thread reads its slot before it writes it).
//
// What bounds it on an H100: bytes. A 2D Kahan step reads f, vh, xi, pos,
// cr, disp (12 planes) and writes vh, pos, cr, disp (8): at N=1M's 2.37M
// slots 189.7 MB, 57 us at 3.35 TB/s; the closing launch reads f, vh and
// writes v (6 planes, 17 us). Design, as the NVE pass's (csrc/leapfrog.cu):
// a grid-stride loop over 16-byte vectors (4 slots a thread and plane) where
// every plane is 16-byte aligned and the slot count a multiple of 4, else
// over single slots; every plane of a slot loaded before any is stored (the
// loads of a thread in flight together); 256-thread blocks, one wave of
// them, so a block's one atomic is amortised over several of its strides.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 3;
constexpr unsigned kNanKey = 0x7fc00000u;

enum Mode { kFirst = 0, kStep = 1, kClose = 2 };

// Field order of the launcher's plane array: kMaxDim pointers a field, one
// an axis.
enum Field { kF, kXi, kVIn, kVOut, kPosIn, kPosOut, kCrIn, kCrOut, kDispIn, kDispOut, kFields };

struct Planes {
  const float* p[kFields][kMaxDim];
};

// The step's float32 constants.
struct Coef {
  float c1, c2, dt, h;
};

template <int V>
__device__ __forceinline__ void load(const float* p, long long i, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
    out[0] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(const float* p, long long i, const float (&in)[V]) {
  float* q = const_cast<float*>(p);
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(q)[i] = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    q[i] = in[0];
  }
}

// Kahan-compensated x += inc with residual c, each operation rounded alone.
__device__ __forceinline__ void kadd(float& x, float& c, float inc) {
  const float y = __fsub_rn(inc, c);
  const float t = __fadd_rn(x, y);
  c = __fsub_rn(__fsub_rn(t, x), y);
  x = t;
}

__device__ __forceinline__ unsigned max_key(float s) {
  return s != s ? kNanKey : __float_as_uint(s);
}

template <int D, int V>
__device__ __forceinline__ unsigned sumsq_key(const float (&d)[D][V], int j) {
  float s = __fmul_rn(d[0][j], d[0][j]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = __fadd_rn(s, __fmul_rn(d[k][j], d[k][j]));
  return max_key(s);
}

template <int D, bool COMP, int MODE, int V>
__global__ void __launch_bounds__(kThreads)
    baoab_kernel(Planes pl, long long n_vec, Coef c, unsigned* dmax_bits) {
  constexpr bool kOA = MODE != kClose;
  unsigned m = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n_vec; i += stride) {
    // every load before any store: an out plane may be its in plane, so
    // the compiler could not move a load above an earlier store itself
    float f[D][V], vh[D][V];
    [[maybe_unused]] float xi[D][V], pos[D][V], cr[D][V], disp[D][V];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      load(pl.p[kF][k], i, f[k]);
      load(pl.p[kVIn][k], i, vh[k]);
      if constexpr (kOA) {
        load(pl.p[kXi][k], i, xi[k]);
        load(pl.p[kPosIn][k], i, pos[k]);
        load(pl.p[kDispIn][k], i, disp[k]);
      }
      if constexpr (kOA && COMP) load(pl.p[kCrIn][k], i, cr[k]);
    }
    if constexpr (MODE == kFirst) {
#pragma unroll
      for (int j = 0; j < V; ++j) m = max(m, sumsq_key<D, V>(disp, j));
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (MODE == kFirst) {
          vh[k][j] = __fadd_rn(vh[k][j], __fmul_rn(c.h, f[k][j]));
        } else {
          vh[k][j] = __fadd_rn(vh[k][j], __fmul_rn(c.dt, f[k][j]));
        }
        if constexpr (kOA) {
          const float vp = __fadd_rn(__fmul_rn(c.c1, vh[k][j]), __fmul_rn(c.c2, xi[k][j]));
          const float inc = __fmul_rn(c.h, __fadd_rn(vh[k][j], vp));
          vh[k][j] = vp;
          if constexpr (COMP) {
            kadd(pos[k][j], cr[k][j], inc);
          } else {
            pos[k][j] = __fadd_rn(pos[k][j], inc);
          }
          disp[k][j] = __fadd_rn(disp[k][j], inc);
        } else {
          vh[k][j] = __fsub_rn(vh[k][j], __fmul_rn(c.h, f[k][j]));  // the half-unkick out
        }
      }
    }
    if constexpr (kOA) {
#pragma unroll
      for (int j = 0; j < V; ++j) m = max(m, sumsq_key<D, V>(disp, j));
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      store(pl.p[kVOut][k], i, vh[k]);
      if constexpr (kOA) {
        store(pl.p[kPosOut][k], i, pos[k]);
        store(pl.p[kDispOut][k], i, disp[k]);
      }
      if constexpr (kOA && COMP) store(pl.p[kCrOut][k], i, cr[k]);
    }
  }
  if constexpr (kOA) {
    __shared__ unsigned warp_max[kThreads / 32];
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x == 0 && m) atomicMax(dmax_bits, m);
    }
  }
}

// One wave: as many blocks as the card holds at once (the occupancy
// calculator's count for this instantiation, once a process), each
// striding over the slots.
template <int D, bool COMP, int MODE, int V>
void launch_v(const Planes& pl, long long units, int sms, const Coef& c, unsigned* bits, cudaStream_t stream) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, baoab_kernel<D, COMP, MODE, V>, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  const long long want = (units + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(want < wave ? (want > 0 ? want : 1) : wave);
  baoab_kernel<D, COMP, MODE, V><<<blocks, kThreads, 0, stream>>>(pl, units, c, bits);
}

template <int D, bool COMP, int MODE>
void launch(const Planes& pl, long long n, bool vec, int sms, const Coef& c, unsigned* bits, cudaStream_t stream) {
  if (vec) launch_v<D, COMP, MODE, 4>(pl, n / 4, sms, c, bits, stream);
  else launch_v<D, COMP, MODE, 1>(pl, n, sms, c, bits, stream);
}

template <int D, bool COMP>
void launch_mode(int mode, const Planes& pl, long long n, bool vec, int sms, const Coef& c, unsigned* bits,
                 cudaStream_t stream) {
  if (mode == kFirst) launch<D, COMP, kFirst>(pl, n, vec, sms, c, bits, stream);
  else if (mode == kStep) launch<D, COMP, kStep>(pl, n, vec, sms, c, bits, stream);
  else launch<D, COMP, kClose>(pl, n, vec, sms, c, bits, stream);
}

}  // namespace

// One launch of the Langevin window's updates over n slots: `mode` 0 is the
// first step of a window (it zeroes *dmax2 first), 1 a later step, 2 the
// closing launch; `dim` 2 or 3; `planes` kFields * 3 pointers in the Field
// order (null for absent axes and, without compensation, the residual; a
// mode reads and writes only the fields it updates). c1, c2, dt and h are
// the float32 coefficients, step and half step.
// Runs on `stream` and returns cudaGetLastError().
extern "C" int jtps_baoab(int mode, int dim, int compensated, const void* const* planes, long long n, float c1,
                          float c2, float dt, float h, void* dmax2, int device, void* stream) {
  if (mode < kFirst || mode > kClose || dim < 2 || dim > kMaxDim || n < 0 || (mode != kClose && !dmax2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFirst) {
    err = cudaMemsetAsync(dmax2, 0, sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Planes pl;
  bool vec = n % 4 == 0;
  for (int f = 0; f < kFields; ++f) {
    for (int k = 0; k < kMaxDim; ++k) {
      pl.p[f][k] = static_cast<const float*>(planes[f * kMaxDim + k]);
      vec = vec && reinterpret_cast<unsigned long long>(pl.p[f][k]) % 16 == 0;
    }
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Coef c{c1, c2, dt, h};
  unsigned* bits = static_cast<unsigned*>(dmax2);
  if (dim == 2) {
    if (compensated) launch_mode<2, true>(mode, pl, n, vec, sms, c, bits, st);
    else launch_mode<2, false>(mode, pl, n, vec, sms, c, bits, st);
  } else {
    if (compensated) launch_mode<3, true>(mode, pl, n, vec, sms, c, bits, st);
    else launch_mode<3, false>(mode, pl, n, vec, sms, c, bits, st);
  }
  return static_cast<int>(cudaGetLastError());
}
