// The float32 steps of the rebuild's allocation (csrc/alloc.cu): a
// coordinate's wrap into [0, box] and its cell index, written as PyTorch's
// CUDA kernels compute them for the eager allocation
// (alloc_cuda.allocation_reference), so that the kernels' cells and codes
// are the same integers:
//
//   wrap        torch.remainder(x, box), box a Python float: ATen's
//               remainder kernel with the float32 scalar b = (float)box,
//               m = fmod(a, b), plus b where m is nonzero and of the other
//               sign;
//   floor_div   torch.div(w, box / cps, rounding_mode="floor") with a
//               Python-float divisor, which ATen passes as a CPU scalar
//               b = (float)(box / cps) and divides by multiplying with
//               inv_b = 1.0f / b (rounded on the host): mod = fmod(a, b),
//               div = (a - mod) * inv_b, one less where mod has the other
//               sign, then floor with the half-up correction of
//               div_floor_floating (a quotient that rounded just below an
//               integer goes up to it);
//   cell_of     .to(torch.int32) (cvt.rzi: truncation, NaN to 0,
//               saturating) and .clamp(0, cps - 1).
//
// Every operation rounds on its own (the library also builds with
// --fmad=false). tests/torch_alloc_check.py holds both functions to
// torch.remainder and torch.div on the card, bit for bit, for every float32
// a coordinate can hold at the benchmark's boxes.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float alloc_wrap(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

__device__ __forceinline__ float alloc_floor_div(float a, float b, float inv_b) {
  const float mod = fmodf(a, b);
  float div = __fmul_rn(__fsub_rn(a, mod), inv_b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = __fsub_rn(div, 1.0f);
  float q;
  if (div != 0.0f) {
    q = floorf(div);
    if (__fsub_rn(div, q) > 0.5f) q = __fadd_rn(q, 1.0f);
  } else {
    q = copysignf(0.0f, __fmul_rn(a, inv_b));
  }
  return q;
}

__device__ __forceinline__ int alloc_cell_of(float w, float cell, float inv_cell, int cps) {
  const int t = static_cast<int>(alloc_floor_div(w, cell, inv_cell));
  return min(max(t, 0), cps - 1);
}
