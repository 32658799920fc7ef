// Shared device helpers of the port's kernels.
//
// Products and sums are rounded one at a time (no FMA contraction), so the
// elementwise parts of a kernel give the same bits as the plain PyTorch
// version, which also rounds each operation on its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tk {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// a - b: negation is exact, so this is the correctly rounded difference
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) { return add_rn(a, -b); }

// (A v)[i] for one factor row: bands[b*n + i] * v[i + offsets[b]] summed in
// band order; entries whose column falls outside [0, n) contribute zero.
template <typename T>
__device__ __forceinline__ T band_row(const T* __restrict__ bands_s, const int64_t* __restrict__ offsets,
                                     const T* __restrict__ v_row, int64_t nb, int64_t n, int64_t i) {
  T acc = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t j = i + offsets[b];
    const T x = (j >= 0 && j < n) ? v_row[j] : T(0);
    acc = add_rn(acc, mul_rn(bands_s[b * n + i], x));
  }
  return acc;
}

}  // namespace tk
