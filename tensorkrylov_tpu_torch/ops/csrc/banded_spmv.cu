// Batched banded (DIA) SpMV for Hopper: u[s, j, i] = sum_b bands[s, b, i] * v[s, j, i + off_b].
//
// Replaces: tensorkrylov_tpu/ops/pallas/banded_spmv.py:_kernel (reached from
// spmv_pallas), the batched DIA SpMV that the Krylov step applies to every
// factor.
//
// Bound on the card: memory bandwidth. Per output element the kernel reads nb
// band values and one output's worth of v (its nb shifted reads of v come from
// L1/L2 after the first) and writes one value: about (nb + 2) elements moved
// for nb multiply-adds, far below the H100's ridge point in f32 or f64.
//
// Design: one thread per output element, on a grid of (n tiles) x (factor x
// batch row). Neighbouring threads read neighbouring addresses of each band
// and of v, so every load is coalesced. The TPU kernel's padded copy of v,
// its 128-lane halo DMA and its n % tile rule are replaced by a masked load
// (0 <= i + off < n): any n, any offset, no padding. Index arithmetic is
// 64-bit. Terms are summed in band order with separately rounded products and
// sums, so the result equals the plain PyTorch version bit for bit.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

template <typename T>
__global__ void banded_spmv_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                                   const T* __restrict__ v, T* __restrict__ out, int64_t nb,
                                   int64_t m, int64_t n, int64_t rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t s = row / m;  // the m batch rows of factor s share its bands
    out[row * n + i] = tk::band_row(bands + s * nb * n, offsets, v + row * n, nb, n, i);
  }
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* v, void* out, int64_t d, int64_t nb,
           int64_t m, int64_t n, void* stream) {
  const int64_t rows = d * m;
  if (rows == 0 || n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  banded_spmv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets),
      static_cast<const T*>(v), static_cast<T*>(out), nb, m, n, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bands (d, nb, n), offsets (nb,) int64, v and out (d, m, n); all contiguous
// on one device. Returns the cudaError_t of the launch.
extern "C" int tk_banded_spmv_f32(const void* bands, const void* offsets, const void* v, void* out,
                                  int64_t d, int64_t nb, int64_t m, int64_t n, void* stream) {
  return launch<float>(bands, offsets, v, out, d, nb, m, n, stream);
}

extern "C" int tk_banded_spmv_f64(const void* bands, const void* offsets, const void* v, void* out,
                                  int64_t d, int64_t nb, int64_t m, int64_t n, void* stream) {
  return launch<double>(bands, offsets, v, out, d, nb, m, n, stream);
}
