// Per-shard banded (DIA) SpMV of the mode-sharded solve, in two entry points:
//   interior: u[r, i]  = sum_b bands[s, b, i] * v[r, i + off_b], in-shard terms only
//             (0 <= i + off_b < nl), the others taken as bands * 0;
//   edge:     u[r, i] += bands[s, b, i] * rhalo[r, i + off_b - nl]  for off_b > 0, i >= nl - off_b
//             u[r, i] += bands[s, b, i] * lhalo[r, H + i + off_b]   for off_b < 0, i < -off_b
//             one band at a time, in band order.
// r runs over the d * m rows (factor s = r / m), i over the shard's nl columns,
// H = max |off_b|; lhalo holds the left neighbour's last H columns and rhalo
// the right neighbour's first H (zeros at the two ends of the chain).
//
// Replaces: tensorkrylov_tpu/ops/pallas/ring_spmv.py:_kernel, which sends
// 128-lane edge slabs to its ring neighbours by remote DMA, computes the
// interior while they are in flight and then adds the edge corrections. Here
// the exchange is outside the kernel (parallel/halo.py copies the H-wide edges
// on a side stream of the receiving device); every shard's interior is
// launched before any edge and none waits for a copy, so the interiors run
// while the halos are in flight, and only the edge launches wait for the
// copies' events. The TPU kernel's nl % 128 and H <= 128 rules and
// its barrier semaphore have no counterpart: loads are masked, any nl >= H and
// any offsets.
//
// Bound on the card: memory bandwidth, as banded_spmv.cu: nb bands, v and u
// move once per output; the edge launch touches 2H columns per row.
//
// Sum order: the interior adds the terms in band order from zero, and the
// edge launch adds each correction to the stored result in band order, as
// parallel/halo.py's plain version does (ring_spmv.py:106-128 sums one side's
// corrections first; that differs in rounding for two or more offsets on one
// side). Products and sums are rounded one at a time, so the kernel equals the
// plain version ops/ring_spmv.py:ring_spmv_reference bit for bit.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

template <typename T>
__global__ void ring_interior_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                                     const T* __restrict__ v, T* __restrict__ out, int64_t nb, int64_t m,
                                     int64_t nl, int64_t rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t s = row / m;
    out[row * nl + i] = tk::band_row(bands + s * nb * nl, offsets, v + row * nl, nb, nl, i);
  }
}

// One thread per edge position e in [0, 2H): e < H is column e (the head),
// e >= H is column nl - 2H + e (the tail). When nl < 2H the two overlap, and a
// tail column below H is left to its head thread.
template <typename T>
__global__ void ring_edge_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                                 const T* __restrict__ lhalo, const T* __restrict__ rhalo, T* __restrict__ out,
                                 int64_t nb, int64_t m, int64_t nl, int64_t H, int64_t rows) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 2 * H) return;
  const int64_t i = e < H ? e : nl - 2 * H + e;
  if (e >= H && i < H) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* bands_s = bands + (row / m) * nb * nl;
    T acc = out[row * nl + i];
    for (int64_t b = 0; b < nb; ++b) {
      const int64_t off = offsets[b];
      if (off > 0 && i >= nl - off) {
        acc = tk::add_rn(acc, tk::mul_rn(bands_s[b * nl + i], rhalo[row * H + i + off - nl]));
      } else if (off < 0 && i < -off) {
        acc = tk::add_rn(acc, tk::mul_rn(bands_s[b * nl + i], lhalo[row * H + H + i + off]));
      }
    }
    out[row * nl + i] = acc;
  }
}

dim3 grid_for(int64_t cols, int64_t rows) {
  return dim3(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
}

template <typename T>
int launch_interior(const void* bands, const void* offsets, const void* v, void* out, int64_t d, int64_t nb,
                    int64_t m, int64_t nl, void* stream) {
  const int64_t rows = d * m;
  if (rows == 0 || nl == 0) return 0;
  ring_interior_kernel<T><<<grid_for(nl, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets), static_cast<const T*>(v),
      static_cast<T*>(out), nb, m, nl, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge(const void* bands, const void* offsets, const void* lhalo, const void* rhalo, void* out,
                int64_t d, int64_t nb, int64_t m, int64_t nl, int64_t H, void* stream) {
  const int64_t rows = d * m;
  if (rows == 0 || H == 0) return 0;
  ring_edge_kernel<T><<<grid_for(2 * H, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets), static_cast<const T*>(lhalo),
      static_cast<const T*>(rhalo), static_cast<T*>(out), nb, m, nl, H, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bands (d, nb, nl), offsets (nb,) int64, v and out (d, m, nl), lhalo and rhalo
// (d, m, H); all contiguous on one device, nl >= H. Each returns the
// cudaError_t of its launch.
extern "C" int tk_ring_spmv_interior_f32(const void* bands, const void* offsets, const void* v, void* out,
                                         int64_t d, int64_t nb, int64_t m, int64_t nl, void* stream) {
  return launch_interior<float>(bands, offsets, v, out, d, nb, m, nl, stream);
}

extern "C" int tk_ring_spmv_interior_f64(const void* bands, const void* offsets, const void* v, void* out,
                                         int64_t d, int64_t nb, int64_t m, int64_t nl, void* stream) {
  return launch_interior<double>(bands, offsets, v, out, d, nb, m, nl, stream);
}

extern "C" int tk_ring_spmv_edge_f32(const void* bands, const void* offsets, const void* lhalo, const void* rhalo,
                                     void* out, int64_t d, int64_t nb, int64_t m, int64_t nl, int64_t H,
                                     void* stream) {
  return launch_edge<float>(bands, offsets, lhalo, rhalo, out, d, nb, m, nl, H, stream);
}

extern "C" int tk_ring_spmv_edge_f64(const void* bands, const void* offsets, const void* lhalo, const void* rhalo,
                                     void* out, int64_t d, int64_t nb, int64_t m, int64_t nl, int64_t H,
                                     void* stream) {
  return launch_edge<double>(bands, offsets, lhalo, rhalo, out, d, nb, m, nl, H, stream);
}
