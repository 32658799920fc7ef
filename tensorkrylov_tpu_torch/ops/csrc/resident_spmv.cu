// Register-resident multi-apply banded (DIA) SpMV for Hopper: for every
// factor s, M dependent applies u <- scale * (A_s u) per launch, by temporal
// blocking.
//
// Replaces: tensorkrylov_tpu/ops/pallas/resident_spmv.py:_kernel (reached from
// spmv_multi_apply), which keeps one factor's whole (nb, n) band block and two
// (1, n + 256) ping-pong vectors in VMEM for a grid of m applies, one
// pallas_call per factor.
//
// Hopper has no 100 MB on-chip buffer per core: it has ~228 KB of shared memory
// and 256 KB of registers per SM. The counterpart of "resident" here is
// temporal blocking. The grid is (n tiles) x d. A block takes a span of L
// positions of v: a tile of `tile` outputs plus an applies * H halo on each
// side (H = max |offset|). It runs `applies` applies there, the exact part of
// the span shrinking by H on each side per apply, with one __syncthreads()
// per apply, and writes the centre `tile` outputs. Blocks never talk to each
// other. ceil(m / M) launches that ping-pong two global buffers give m
// applies. Positions outside [0, n) hold zero, as the TPU kernel's zeroed pads
// do.
//
// Bound on the card: the arithmetic. Per output and apply it is nb products,
// nb sums and the scale, each rounded on its own (no FMA), so at nb = 3 the
// floor is 7 operations per output; device memory is touched once per launch.
// The design keeps every other cost per apply below that:
//   - nb is a template parameter. NB = 3 and NB = 5 are the centred band sets
//     -H..H in order (laplace, reaction_diffusion, conv_diff; pentadiagonal
//     factors): each thread owns R consecutive positions of the span and keeps
//     their values of v and their nb bands in registers for the whole launch.
//     Before an apply's barrier each thread publishes its first and last H
//     values in shared memory, and after it reads its two neighbours' (fixed
//     addresses, no branch), so shared memory carries 2H values per thread
//     and apply, not the span;
//   - NB = 0 is any other set of offsets, read at run time: the bands and two
//     buffers of v share the shared memory, sized so that two blocks fit on
//     an SM (the span L shrinks as nb grows; any nb and any H with L > 2H
//     launch), and each apply reads the bands and v there at the offsets;
//   - index arithmetic inside a block is 32-bit, and the [0, n) mask is applied
//     only in the blocks whose span crosses 0 or n.
// All three instantiations are this one kernel and give the same bits. The
// span L is what the registers (NB > 0: kThreads * R) or the shared memory
// (NB = 0) allow; tk_resident_spmv_plan gives T (the tile at M applies) and M
// so that the redundant halo work 2 M H stays near 1/8 of T.
//
// Rounding: products and sums are rounded one at a time (__fmul_rn/__fadd_rn)
// in band order from zero, then multiplied by scale (already rounded to T by
// the caller): the order of banded_spmv.cu and of the plain version, which
// therefore gives the same bits for every m.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;        // every instantiation leaves room for two blocks per SM
constexpr int64_t kTileQuantum = 256;  // T is a multiple of this
constexpr int64_t kMaxGridY = 65535;

// A centred instantiation's layout: each thread owns R consecutive positions
// t R .. t R + R - 1 of the span of L positions.
template <typename T, int NB>
struct Shape {
  static constexpr int R = sizeof(T) == 4 ? (NB == 3 ? 12 : 8) : (NB == 3 ? 6 : 4);
  static constexpr int L = kThreads * R;
  static_assert(NB / 2 <= R, "a thread's neighbours come from the adjacent threads only");
};

// The generic instantiation's dynamic shared memory: nb int offsets (padded to
// 16 B), then the bands (nb x L) and two vectors of L.
__host__ __device__ inline int64_t offsets_bytes(int64_t nb) { return (nb * 4 + 15) / 16 * 16; }

// Dynamic shared memory of a launch over a span of L: the span of v (kind > 0),
// or the generic instantiation's offsets, bands and two vectors (kind 0).
inline int64_t smem_bytes(int kind, int64_t L, int64_t nb, int64_t elt) {
  return kind > 0 ? L * elt : offsets_bytes(nb) + (nb + 2) * L * elt;
}

// Each thread's H first and H last values of v, published before an apply's
// barrier for its two neighbours: [parity of the apply][side][h][1 + thread],
// side 0 the first H values, 1 the last H; entries 0 and kThreads + 1 are the
// zero pads beyond the block's span. Neighbouring threads use neighbouring
// words, so the stores and loads are free of bank conflicts.
template <typename T, int H>
struct Edges {
  T v[2][2][H][kThreads + 2];
};

// One apply of a centred instantiation: x (this thread's R values) <- scale *
// (A x), with the H neighbours on each side from the adjacent threads' edges
// in buffer P. MASK: zero the values whose global index g0 + k falls outside
// [0, n).
template <typename T, int NB, int P, bool MASK>
__device__ __forceinline__ void apply_in_registers(T (&x)[Shape<T, NB>::R], const T (&band)[NB][Shape<T, NB>::R],
                                                   Edges<T, NB / 2>& edges, int64_t g0, int64_t n, T scale) {
  constexpr int H = NB / 2, R = Shape<T, NB>::R;
  const int t = threadIdx.x + 1;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    edges.v[P][0][h][t] = x[h];
    edges.v[P][1][h][t] = x[R - H + h];
  }
  __syncthreads();
  T win[R + 2 * H];  // win[H + k] = x[k]: positions t R - H .. t R + R + H - 1
#pragma unroll
  for (int h = 0; h < H; ++h) {
    win[h] = edges.v[P][1][h][t - 1];         // the previous thread's last H values
    win[H + R + h] = edges.v[P][0][h][t + 1];  // the next thread's first H
  }
#pragma unroll
  for (int k = 0; k < R; ++k) win[H + k] = x[k];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    T acc = T(0);
#pragma unroll
    for (int b = 0; b < NB; ++b) acc = tk::add_rn(acc, tk::mul_rn(band[b][k], win[k + b]));  // offset b - H
    acc = tk::mul_rn(acc, scale);
    if constexpr (MASK) {
      const int64_t g = g0 + k;
      if (g < 0 || g >= n) acc = T(0);  // the next apply reads it as a pad
    }
    x[k] = acc;
  }
}

// `applies` applies, two per turn of the loop so that the edge buffer's parity
// is known when compiling; edge buffer P is written again only two applies
// later, after a barrier that every read of it precedes.
template <typename T, int NB, bool MASK>
__device__ __forceinline__ void applies_in_registers(T (&x)[Shape<T, NB>::R], const T (&band)[NB][Shape<T, NB>::R],
                                                     Edges<T, NB / 2>& edges, int applies, int64_t g0, int64_t n,
                                                     T scale) {
  int j = 0;
  for (; j + 2 <= applies; j += 2) {
    apply_in_registers<T, NB, 0, MASK>(x, band, edges, g0, n, scale);
    apply_in_registers<T, NB, 1, MASK>(x, band, edges, g0, n, scale);
  }
  if (j < applies) apply_in_registers<T, NB, 0, MASK>(x, band, edges, g0, n, scale);
}

// The centred instantiations: v and the bands in registers.
template <typename T, int NB>
__device__ __forceinline__ void run_in_registers(const T* bands_s, const T* v, T* out, int64_t n, int applies,
                                                 int tile, T scale, int64_t start, bool edge) {
  constexpr int H = NB / 2, R = Shape<T, NB>::R, L = Shape<T, NB>::L;
  extern __shared__ __align__(16) unsigned char smem[];
  T* span = reinterpret_cast<T*>(smem);
  __shared__ Edges<T, H> edges;
  const int t = threadIdx.x;
  const int64_t g0 = start + t * R;  // global index of this thread's first position

  for (int i = t; i < L; i += kThreads) {  // coalesced, through shared memory
    const int64_t g = start + i;
    span[i] = (g >= 0 && g < n) ? v[g] : T(0);
  }
  for (int i = t; i < 4 * H; i += kThreads) {  // the pads beyond the span's ends stay zero
    edges.v[i / (2 * H)][i / H % 2][i % H][0] = T(0);
    edges.v[i / (2 * H)][i / H % 2][i % H][kThreads + 1] = T(0);
  }
  T band[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t g = g0 + k;
      band[b][k] = (g >= 0 && g < n) ? bands_s[b * n + g] : T(0);
    }
  }
  __syncthreads();
  T x[R];
#pragma unroll
  for (int k = 0; k < R; ++k) x[k] = span[t * R + k];
  if (edge) {
    applies_in_registers<T, NB, true>(x, band, edges, applies, g0, n, scale);
  } else {
    applies_in_registers<T, NB, false>(x, band, edges, applies, g0, n, scale);
  }
  // every thread read its x before the first apply's barrier (applies >= 1)
#pragma unroll
  for (int k = 0; k < R; ++k) span[t * R + k] = x[k];
  __syncthreads();
  const int lo = applies * H;  // after the last apply, positions [lo, lo + tile) are exact
  for (int i = lo + t; i < lo + tile; i += kThreads) {
    const int64_t g = start + i;
    if (g < n) out[g] = span[i];
  }
}

// The generic instantiation: the bands and v in shared memory over the span
// of L = tile + 2 applies H positions; apply j computes the positions
// [j H, L - j H), which read only positions of the span.
template <typename T>
__device__ __forceinline__ void run_in_shared(const T* bands_s, const int64_t* offsets, const T* v, T* out, int nb,
                                              int64_t n, int H, int applies, int tile, T scale, int64_t start,
                                              bool edge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + 2 * applies * H;
  int* off_s = reinterpret_cast<int*>(smem);
  T* band_s = reinterpret_cast<T*>(smem + offsets_bytes(nb));
  T* cur = band_s + nb * L;
  T* nxt = cur + L;
  const int t = threadIdx.x;

  for (int b = t; b < nb; b += kThreads) off_s[b] = static_cast<int>(offsets[b]);
  for (int i = t; i < L; i += kThreads) {
    const int64_t g = start + i;
    const bool in = g >= 0 && g < n;
    cur[i] = in ? v[g] : T(0);
    for (int b = 0; b < nb; ++b) band_s[b * L + i] = in ? bands_s[b * n + g] : T(0);
  }
  __syncthreads();
  for (int j = 1; j <= applies; ++j) {
    for (int i = j * H + t; i < L - j * H; i += kThreads) {
      T acc = T(0);
      if (!edge || (start + i >= 0 && start + i < n)) {  // zero outside [0, n): the next apply reads it as a pad
        for (int b = 0; b < nb; ++b) acc = tk::add_rn(acc, tk::mul_rn(band_s[b * L + i], cur[i + off_s[b]]));
        acc = tk::mul_rn(acc, scale);
      }
      nxt[i] = acc;
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const int lo = applies * H;  // after the last apply, positions [lo, lo + tile) are exact
  for (int i = lo + t; i < lo + tile; i += kThreads) {
    const int64_t g = start + i;
    if (g < n) out[g] = cur[i];
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
resident_spmv_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets, const T* __restrict__ src,
                     T* __restrict__ dst, int nb, int64_t n, int H, int applies, int tile, T scale) {
  const int64_t s = blockIdx.y;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * tile - static_cast<int64_t>(applies) * H;  // position 0
  if constexpr (NB > 0) {
    const bool edge = start < 0 || start + Shape<T, NB>::L > n;  // only a span that crosses 0 or n needs the mask
    run_in_registers<T, NB>(bands + s * NB * n, src + s * n, dst + s * n, n, applies, tile, scale, start, edge);
  } else {
    const bool edge = start < 0 || start + tile + 2 * applies * H > n;
    run_in_shared<T>(bands + s * nb * n, offsets, src + s * n, dst + s * n, nb, n, H, applies, tile, scale, start,
                     edge);
  }
}

// The instantiation for nb bands of half-width H: 3 or 5 where the offsets are
// -H..H in order (`centred`), else 0; -1 for no bands.
int instantiation(int64_t nb, int64_t H, int64_t centred) {
  if (centred && (nb == 3 || nb == 5) && H == nb / 2) return static_cast<int>(nb);
  return nb >= 1 ? 0 : -1;
}

template <typename T, int NB>
int launch_shape(const void* bands, const void* offsets, const void* src, void* dst, int64_t d, int64_t nb,
                 int64_t n, int64_t H, int64_t applies, int64_t tile, double scale, cudaStream_t stream) {
  static tk::SharedAllowance allowance;
  const int64_t L = tile + 2 * applies * H;
  if (tile <= 0 || (NB > 0 && L > Shape<T, NB>::L)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = smem_bytes(NB, NB > 0 ? Shape<T, NB>::L : L, nb, sizeof(T));
  cudaError_t err =
      tk::allow_shared(reinterpret_cast<const void*>(resident_spmv_kernel<T, NB>), allowance, bytes, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile), static_cast<unsigned>(d));
  resident_spmv_kernel<T, NB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets), static_cast<const T*>(src),
      static_cast<T*>(dst), static_cast<int>(nb), n, static_cast<int>(H), static_cast<int>(applies),
      static_cast<int>(tile), static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* src, void* dst, int64_t d, int64_t nb, int64_t n,
           int64_t H, int64_t applies, int64_t tile, int64_t centred, double scale, void* stream_ptr) {
  if (d == 0 || n == 0 || applies == 0) return 0;
  if (d > kMaxGridY || applies < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (instantiation(nb, H, centred)) {
    case 3: return launch_shape<T, 3>(bands, offsets, src, dst, d, nb, n, H, applies, tile, scale, stream);
    case 5: return launch_shape<T, 5>(bands, offsets, src, dst, d, nb, n, H, applies, tile, scale, stream);
    case 0: return launch_shape<T, 0>(bands, offsets, src, dst, d, nb, n, H, applies, tile, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tile T and applies per launch M for nb bands of half-width H (`centred`:
// the offsets are -H..H in order) and elements of elt bytes on CUDA device
// `device`: L = the centred instantiation's span, or for the generic one the
// largest span whose shared memory leaves room for two blocks per SM; T = the
// multiple of 256 nearest below 8/9 of L (so 2MH <= T/8), M = (L - T) / (2H),
// or 2^30 when H = 0. A launch of a <= M applies may take a tile of up to
// T + 2 (M - a) H. Writes {M, T} to plan. Returns a cudaError_t;
// cudaErrorInvalidValue when not even one apply of a 1-element tile fits.
extern "C" int tk_resident_spmv_plan(int64_t device, int64_t nb, int64_t H, int64_t elt, int64_t centred,
                                     int64_t* plan) {
  const int kind = instantiation(nb, H, centred);
  if (kind < 0 || H < 0 || (elt != 4 && elt != 8)) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0, per_sm = 0, reserved = 0;
  const int dev = static_cast<int>(device);
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t L;
  if (kind > 0) {
    L = kind == 3 ? (elt == 8 ? Shape<double, 3>::L : Shape<float, 3>::L)
                  : (elt == 8 ? Shape<double, 5>::L : Shape<float, 5>::L);
  } else {
    int64_t budget = per_sm / kBlocksPerSm - reserved;
    if (budget > optin) budget = optin;
    L = (budget - offsets_bytes(nb)) / ((nb + 2) * elt);
  }
  if (L < 2 * H + 1 || smem_bytes(kind, L, nb, elt) > optin) return static_cast<int>(cudaErrorInvalidValue);
  int64_t T = (L * 8 / 9) / kTileQuantum * kTileQuantum;
  if (T < kTileQuantum || (H > 0 && L - T < 2 * H)) T = L - 2 * H;  // narrow: one apply per launch at least
  plan[0] = H > 0 ? (L - T) / (2 * H) : (int64_t(1) << 30);
  plan[1] = T;
  return 0;
}

// bands (d, nb, n), offsets (nb,) int64, src and dst (d, n), all contiguous on
// one device; dst = (scale * A)^applies src for `applies` <= the plan's M, with
// tile + 2 * applies * H no more than the plan's T + 2 M H. Returns the
// cudaError_t of the launch.
extern "C" int tk_resident_spmv_f32(const void* bands, const void* offsets, const void* src, void* dst, int64_t d,
                                    int64_t nb, int64_t n, int64_t H, int64_t applies, int64_t tile, int64_t centred,
                                    double scale, void* stream) {
  return launch<float>(bands, offsets, src, dst, d, nb, n, H, applies, tile, centred, scale, stream);
}

extern "C" int tk_resident_spmv_f64(const void* bands, const void* offsets, const void* src, void* dst, int64_t d,
                                    int64_t nb, int64_t n, int64_t H, int64_t applies, int64_t tile, int64_t centred,
                                    double scale, void* stream) {
  return launch<double>(bands, offsets, src, dst, d, nb, n, H, applies, tile, centred, scale, stream);
}
