// Bands-resident multi-apply banded (DIA) SpMV for Hopper: for every factor s,
// M dependent applies u <- scale * (A_s u) per launch, by temporal blocking.
//
// Replaces: tensorkrylov_tpu/ops/pallas/resident_spmv.py:_kernel (reached from
// spmv_multi_apply), which keeps one factor's whole (nb, n) band block and two
// (1, n + 256) ping-pong vectors in VMEM for a grid of m applies, one
// pallas_call per factor.
//
// Hopper has no 100 MB on-chip buffer per core: it has ~228 KB of shared memory
// per SM. The counterpart of "resident" here is temporal blocking. The grid is
// (n tiles) x d. A block loads into shared memory its tile of T outputs of v
// plus an M*H halo on each side (H = max |offset|), and the bands over the same
// span; it runs M applies there, the valid span shrinking by H on each side per
// apply, with one __syncthreads() between applies, and writes the centre T
// outputs. Blocks never talk to each other. ceil(m / M) launches that ping-pong
// two global buffers give m applies. Positions outside [0, n) hold zero, as the
// TPU kernel's zeroed pads do.
//
// Bound on the card: per launch a block moves (nb + 1) * (T + 2MH) elements in
// and T out of device memory, so per apply the traffic is ~1/M of the per-apply
// kernel's ~(nb + 2) elements per output (the stream bound). Inside a launch
// each apply reads 2 nb + 1 values of shared memory and writes one per output:
// shared-memory bandwidth and the block barriers bound it. tk_resident_spmv_plan
// sizes T and M so that two blocks fit on an SM and the redundant halo work
// 2MH / T stays near 1/8.
//
// Rounding: products and sums are rounded one at a time (__fmul_rn/__fadd_rn)
// in band order, then multiplied by scale (already rounded to T by the caller):
// the order of banded_spmv.cu and of the plain version, which therefore gives
// the same bits for every m.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;       // the plan leaves room for two blocks per SM
constexpr int64_t kTileQuantum = 256;  // T is a multiple of this
constexpr int64_t kMaxGridY = 65535;

// Bytes of dynamic shared memory: nb int offsets (padded to 16 B), then the
// bands (nb x L) and two vectors of L, L = T + 2 * applies * H.
__host__ __device__ inline int64_t offsets_bytes(int64_t nb) { return (nb * 4 + 15) / 16 * 16; }

inline int64_t smem_bytes(int64_t nb, int64_t span, int64_t elt) {
  return offsets_bytes(nb) + (nb + 2) * span * elt;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
resident_spmv_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets, const T* __restrict__ src,
                     T* __restrict__ dst, int nb, int64_t n, int H, int applies, int tile, T scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* off_s = reinterpret_cast<int*>(smem);
  const int halo = applies * H;
  const int L = tile + 2 * halo;
  T* band_s = reinterpret_cast<T*>(smem + offsets_bytes(nb));
  T* cur = band_s + static_cast<int64_t>(nb) * L;
  T* nxt = cur + L;

  const int64_t s = blockIdx.y;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * tile - halo;  // global index of local 0
  const T* bands_s = bands + s * nb * n;
  const T* v = src + s * n;

  for (int b = threadIdx.x; b < nb; b += blockDim.x) off_s[b] = static_cast<int>(offsets[b]);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int64_t g = start + i;
    const bool in = g >= 0 && g < n;
    cur[i] = in ? v[g] : T(0);
    for (int b = 0; b < nb; ++b) band_s[static_cast<int64_t>(b) * L + i] = in ? bands_s[b * n + g] : T(0);
  }
  __syncthreads();

  for (int j = 1; j <= applies; ++j) {
    // after apply j, local positions [j H, L - j H) are exact
    const int lo = j * H, hi = L - j * H;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int64_t g = start + i;
      T acc = T(0);
      if (g >= 0 && g < n) {
        for (int b = 0; b < nb; ++b) {
          acc = tk::add_rn(acc, tk::mul_rn(band_s[static_cast<int64_t>(b) * L + i], cur[i + off_s[b]]));
        }
        acc = tk::mul_rn(acc, scale);
      }
      nxt[i] = acc;  // zero outside [0, n): the next apply reads it as a pad
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = halo + threadIdx.x; i < halo + tile; i += blockDim.x) {
    const int64_t g = start + i;
    if (g >= 0 && g < n) dst[s * n + g] = cur[i];
  }
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* src, void* dst, int64_t d, int64_t nb, int64_t n,
           int64_t H, int64_t applies, int64_t tile, double scale, void* stream) {
  if (d == 0 || n == 0 || applies == 0) return 0;
  if (d > kMaxGridY || tile <= 0 || applies < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = smem_bytes(nb, tile + 2 * applies * H, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(resident_spmv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile), static_cast<unsigned>(d));
  resident_spmv_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets), static_cast<const T*>(src),
      static_cast<T*>(dst), static_cast<int>(nb), n, static_cast<int>(H), static_cast<int>(applies),
      static_cast<int>(tile), static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile T and applies per launch M for nb bands of half-width H and elements of
// elt bytes on CUDA device `device`: the largest span L whose shared memory
// leaves room for two blocks per SM, T = the multiple of 256 nearest below
// 8/9 of L (so 2MH <= T/8), and M = (L - T) / (2H), or 2^30 when H = 0.
// Writes {M, T} to plan. Returns a cudaError_t; cudaErrorInvalidValue when not
// even one apply of a 1-element tile fits.
extern "C" int tk_resident_spmv_plan(int64_t device, int64_t nb, int64_t H, int64_t elt, int64_t* plan) {
  int optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, static_cast<int>(device));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, static_cast<int>(device));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t budget = per_sm / kBlocksPerSm - reserved;
  if (budget > optin) budget = optin;
  const int64_t L = (budget - offsets_bytes(nb)) / ((nb + 2) * elt);
  if (nb <= 0 || H < 0 || L < 2 * H + 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t T = (L * 8 / 9) / kTileQuantum * kTileQuantum;
  if (T < kTileQuantum || (H > 0 && L - T < 2 * H)) T = L - 2 * H;  // narrow: one apply per launch at least
  plan[0] = H > 0 ? (L - T) / (2 * H) : (int64_t(1) << 30);
  plan[1] = T;
  return 0;
}

// bands (d, nb, n), offsets (nb,) int64, src and dst (d, n), all contiguous on
// one device; dst = (scale * A)^applies src with `applies` <= the plan's M and
// `tile` its T. Returns the cudaError_t of the launch.
extern "C" int tk_resident_spmv_f32(const void* bands, const void* offsets, const void* src, void* dst, int64_t d,
                                    int64_t nb, int64_t n, int64_t H, int64_t applies, int64_t tile, double scale,
                                    void* stream) {
  return launch<float>(bands, offsets, src, dst, d, nb, n, H, applies, tile, scale, stream);
}

extern "C" int tk_resident_spmv_f64(const void* bands, const void* offsets, const void* src, void* dst, int64_t d,
                                    int64_t nb, int64_t n, int64_t H, int64_t applies, int64_t tile, double scale,
                                    void* stream) {
  return launch<double>(bands, offsets, src, dst, d, nb, n, H, applies, tile, scale, stream);
}
