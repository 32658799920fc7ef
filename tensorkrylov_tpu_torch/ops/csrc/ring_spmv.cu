// Banded (DIA) SpMV of the mode-sharded solve: one launch per card for all of
// that card's shards. For shard s of the launch, output row r (factor r / m of
// the shard's d_f, column vector r % m) and column i of its nl:
//   1. u = sum_b bands[b, i] * v[r, i + off_b] over the in-shard terms
//      (0 <= i + off_b < nl), in band order from zero, each out-of-shard term
//      taken as bands * 0;
//   2. then, in band order, u += bands[b, i] * x for each out-of-shard column
//      j = i + off_b, with x read in place from the neighbour's source:
//      left[r * stride + base + j] for j < 0, right[r * stride + base + j - nl]
//      for j >= nl, and 0 where that source is null (a chain end).
// A source is the neighbouring shard's own v (row stride nl; base nl on the
// left, 0 on the right), on this card or, with peer access, on another, or a
// halo buffer (d_f, m, H) that holds the neighbour's edge (stride H; base H on
// the left, 0 on the right). Each shard's pointers and sources travel by
// value in the launch's parameters (RingTable, at most kMaxShards), so a call
// copies nothing to the card.
//
// Replaces: tensorkrylov_tpu/ops/pallas/ring_spmv.py:_kernel, which sends
// 128-lane edge slabs to its ring neighbours by remote DMA from inside the
// kernel and then adds the edge corrections. Here the kernel reads the
// neighbours' edges itself, with plain loads through their pointers, so the
// host neither copies halos nor orders copies with events: on one card the
// launch follows whatever wrote the v pieces on the same stream, and across
// cards parallel/halo.py fences it with one event per neighbouring card. The
// TPU kernel's nl % 128 and H <= 128 rules and its barrier semaphore have no
// counterpart: loads are masked, any nl >= H and any offsets.
//
// Bound on the card: memory bandwidth, as banded_spmv.cu: nb bands, v and u
// move once per output; the 2H edge columns of a row also read H columns of
// each neighbour.
//
// Sum order: step 1 is the interior of parallel/halo.py's order and step 2
// its edge corrections, one band at a time (ring_spmv.py:106-128 of the TPU
// kernel sums one side's corrections first; that differs in rounding for two
// or more offsets on one side). Products and sums are rounded one at a time,
// so the kernel equals the plain version ops/ring_spmv.py:ring_spmv_reference
// bit for bit, a null source giving bands * 0 as the reference's zero halo.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
// 8 x 72 bytes of table in the launch's parameters, far inside their 4 KB: a
// larger table makes every launch dearer on the host, and a card with more
// shards takes one launch per 8
constexpr int kMaxShards = 8;

template <typename T>
struct RingSource {
  const T* ptr;  // null at a chain end
  int64_t stride;
  int64_t base;
};

template <typename T>
struct RingShard {
  const T* bands;  // (d_f, nb, nl)
  const T* v;      // (d_f, m, nl)
  T* out;          // (d_f, m, nl)
  RingSource<T> left, right;
};

template <typename T>
struct RingTable {
  RingShard<T> s[kMaxShards];
};

// The layout the Python side packs: 9 int64 per shard, in RingShard's order.
static_assert(sizeof(RingShard<double>) == 9 * sizeof(int64_t), "RingShard is 9 words");
static_assert(sizeof(RingShard<float>) == 9 * sizeof(int64_t), "RingShard is 9 words");

template <typename T>
__device__ __forceinline__ T source_at(const RingSource<T>& src, int64_t row, int64_t col) {
  return src.ptr != nullptr ? src.ptr[row * src.stride + src.base + col] : T(0);
}

// grid (columns, rows, shards of this launch)
template <typename T>
__global__ void ring_spmv_kernel(const __grid_constant__ RingTable<T> table, const int64_t* __restrict__ offsets,
                                 int64_t nb, int64_t m, int64_t nl, int64_t H, int64_t rows) {
  const RingShard<T>& sh = table.s[blockIdx.z];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const bool edge = i < H || i >= nl - H;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* bands_s = sh.bands + (row / m) * nb * nl;
    T acc = tk::band_row(bands_s, offsets, sh.v + row * nl, nb, nl, i);
    if (edge) {
      for (int64_t b = 0; b < nb; ++b) {
        const int64_t j = i + offsets[b];
        if (j < 0) {
          acc = tk::add_rn(acc, tk::mul_rn(bands_s[b * nl + i], source_at(sh.left, row, j)));
        } else if (j >= nl) {
          acc = tk::add_rn(acc, tk::mul_rn(bands_s[b * nl + i], source_at(sh.right, row, j - nl)));
        }
      }
    }
    sh.out[row * nl + i] = acc;
  }
}

template <typename T>
int launch(const int64_t* packed, int64_t shards, const void* offsets, int64_t d, int64_t nb, int64_t m,
           int64_t nl, int64_t H, void* stream) {
  const int64_t rows = d * m;
  if (shards == 0 || rows == 0 || nl == 0) return 0;
  if (shards < 0 || shards > kMaxShards || nl < H) return static_cast<int>(cudaErrorInvalidValue);
  RingTable<T> table;
  static_assert(sizeof(RingShard<T>) % sizeof(int64_t) == 0, "packed as int64 words");
  for (int64_t q = 0; q < shards; ++q) {
    const int64_t* w = packed + 9 * q;
    RingShard<T>& sh = table.s[q];
    sh.bands = reinterpret_cast<const T*>(w[0]);
    sh.v = reinterpret_cast<const T*>(w[1]);
    sh.out = reinterpret_cast<T*>(w[2]);
    sh.left = RingSource<T>{reinterpret_cast<const T*>(w[3]), w[4], w[5]};
    sh.right = RingSource<T>{reinterpret_cast<const T*>(w[6]), w[7], w[8]};
  }
  const dim3 grid(static_cast<unsigned>((nl + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY), static_cast<unsigned>(shards));
  ring_spmv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int64_t*>(offsets), nb, m, nl, H, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: `shards` rows of 9 int64 on the host, one per shard: bands, v, out
// pointers, then (pointer, row stride, column base) of the left and of the
// right source (pointer 0 at a chain end). Every shard has bands (d, nb, nl),
// v and out (d, m, nl), all contiguous on the current device; offsets (nb,)
// int64 there; a source may lie on a peer card. 1 <= shards <= 8, nl >= H =
// max |offset|. Returns the cudaError_t of the launch.
extern "C" int tk_ring_spmv_f32(const int64_t* packed, int64_t shards, const void* offsets, int64_t d, int64_t nb,
                                int64_t m, int64_t nl, int64_t H, void* stream) {
  return launch<float>(packed, shards, offsets, d, nb, m, nl, H, stream);
}

extern "C" int tk_ring_spmv_f64(const int64_t* packed, int64_t shards, const void* offsets, int64_t d, int64_t nb,
                                int64_t m, int64_t nl, int64_t H, void* stream) {
  return launch<double>(packed, shards, offsets, d, nb, m, nl, H, stream);
}

// The most shards one launch takes.
extern "C" int64_t tk_ring_spmv_max_shards() { return kMaxShards; }

// Lets `device` read `peer`'s memory with plain loads (cudaDeviceEnablePeerAccess);
// access that is already on counts as success. The current device is kept.
extern "C" int tk_enable_peer_access(int64_t device, int64_t peer) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(static_cast<int>(device));
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(static_cast<int>(peer), 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  return static_cast<int>(err != cudaSuccess ? err : back);
}
