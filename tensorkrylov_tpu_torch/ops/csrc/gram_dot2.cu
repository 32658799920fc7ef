// The deflated certificate's compensated Gram for Hopper: G = C C^T per mode
// s for C (d, P, n) f64, each entry i <= j a Dot2 (Ogita, Rump and Oishi) as
// an f64 pair (hi, lo): leaf k is TwoProduct(c_j[k], c_i[k]) = (p, e), and
// the n leaves are summed by the pairwise tree of ops/gram_dot2.py's plain
// version: at each level node = TwoSum(left.hi, right.hi) = (s, err) with
// lo = (left.lo + right.lo) + err, a level with an odd count carrying its
// last node against a (+0, +0) pad.
//
// Replaces: no Pallas kernel. The port computed the Gram as a Python loop of
// ~155 torch elementwise ops a row (ops/gram_dot2.py:gram_dot2_plain, now the
// CPU path and the reference); the JAX package forms it as an f32-splat pair
// GEMM (tensorkrylov_tpu/utils/cp.py:246-253), which the TPU's emulated f64
// asks for and whose error the certificate's floor then has to charge.
//
// The bits are the contract: (hi, lo) equal the plain version's on the CPU
// bit for bit, so the certificate's verdicts do not depend on the device.
// That holds because the kernel keeps the plain tree, in any split of it:
//   - a complete binary tree over 2^L leaves (L = ceil(log2 n)) whose leaves
//     past n are (+0, +0) is the plain tree: a subtree of pads sums to
//     (+0, +0) exactly, which is the plain version's pad, and the levels
//     are the same L;
//   - so the kernel sums aligned chunks of 2^q leaves (q = min(kLevels, L)),
//     one node each, and then the chunk nodes, padded to a power of two,
//     by the same rule (tests/test_torch_gram_dot2.py holds a plain-torch
//     twin of this split to the plain version on the CPU);
//   - TwoProduct by FMA (p = a b, e = fma(a, b, -p)) is the exact error,
//     as the plain version's Dekker split is, wherever no product or error
//     term leaves f64's normal range; every other sum and product is rounded
//     on its own (tk::add_rn, no contraction), none in a wider type, and no
//     atomic reorders a sum.
//
// Bound on the card: f64 operations. A product costs 10 f64 instructions
// (mul, FMA; TwoSum 6; the low parts' sum 2), 11 operations counting the FMA
// as two. At the deflated cells' shape (d=10, P=95, n=131072) the
// d n P(P+1)/2 = 5.98e9 products are 6.58e10 operations, 1.93 ms at 34
// TFLOP/s, and 5.98e10 instructions, 3.6 ms at the f64 pipes' issue rate of
// one instruction a lane a clock (16.7e12/s), which binds since only one of
// the 10 is an FMA. C is 1.06 GB: 0.3 ms read once. The design keeps the f64
// pipes fed and everything else in their shadow:
//   - stage 1 (gram_dot2_chunks): a block per (mode, chunk of 2^q leaves,
//     pair of an I tile of kTileI rows and a J tile of 32 rows holding some
//     i <= j); lane l takes j = J0 + l, warp w the rows I0 + kTI w + e, so a
//     thread holds kTI entries and reads c_j from its own shared row and c_i
//     as a broadcast; the block stages kSlab = 64 leaves of its rows at a
//     time in shared memory (rows padded to kSlab + 1 doubles: the lanes'
//     reads hit distinct banks), coalesced along n from device memory;
//   - a thread sums a slab's 64 leaves for its entries as one subtree
//     unrolled whole (no branch: the scheduler interleaves later leaves'
//     products with earlier levels' sums, the pipes' latency hidden by that
//     and by the other warps), then parks the slab node in a counter of
//     pending nodes over the chunk's slabs, one a level, in registers; at the
//     chunk's last slab the counter yields the chunk's node, stored to a
//     scratch (d, chunks, T) pair that the wrapper allocates, T = P(P+1)/2;
//   - stage 2 (gram_dot2_finish): a thread per (mode, i <= j) folds the
//     chunk nodes the same way and writes (i, j) and (j, i);
//   - a diagonal tile pair computes its i > j entries too and drops them:
//     6144 entries a mode at P=95 for 4560 needed, 1.35x the operations.
#include "tk_common.cuh"

namespace {

using tk::add_rn;
using tk::sub_rn;

constexpr int kLevels = 10;                   // stage 1's chunk: at most 2^10 leaves
constexpr int kSlabLevels = 6;                // the leaves staged at a time: 2^6
constexpr int kSlab = 1 << kSlabLevels;
constexpr int kUp = kLevels - kSlabLevels;    // the levels over a chunk's slab nodes
constexpr int kTI = 2;                        // entries (rows i) a thread
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileJ = 32;                    // one j a lane
constexpr int kTileI = kTI * kWarps;
constexpr int kRow = kSlab + 1;               // a staged row, padded
constexpr int64_t kMaxN = int64_t(1) << 40;   // leaves an entry: so at most 2^30 chunk nodes
constexpr int kMaxLevels2 = 30;               // stage 2's counter's levels
static_assert(kSlabLevels == 6 && kUp >= 0, "gram_dot2_chunks' switch instantiates slab subtrees of 2^0..2^6");
static_assert((kMaxN >> kLevels) == (int64_t(1) << kMaxLevels2), "stage 2's counter holds every chunk node");

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// ceil(log2 x) for x >= 1
__host__ __device__ __forceinline__ int ceil_log2(int64_t x) {
  int k = 0;
  while ((int64_t(1) << k) < x) ++k;
  return k;
}

// the I tiles that J tile tj pairs with: those holding a row i <= some j of it
__host__ __device__ __forceinline__ int64_t i_tiles_of(int64_t tj, int64_t n_ti) {
  return imin(n_ti, (tj * kTileJ + kTileJ - 1) / kTileI + 1);
}

// (h, l) <- left + (h, l): TwoSum of the high parts, the low parts summed, then its error
__device__ __forceinline__ void combine(double lh, double ll, double& h, double& l) {
  const double s = add_rn(lh, h), bb = sub_rn(s, lh);
  const double err = add_rn(sub_rn(lh, sub_rn(s, bb)), sub_rn(h, bb));
  l = add_rn(add_rn(ll, l), err);
  h = s;
}

// The node of the 2^kH staged leaves from g0 for each of a thread's entries (rows wi + e against the lane's
// row): leaf g is TwoProduct(c_j[g], c_i[g]) by FMA. Unrolled whole, so the scheduler interleaves the leaves'
// products with the levels' sums, with no branch.
template <int kH>
__device__ __forceinline__ void subtree(const double (*sI)[kRow], const double* sJ, int wi, int g0,
                                        double (&h)[kTI], double (&l)[kTI]) {
  if constexpr (kH == 0) {
    const double cj = sJ[g0];
#pragma unroll
    for (int e = 0; e < kTI; ++e) {
      const double ci = sI[wi + e][g0];
      h[e] = tk::mul_rn(cj, ci);
      l[e] = __fma_rn(cj, ci, -h[e]);
    }
  } else {
    double rh[kTI], rl[kTI];
    subtree<kH - 1>(sI, sJ, wi, g0, h, l);
    subtree<kH - 1>(sI, sJ, wi, g0 + (1 << (kH - 1)), rh, rl);
#pragma unroll
    for (int e = 0; e < kTI; ++e) {
      combine(h[e], l[e], rh[e], rl[e]);
      h[e] = rh[e];
      l[e] = rl[e];
    }
  }
}

// Push node g's (h, l)[e] (g: its index among 2^levels nodes) into the counter (th, tl)[level][e]: merge
// with the pending node of each level whose bit of g is set, then park at the first clear bit. After the
// last node (every bit set) (h, l) hold the root of the 2^levels nodes' tree.
template <int kL>
__device__ __forceinline__ void push(double (&th)[kL][kTI], double (&tl)[kL][kTI], double (&h)[kTI],
                                     double (&l)[kTI], uint32_t g, int levels) {
#pragma unroll
  for (int k = 0; k < kL; ++k) {
    if (k == levels) return;
    if (!((g >> k) & 1u)) {
#pragma unroll
      for (int e = 0; e < kTI; ++e) {
        th[k][e] = h[e];
        tl[k][e] = l[e];
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < kTI; ++e) combine(th[k][e], tl[k][e], h[e], l[e]);
  }
}

// the index of entry (i, j), i <= j, in the upper triangle packed row by row
__device__ __forceinline__ int64_t tri(int64_t i, int64_t j, int64_t P) { return i * P - i * (i - 1) / 2 + (j - i); }

__global__ void __launch_bounds__(kThreads)
    gram_dot2_chunks(const double* __restrict__ C, int64_t P, int64_t n, int levels, int64_t n_chunks,
                     int64_t n_pairs, int64_t T, double* __restrict__ hi_s, double* __restrict__ lo_s) {
  __shared__ double sI[kTileI][kRow], sJ[kTileJ][kRow];
  int64_t b = blockIdx.x;
  const int64_t pair = b % n_pairs;
  b /= n_pairs;
  const int64_t c = b % n_chunks, s = b / n_chunks;
  const int64_t n_ti = (P + kTileI - 1) / kTileI;
  int64_t tj = 0, ti = pair;
  while (ti >= i_tiles_of(tj, n_ti)) ti -= i_tiles_of(tj, n_ti), ++tj;
  const int64_t I0 = ti * kTileI, J0 = tj * kTileJ;
  const int lane = threadIdx.x % 32, wi = (threadIdx.x / 32) * kTI;
  const double* Cs = C + s * P * n;
  // a chunk of 2^levels leaves: slabs of 2^sl leaves (sl < kSlabLevels only where the chunk is shorter than
  // a slab: n <= 32, one chunk), each one subtree, then a counter over the 2^up slab nodes
  const int sl = levels < kSlabLevels ? levels : kSlabLevels, up = levels - sl;
  const int64_t k0 = c * (int64_t(1) << levels);

  double th[kUp][kTI], tl[kUp][kTI], h[kTI] = {}, l[kTI] = {};
#pragma unroll
  for (int k = 0; k < kUp; ++k)
#pragma unroll
    for (int e = 0; e < kTI; ++e) th[k][e] = tl[k][e] = 0.0;

  for (int slab = 0; slab < (1 << up); ++slab) {
    const int64_t col0 = k0 + static_cast<int64_t>(slab) * kSlab;
    __syncthreads();
    // columns past n (and past a short chunk, which is then the only one) stage as +0 in every row: their
    // leaves are TwoProduct(+0, +0) = (+0, +0), the plain tree's pad
    for (int idx = threadIdx.x; idx < (kTileI + kTileJ) * kSlab; idx += kThreads) {
      const int r = idx / kSlab, k = idx % kSlab;
      const int64_t row = r < kTileI ? I0 + r : J0 + (r - kTileI), col = col0 + k;
      const double v = (row < P && col < n) ? Cs[row * n + col] : 0.0;
      if (r < kTileI) sI[r][k] = v;
      else sJ[r - kTileI][k] = v;
    }
    __syncthreads();
    switch (sl) {
      case 6: subtree<6>(sI, sJ[lane], wi, 0, h, l); break;
      case 5: subtree<5>(sI, sJ[lane], wi, 0, h, l); break;
      case 4: subtree<4>(sI, sJ[lane], wi, 0, h, l); break;
      case 3: subtree<3>(sI, sJ[lane], wi, 0, h, l); break;
      case 2: subtree<2>(sI, sJ[lane], wi, 0, h, l); break;
      case 1: subtree<1>(sI, sJ[lane], wi, 0, h, l); break;
      default: subtree<0>(sI, sJ[lane], wi, 0, h, l); break;
    }
    push<kUp>(th, tl, h, l, static_cast<uint32_t>(slab), up);
  }
  const int64_t j = J0 + lane;
#pragma unroll
  for (int e = 0; e < kTI; ++e) {
    const int64_t i = I0 + wi + e;
    if (i <= j && j < P) {
      const int64_t at = (s * n_chunks + c) * T + tri(i, j, P);
      hi_s[at] = h[e];
      lo_s[at] = l[e];
    }
  }
}

__global__ void __launch_bounds__(256)
    gram_dot2_finish(const double* __restrict__ hi_s, const double* __restrict__ lo_s, int64_t d, int64_t P,
                     int64_t n_chunks, int levels2, int64_t T, double* __restrict__ hi, double* __restrict__ lo) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= d * P * P) return;
  const int64_t s = idx / (P * P), i = (idx / P) % P, j = idx % P;
  if (i > j) return;
  const int64_t t = tri(i, j, P), M = int64_t(1) << levels2;
  const double* hs = hi_s + s * n_chunks * T + t;
  const double* ls = lo_s + s * n_chunks * T + t;
  double th[kMaxLevels2 + 1], tl[kMaxLevels2 + 1], h = 0.0, l = 0.0;
  constexpr int kBatch = 8;                   // chunk nodes loaded ahead of their folds
  for (int64_t c0 = 0; c0 < M; c0 += kBatch) {
    double bh[kBatch], bl[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t c = c0 + u;
      bh[u] = c < n_chunks ? hs[c * T] : 0.0;   // past the chunks: the (+0, +0) pad
      bl[u] = c < n_chunks ? ls[c * T] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t c = c0 + u;
      if (c >= M) break;
      h = bh[u];
      l = bl[u];
      int k = 0;
      for (; (c >> k) & 1; ++k) combine(th[k], tl[k], h, l);
      th[k] = h;
      tl[k] = l;
    }
  }
  const int64_t ij = (s * P + i) * P + j, ji = (s * P + j) * P + i;
  hi[ij] = hi[ji] = h;
  lo[ij] = lo[ji] = l;
}

}  // namespace

// C: (d, P, n) f64, contiguous, on the current device; hi, lo: (d, P, P) f64 outputs; hi_s, lo_s: scratch
// of d * n_chunks * P(P+1)/2 f64 each. levels, n_chunks and levels2 are the wrapper's plan
// (ops/gram_dot2.py:chunk_plan), checked here against n: levels = min(10, ceil(log2 n)) (more would add
// levels the plain tree does not have), n_chunks = ceil(n / 2^levels), levels2 = ceil(log2 n_chunks).
// Returns the cudaError_t of the launches.
extern "C" int tk_gram_dot2_f64(const void* C, int64_t d, int64_t P, int64_t n, int64_t levels, int64_t n_chunks,
                                int64_t levels2, void* hi_s, void* lo_s, void* hi, void* lo, void* stream) {
  if (d < 1 || P < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int lv = static_cast<int>(imin(kLevels, ceil_log2(n)));
  const int64_t nc = (n + (int64_t(1) << lv) - 1) >> lv;
  if (levels != lv || n_chunks != nc || levels2 != ceil_log2(nc)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_ti = (P + kTileI - 1) / kTileI, n_tj = (P + kTileJ - 1) / kTileJ;
  int64_t n_pairs = 0;
  for (int64_t tj = 0; tj < n_tj; ++tj) n_pairs += i_tiles_of(tj, n_ti);
  const int64_t blocks = d * n_chunks * n_pairs, blocks2 = (d * P * P + 255) / 256, T = P * (P + 1) / 2;
  if (blocks > 0x7fffffffLL || blocks2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_dot2_chunks<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const double*>(C), P, n, static_cast<int>(levels), n_chunks, n_pairs, T,
      static_cast<double*>(hi_s), static_cast<double*>(lo_s));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_dot2_finish<<<static_cast<unsigned>(blocks2), 256, 0, st>>>(
      static_cast<const double*>(hi_s), static_cast<const double*>(lo_s), d, P, n_chunks,
      static_cast<int>(levels2), T, static_cast<double*>(hi), static_cast<double*>(lo));
  return static_cast<int>(cudaGetLastError());
}
