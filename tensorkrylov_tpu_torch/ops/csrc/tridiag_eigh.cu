// Symmetric tridiagonal eigensolver for Hopper: the eigenpairs of the active
// k x k blocks of d padded (K, K) tridiagonal matrices H (the Lanczos H_s).
//
// Replaces: tensorkrylov_tpu/ops/eigen.py:masked_eigh_tridiag_mixed (L182),
// which the JAX package runs outside Pallas, as lax.scan recurrences (an f32
// dense eigh for seed pairs, f64 Rayleigh quotients, one batched Thomas
// inverse-iteration step). The card has native f64, so no f32 seed: each
// eigenvalue comes from Sturm multisection and each vector from inverse
// iteration. The Newton–Schulz re-orthonormalisation after it stays two f64
// GEMMs per step in ops/eigen.py, as in the JAX package.
//
// Bound on the card: latency. The work is a few k-step recurrences per
// eigenpair (the Sturm count of each probe, the Thomas sweeps), each step
// waiting on the previous one's f64 division (~200 cycles a row); the bytes
// (H's 2k entries in, the K x K Q out) and the operations are far below what
// the card moves and computes in that time. The design shortens the serial
// chain and spreads it over more SMs:
//   - multisection: each eigenvalue j gets a group of P lanes (a power of two
//     up to a warp), and in each round lane l = 1..P-1 counts at
//     x_l = lo + (hi - lo) * (l / P): log2(P) bits a round, so ~54 serial
//     Sturm sweeps of bisection become ~54 / log2(P);
//   - one thread-block cluster of G blocks per factor (d clusters, one
//     launch); the factor's eigenvalues are dealt out over the blocks in
//     runs of ceil(k / G), every block holding the whole T.
// P comes from ops/eigen.py:tridiag_lanes (the plain version uses the same
// probes), G from ops/eigen.py:tridiag_cluster and leaves the result alone.
//
// Per cluster (factor s), block r of G:
//   1. reads the diagonal and sub-diagonal straight from H (stride K+1) into
//      its shared memory and forms the Gershgorin bracket [lo, hi] of the
//      active rows, widened by 2 eps ||T|| (||T|| = max(|lo|, |hi|)), by a
//      min/max reduction (exact in any order);
//   2. multisects its eigenvalues: at most `rounds` rounds; a ballot over the
//      group picks the first probe whose count exceeds j as the new hi and the
//      probe before it (lo for the first) as the new lo, or the last probe as
//      the new lo where none does, which keeps count(lo) <= j < count(hi)
//      though a floating-point Sturm count need not be monotone in x; a
//      bracket with no probe strictly inside stops; lambda_j = (lo + hi) / 2,
//      written to w;
//   -- cluster barrier: every block reads all k eigenvalues back from w and
//      marks the clusters (consecutive eigenvalues within cluster_rtol ||T||);
//   3. `steps` inverse-iteration solves (T - lambda_j I) x = piv r of the JAX
//      package's _thomas_solve (L144-179), one thread per eigenvalue of the
//      block, its pivots guarded to at least piv = eps ||T|| in magnitude
//      (the right side scaled by piv keeps x near unit size at any scale of
//      T), from a hashed start vector r distinct per j, then from the last
//      result; each x normalised; the forward sweep's multipliers in shared
//      memory where the block's k x ceil(k / G) fit, else in the scratch;
//   -- cluster barrier;
//   4. after each solve, each cluster is made orthonormal by its first
//      member's thread: modified Gram-Schmidt in index order, each dot
//      product summed in a fixed halving tree. A cluster may straddle blocks:
//      the first member's thread then reads and writes the other members'
//      columns of Q, which other SMs wrote before the barrier (plain loads).
//      Newton–Schulz cannot separate vectors that inverse iteration made
//      nearly parallel (near-equal eigenvalues); above the gap, separately
//      computed vectors are orthogonal to eps ||T|| / gap, which
//      Newton–Schulz's two steps take to eps;
//   -- cluster barrier before the next solve.
// Padded eigenvalue slots hold lambda_0 and padded columns of Q are the
// identity's. Every product, sum, quotient and root is rounded on its own
// (no FMA), in the order of the plain version
// ops/eigen.py:masked_eigh_tridiag_reference, so the two agree bit for bit.
// Scratch (d, K, K) holds the multipliers and tree sums that do not fit in
// shared memory.
#include "tk_common.cuh"

namespace {

// Threads per block: __launch_bounds__ holds ptxas to 64 registers a thread.
constexpr int kMaxThreads = 1024;
constexpr int64_t kMaxCluster = 16;  // the H100's largest cluster, non-portable above 8
constexpr int kMaxLanes = 32;        // lanes per eigenvalue: at most a warp
// The most bytes of forward-sweep multipliers a block keeps in shared memory.
constexpr int64_t kSharedMultipliers = 160 * 1024;

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// A launch's shape, which the launcher and the occupancy entry point share.
struct Layout {
  int64_t per_block;        // eigenvalues per block, ceil(k / G)
  int threads;              // per block: the block's probe lanes, a multiple of 32, at most kMaxThreads
  int64_t smem;             // dynamic shared memory bytes
  bool shared_multipliers;  // the forward sweep's multipliers in shared memory
};

template <typename T>
Layout layout(int64_t k, int64_t P, int64_t G) {
  Layout L;
  L.per_block = (k + G - 1) / G;
  const int64_t lanes = (L.per_block * P + 31) / 32 * 32;
  L.threads = static_cast<int>(lanes < kMaxThreads ? lanes : kMaxThreads);
  const int64_t mult = L.per_block * k * static_cast<int64_t>(sizeof(T));
  L.shared_multipliers = mult <= kSharedMultipliers;
  // dg, e (k + 1), e2, lam, the multipliers, then joins
  L.smem = (4 * k + 1) * static_cast<int64_t>(sizeof(T)) + (L.shared_multipliers ? mult : 0) +
           k * static_cast<int64_t>(sizeof(int));
  return L;
}

// Entry (i, j) of the start vectors: an integer hash of (i, j), its top 24
// bits scaled into [-0.5, 0.5), exact in f32 and f64 (ops/eigen.py:_start_vectors).
template <typename T>
__device__ __forceinline__ T start_value(int64_t i, int64_t j) {
  uint64_t h = static_cast<uint64_t>(i + 1) * 2654435761ull + static_cast<uint64_t>(j + 1) * 2246822519ull;
  h &= 0xFFFFFFFFull;
  h ^= h >> 15;
  h = (h * 739982445ull) & 0xFFFFFFFFull;
  h ^= h >> 12;
  return static_cast<T>(static_cast<double>(h >> 8) * (1.0 / 16777216.0) - 0.5);
}

// sum_i x[i] y[i] over n entries of x and y at stride xs, in a fixed halving
// tree (entry i + half added to entry i, half = ceil(len / 2), until one is
// left), the products kept in buf at stride bs.
template <typename T>
__device__ T tree_dot(const T* x, const T* y, int64_t xs, T* buf, int64_t bs, int64_t n) {
  for (int64_t i = 0; i < n; ++i) buf[i * bs] = tk::mul_rn(x[i * xs], y[i * xs]);
  for (int64_t len = n; len > 1;) {
    const int64_t half = (len + 1) / 2;
    for (int64_t i = 0; i < len - half; ++i) buf[i * bs] = tk::add_rn(buf[i * bs], buf[(i + half) * bs]);
    len = half;
  }
  return buf[0];
}

// Launched as d clusters of G blocks: block b works on factor b / G as the
// cluster's block b % G, on eigenvalues [r * per_block, (r + 1) * per_block).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_eigh_kernel(const T* __restrict__ H, T* w, T* Q, T* scratch, int64_t K, int64_t k, int P,
                        int64_t rounds, int64_t steps, int G, int shared_multipliers, T eps, T tiny,
                        T cluster_rtol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dg = reinterpret_cast<T*>(smem_raw);   // diagonal, k
  T* e = dg + k;                            // e[i] couples rows i-1 and i; e[0] = e[k] = 0
  T* e2 = e + k + 1;                        // e[i]^2, k
  T* lam = e2 + k;                          // eigenvalues, k
  T* mult = lam + k;                        // multipliers, k rows of per_block (shared_multipliers)
  __shared__ T s_lo, s_hi, s_piv, s_tau;
  __shared__ T warp_lo[kMaxThreads / 32], warp_hi[kMaxThreads / 32];

  const int64_t s = blockIdx.x / G;
  const int rank = blockIdx.x % G;
  const T* Hs = H + s * K * K;
  T* Qs = Q + s * K * K;
  T* Cs = scratch + s * K * K;
  T* ws = w + s * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t per_block = (k + G - 1) / G;
  const int64_t jb = rank * per_block < k ? rank * per_block : k, je = jb + per_block < k ? jb + per_block : k;
  int* joins = reinterpret_cast<int*>(mult + (shared_multipliers ? per_block * k : 0));  // j is in j-1's cluster

  for (int64_t i = tid; i <= k; i += nt) {
    const T ei = (i > 0 && i < k) ? Hs[i * (K + 1) - 1] : T(0);
    e[i] = ei;
    if (i < k) {
      dg[i] = Hs[i * (K + 1)];
      e2[i] = tk::mul_rn(ei, ei);
    }
  }
  __syncthreads();

  // 1. Gershgorin bracket: min and max are exact, so the reduction's order does not matter
  {
    T r = tk::add_rn(fabs(e[0]), fabs(e[1]));
    T glo = tk::sub_rn(dg[0], r), ghi = tk::add_rn(dg[0], r);
    for (int64_t i = tid; i < k; i += nt) {
      r = tk::add_rn(fabs(e[i]), fabs(e[i + 1]));
      const T lo_i = tk::sub_rn(dg[i], r), hi_i = tk::add_rn(dg[i], r);
      glo = lo_i < glo ? lo_i : glo;
      ghi = hi_i > ghi ? hi_i : ghi;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T lo_o = __shfl_xor_sync(0xffffffffu, glo, o), hi_o = __shfl_xor_sync(0xffffffffu, ghi, o);
      glo = lo_o < glo ? lo_o : glo;
      ghi = hi_o > ghi ? hi_o : ghi;
    }
    if (tid % 32 == 0) {
      warp_lo[tid / 32] = glo;
      warp_hi[tid / 32] = ghi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int v = 1; v < nt / 32; ++v) {
        glo = warp_lo[v] < glo ? warp_lo[v] : glo;
        ghi = warp_hi[v] > ghi ? warp_hi[v] : ghi;
      }
      const T gnorm = fabs(glo) > fabs(ghi) ? fabs(glo) : fabs(ghi);
      const T pad = tk::mul_rn(tk::add_rn(eps, eps), gnorm);
      s_lo = tk::sub_rn(glo, pad);
      s_hi = tk::add_rn(ghi, pad);
      const T piv = tk::mul_rn(eps, gnorm);
      s_piv = piv > tiny ? piv : tiny;
      s_tau = tk::mul_rn(cluster_rtol, gnorm);
    }
    __syncthreads();
  }

  // 2. multisection: group g of P lanes takes eigenvalue jb + g (+ groups per pass)
  {
    const int groups = nt / P, g = tid / P, l = tid % P;
    const int base = (tid % 32) - l;  // the group's first lane in its warp
    const unsigned gmask = P == 32 ? 0xffffffffu : ((1u << P) - 1u) << base;
    const T frac = div_rn(T(l), T(P));  // exact: P is a power of two
    for (int64_t j0 = jb; j0 < je; j0 += groups) {  // the same trip count in every thread of the block
      const int64_t j = j0 + g;
      bool live = j < je;
      T lo = s_lo, hi = s_hi;
      for (int64_t round = 0; round < rounds; ++round) {
        const T x = l == 0 ? lo : tk::add_rn(lo, tk::mul_rn(tk::sub_rn(hi, lo), frac));
        live = (__ballot_sync(0xffffffffu, live && l > 0 && lo < x && x < hi) & gmask) != 0;
        if (!__any_sync(0xffffffffu, live)) break;
        int64_t count = 0;
        if (live && l > 0) {
          T q = T(1);
          for (int64_t i = 0; i < k; ++i) {
            q = tk::sub_rn(tk::sub_rn(dg[i], x), div_rn(e2[i], q));
            if (fabs(q) < tiny) q = -tiny;
            count += q < T(0);
          }
        }
        const unsigned above = __ballot_sync(0xffffffffu, live && l > 0 && count > j) & gmask;
        const int f = above ? __ffs(above) - 1 - base : P;  // the first probe above j; P: none
        const T x_hi = __shfl_sync(0xffffffffu, x, base + (f < P ? f : 0));
        const T x_lo = __shfl_sync(0xffffffffu, x, base + (f < P ? f - 1 : P - 1));
        if (live) {
          lo = x_lo;
          if (f < P) hi = x_hi;
        }
      }
      if (l == 0 && j < je) ws[j] = tk::mul_rn(T(0.5), tk::add_rn(lo, hi));
    }
  }
  tk::cluster_barrier();  // every eigenvalue of the factor written

  for (int64_t j = tid; j < k; j += nt) lam[j] = ws[j];
  __syncthreads();
  for (int64_t j = tid; j < k; j += nt) joins[j] = j > 0 && tk::sub_rn(lam[j], lam[j - 1]) <= s_tau;
  if (rank == 0) {
    for (int64_t j = k + tid; j < K; j += nt) ws[j] = lam[0];
  }
  for (int64_t i = rank; i < K; i += G) {
    for (int64_t j = (i < k ? k : 0) + tid; j < K; j += nt) Qs[i * K + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();

  const T piv = s_piv;
  for (int64_t step = 0; step < steps; ++step) {
    // 3. one inverse-iteration solve per eigenpair, x normalised in place in Q's column j
    for (int64_t j = jb + tid; j < je; j += nt) {
      T* cp_col = shared_multipliers ? mult + (j - jb) : Cs + j;
      const int64_t cs = shared_multipliers ? per_block : K;
      const T l = lam[j];
      T cp = T(0), dp = T(0);
      for (int64_t i = 0; i < k; ++i) {
        const T r = step == 0 ? start_value<T>(i, j) : Qs[i * K + j];
        const T a = e[i];
        T den = tk::sub_rn(tk::sub_rn(dg[i], l), tk::mul_rn(a, cp));
        if (fabs(den) < piv) den = den < T(0) ? -piv : piv;
        const T num = tk::sub_rn(tk::mul_rn(r, piv), tk::mul_rn(a, dp));
        cp = div_rn(e[i + 1], den);
        dp = div_rn(num, den);
        cp_col[i * cs] = cp;
        Qs[i * K + j] = dp;
      }
      T x = T(0), nrm2 = T(0);
      for (int64_t i = k - 1; i >= 0; --i) {
        x = tk::sub_rn(Qs[i * K + j], tk::mul_rn(cp_col[i * cs], x));
        Qs[i * K + j] = x;
        nrm2 = tk::add_rn(nrm2, tk::mul_rn(x, x));
      }
      T nrm = sqrt_rn(nrm2);
      if (!(nrm > T(0))) nrm = T(1);
      for (int64_t i = 0; i < k; ++i) Qs[i * K + j] = div_rn(Qs[i * K + j], nrm);
    }
    tk::cluster_barrier();  // every column of the factor solved
    // 4. each cluster's first member orthonormalises the others, in index order
    for (int64_t j = jb + tid; j < je; j += nt) {
      if (joins[j] || j + 1 >= k || !joins[j + 1]) continue;
      T* buf = shared_multipliers ? mult + (j - jb) : Cs + j;
      const int64_t bs = shared_multipliers ? per_block : K;
      for (int64_t m = j + 1; m < k && joins[m]; ++m) {
        T* col = Qs + m;
        for (int64_t p = j; p < m; ++p) {
          const T c = tree_dot(col, Qs + p, K, buf, bs, k);
          for (int64_t i = 0; i < k; ++i) col[i * K] = tk::sub_rn(col[i * K], tk::mul_rn(c, Qs[i * K + p]));
        }
        T nrm = sqrt_rn(tree_dot(col, col, K, buf, bs, k));
        if (!(nrm > T(0))) nrm = T(1);
        for (int64_t i = 0; i < k; ++i) col[i * K] = div_rn(col[i * K], nrm);
      }
    }
    if (step + 1 < steps) tk::cluster_barrier();  // the next solve starts from these columns
  }
}

template <typename T>
cudaError_t allow_shared(int64_t smem) {
  static tk::SharedAllowance allowance;
  return tk::allow_shared(reinterpret_cast<const void*>(tridiag_eigh_kernel<T>), allowance, smem, true);
}

bool valid_plan(int64_t k, int64_t P, int64_t G) {
  return k >= 1 && P >= 2 && P <= kMaxLanes && (P & (P - 1)) == 0 && G >= 1 && G <= kMaxCluster;
}

template <typename T>
int launch(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k, int64_t P,
           int64_t rounds, int64_t steps, int64_t G, double eps, double tiny, double cluster_rtol, void* stream) {
  if (d == 0) return 0;
  if (!valid_plan(k, P, G) || k > K || rounds < 0 || steps < 1 || d * G > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout<T>(k, P, G);
  cudaError_t err = allow_shared<T>(L.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tk::cluster_config(d * G, L.threads, G, static_cast<size_t>(L.smem), &attr,
                                                    static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, tridiag_eigh_kernel<T>, static_cast<const T*>(H), static_cast<T*>(w),
                           static_cast<T*>(Q), static_cast<T*>(scratch), K, k, static_cast<int>(P), rounds, steps,
                           static_cast<int>(G), static_cast<int>(L.shared_multipliers), static_cast<T>(eps),
                           static_cast<T>(tiny), static_cast<T>(cluster_rtol));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(int64_t k, int64_t P, int64_t G, int64_t* clusters) {
  const Layout L = layout<T>(k, P, G);
  cudaError_t err = allow_shared<T>(L.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tk::cluster_config(G, L.threads, G, static_cast<size_t>(L.smem), &attr, nullptr);
  int num = 0;
  err = cudaOccupancyMaxActiveClusters(&num, reinterpret_cast<const void*>(tridiag_eigh_kernel<T>), &cfg);
  if (err != cudaSuccess) {  // a cluster size or shape the card refuses: none fits
    cudaGetLastError();
    return 0;
  }
  *clusters = num;
  return 0;
}

}  // namespace

// H (d, K, K) contiguous, active size 1 <= k <= K; w (d, K), Q and scratch
// (d, K, K) on the same device. P: lanes per eigenvalue, a power of two in
// 2..32; rounds: the most multisection rounds; steps: inverse-iteration
// solves (at least 1); G: blocks per factor's cluster, 1..16; eps, tiny: the
// dtype's epsilon and the Sturm count's zero guard; cluster_rtol: the
// cluster gap relative to ||T||. Returns the cudaError_t of the launch.
extern "C" int tk_tridiag_eigh_f32(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k,
                                   int64_t P, int64_t rounds, int64_t steps, int64_t G, double eps, double tiny,
                                   double cluster_rtol, void* stream) {
  return launch<float>(H, w, Q, scratch, d, K, k, P, rounds, steps, G, eps, tiny, cluster_rtol, stream);
}

extern "C" int tk_tridiag_eigh_f64(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k,
                                   int64_t P, int64_t rounds, int64_t steps, int64_t G, double eps, double tiny,
                                   double cluster_rtol, void* stream) {
  return launch<double>(H, w, Q, scratch, d, K, k, P, rounds, steps, G, eps, tiny, cluster_rtol, stream);
}

// Writes to *clusters how many clusters of G blocks of the kernel, laid out
// for active size k and P lanes per eigenvalue in elements of elem_bytes (4
// or 8), the current device holds at once (cudaOccupancyMaxActiveClusters);
// 0 when it cannot launch one. Returns a cudaError_t.
extern "C" int tk_tridiag_eigh_max_clusters(int64_t k, int64_t P, int64_t G, int64_t elem_bytes, int64_t* clusters) {
  *clusters = 0;
  if (!valid_plan(k, P, G) || (elem_bytes != 4 && elem_bytes != 8)) return 0;
  return elem_bytes == 8 ? max_clusters<double>(k, P, G, clusters) : max_clusters<float>(k, P, G, clusters);
}
