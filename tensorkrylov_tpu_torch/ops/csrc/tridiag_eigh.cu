// Symmetric tridiagonal eigensolver for Hopper: the eigenpairs of the active
// k x k blocks of d padded (K, K) tridiagonal matrices H (the Lanczos H_s).
//
// Replaces: tensorkrylov_tpu/ops/eigen.py:masked_eigh_tridiag_mixed (L182),
// which the JAX package runs outside Pallas, as lax.scan recurrences (an f32
// dense eigh for seed pairs, f64 Rayleigh quotients, one batched Thomas
// inverse-iteration step). The card has native f64, so no f32 seed: each
// eigenvalue comes from Sturm bisection and each vector from inverse
// iteration. The Newton–Schulz re-orthonormalisation after it stays two f64
// GEMMs per step in ops/eigen.py, as in the JAX package.
//
// Bound on the card: latency. The work is a few k-step recurrences per
// eigenpair (the Sturm count in each bisection step, the Thomas sweeps), each
// step waiting on the previous one's division; the bytes (H's 2k entries in,
// the K x K Q out) and the operations are far below what the card moves and
// computes in that time.
//
// Design: one block per factor s, one thread per eigenvalue index j (a strided
// loop past 512). The block reads the diagonal and sub-diagonal straight from
// H (stride K+1) into shared memory, where every thread's recurrences read
// them as broadcasts. Then:
//   1. Gershgorin bracket [lo, hi] of the active rows, widened by 2 eps ||T||
//      (||T|| = max(|lo|, |hi|)), by one thread (min/max are exact);
//   2. each thread bisects eigenvalue j: at most n_iter halvings, a bracket
//      that can no longer shrink (mid equals lo or hi) stops; the count of
//      eigenvalues below mid is ops/eigen.py:_sturm_count's recurrence and
//      zero guard, over the k active rows only;
//   3. `steps` inverse-iteration solves (T - lambda_j I) x = piv r of the JAX
//      package's _thomas_solve (L144-179), its pivots guarded to at least
//      piv = eps ||T|| in magnitude (the right side scaled by piv keeps x
//      near unit size at any scale of T), from a hashed start vector r
//      distinct per j, then from the last result; each x normalised;
//   4. after each solve, clusters (consecutive eigenvalues within
//      cluster_rtol ||T|| of each other) are made orthonormal by their first
//      member's thread: modified Gram-Schmidt in index order, each dot product
//      summed in a fixed halving tree. Newton–Schulz cannot separate vectors
//      that inverse iteration made nearly parallel (near-equal eigenvalues);
//      above the gap, separately computed vectors are orthogonal to
//      eps ||T|| / gap, which Newton–Schulz's two steps take to eps.
// Padded eigenvalue slots hold lambda_0 and padded columns of Q are the
// identity's. Every product, sum, quotient and root is rounded on its own
// (no FMA), in the order of the plain version
// ops/eigen.py:masked_eigh_tridiag_reference, so the two agree bit for bit.
// Scratch (d, K, K) holds the forward sweep's multipliers and the tree sums.
#include "tk_common.cuh"

namespace {

// Threads per block: at 90 registers a thread (f64, ptxas on sm_90a) 512 fit an SM's 65,536.
constexpr int64_t kMaxThreads = 512;

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

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

// sum_i x[i] y[i] over n entries at the given stride, in a fixed halving tree
// (entry i + half added to entry i, half = ceil(len / 2), until one is left),
// the products kept in buf.
template <typename T>
__device__ T tree_dot(const T* x, const T* y, T* buf, int64_t stride, int64_t n) {
  for (int64_t i = 0; i < n; ++i) buf[i * stride] = tk::mul_rn(x[i * stride], y[i * stride]);
  for (int64_t len = n; len > 1;) {
    const int64_t half = (len + 1) / 2;
    for (int64_t i = 0; i < len - half; ++i) buf[i * stride] = tk::add_rn(buf[i * stride], buf[(i + half) * stride]);
    len = half;
  }
  return buf[0];
}

template <typename T>
__global__ void tridiag_eigh_kernel(const T* __restrict__ H, T* __restrict__ w, T* Q, T* scratch, int64_t K,
                                    int64_t k, int64_t n_iter, int64_t steps, T eps, T tiny, T cluster_rtol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dg = reinterpret_cast<T*>(smem_raw);   // diagonal, k
  T* e = dg + k;                            // e[i] couples rows i-1 and i; e[0] = e[k] = 0
  T* e2 = e + k + 1;                        // e[i]^2, k
  T* lam = e2 + k;                          // eigenvalues, k
  int* joins = reinterpret_cast<int*>(lam + k);  // joins[j]: j is in j-1's cluster
  __shared__ T s_lo, s_hi, s_piv, s_tau;

  const int64_t s = blockIdx.x;
  const T* Hs = H + s * K * K;
  T* Qs = Q + s * K * K;
  T* Cs = scratch + s * K * K;
  T* ws = w + s * K;
  const int64_t tid = threadIdx.x, nt = blockDim.x;

  for (int64_t i = tid; i <= k; i += nt) {
    const T ei = (i > 0 && i < k) ? Hs[i * (K + 1) - 1] : T(0);
    e[i] = ei;
    if (i < k) {
      dg[i] = Hs[i * (K + 1)];
      e2[i] = tk::mul_rn(ei, ei);
    }
  }
  __syncthreads();

  if (tid == 0) {
    T glo = T(0), ghi = T(0);
    for (int64_t i = 0; i < k; ++i) {
      const T r = tk::add_rn(fabs(e[i]), fabs(e[i + 1]));
      const T lo_i = tk::sub_rn(dg[i], r), hi_i = tk::add_rn(dg[i], r);
      glo = (i == 0 || lo_i < glo) ? lo_i : glo;
      ghi = (i == 0 || hi_i > ghi) ? hi_i : ghi;
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

  // 2. bisection: eigenvalue j (ascending) is where the count below x passes j
  for (int64_t j = tid; j < k; j += nt) {
    T lo = s_lo, hi = s_hi;
    for (int64_t it = 0; it < n_iter; ++it) {
      const T mid = tk::mul_rn(T(0.5), tk::add_rn(lo, hi));
      if (mid == lo || mid == hi) break;
      int64_t count = 0;
      T q = T(1);
      for (int64_t i = 0; i < k; ++i) {
        q = tk::sub_rn(tk::sub_rn(dg[i], mid), div_rn(e2[i], q));
        if (fabs(q) < tiny) q = -tiny;
        count += q < T(0);
      }
      if (count <= j) lo = mid;
      else hi = mid;
    }
    const T l = tk::mul_rn(T(0.5), tk::add_rn(lo, hi));
    lam[j] = l;
    ws[j] = l;
  }
  __syncthreads();

  for (int64_t j = k + tid; j < K; j += nt) ws[j] = lam[0];
  for (int64_t i = 0; i < K; ++i) {
    for (int64_t j = (i < k ? k : 0) + tid; j < K; j += nt) Qs[i * K + j] = i == j ? T(1) : T(0);
  }
  for (int64_t j = tid; j < k; j += nt) joins[j] = j > 0 && tk::sub_rn(lam[j], lam[j - 1]) <= s_tau;
  __syncthreads();

  const T piv = s_piv;
  for (int64_t step = 0; step < steps; ++step) {
    // 3. one inverse-iteration solve per eigenpair, x normalised in place in Q's column j
    for (int64_t j = tid; j < k; j += nt) {
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
        Cs[i * K + j] = cp;
        Qs[i * K + j] = dp;
      }
      T x = T(0), nrm2 = T(0);
      for (int64_t i = k - 1; i >= 0; --i) {
        x = tk::sub_rn(Qs[i * K + j], tk::mul_rn(Cs[i * K + j], x));
        Qs[i * K + j] = x;
        nrm2 = tk::add_rn(nrm2, tk::mul_rn(x, x));
      }
      T nrm = sqrt_rn(nrm2);
      if (!(nrm > T(0))) nrm = T(1);
      for (int64_t i = 0; i < k; ++i) Qs[i * K + j] = div_rn(Qs[i * K + j], nrm);
    }
    __syncthreads();
    // 4. each cluster's first member orthonormalises the others, in index order
    for (int64_t j = tid; j < k; j += nt) {
      if (joins[j] || j + 1 >= k || !joins[j + 1]) continue;
      for (int64_t m = j + 1; m < k && joins[m]; ++m) {
        T* col = Qs + m;
        for (int64_t p = j; p < m; ++p) {
          const T c = tree_dot(col, Qs + p, Cs + m, K, k);
          for (int64_t i = 0; i < k; ++i) col[i * K] = tk::sub_rn(col[i * K], tk::mul_rn(c, Qs[i * K + p]));
        }
        T nrm = sqrt_rn(tree_dot(col, col, Cs + m, K, k));
        if (!(nrm > T(0))) nrm = T(1);
        for (int64_t i = 0; i < k; ++i) col[i * K] = div_rn(col[i * K], nrm);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k, int64_t n_iter,
           int64_t steps, double eps, double tiny, double cluster_rtol, void* stream) {
  if (d == 0) return 0;
  if (k < 1 || k > K || n_iter < 0 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  static tk::SharedAllowance allowance;
  const int64_t bytes = (4 * k + 1) * static_cast<int64_t>(sizeof(T)) + k * static_cast<int64_t>(sizeof(int));
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        tk::allow_shared(reinterpret_cast<const void*>(tridiag_eigh_kernel<T>), allowance, bytes, false);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t want = ((k + 31) / 32) * 32;
  const int threads = static_cast<int>(want < kMaxThreads ? want : kMaxThreads);
  tridiag_eigh_kernel<T><<<static_cast<unsigned>(d), threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<T*>(w), static_cast<T*>(Q), static_cast<T*>(scratch), K, k, n_iter,
      steps, static_cast<T>(eps), static_cast<T>(tiny), static_cast<T>(cluster_rtol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H (d, K, K) contiguous, active size 1 <= k <= K; w (d, K), Q and scratch
// (d, K, K) on the same device. n_iter: the most bisection halvings; steps:
// inverse-iteration solves (at least 1); eps, tiny: the dtype's epsilon and the Sturm
// count's zero guard; cluster_rtol: the cluster gap relative to ||T||.
// Returns the cudaError_t of the launch.
extern "C" int tk_tridiag_eigh_f32(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k,
                                   int64_t n_iter, int64_t steps, double eps, double tiny, double cluster_rtol,
                                   void* stream) {
  return launch<float>(H, w, Q, scratch, d, K, k, n_iter, steps, eps, tiny, cluster_rtol, stream);
}

extern "C" int tk_tridiag_eigh_f64(const void* H, void* w, void* Q, void* scratch, int64_t d, int64_t K, int64_t k,
                                   int64_t n_iter, int64_t steps, double eps, double tiny, double cluster_rtol,
                                   void* stream) {
  return launch<double>(H, w, Q, scratch, d, K, k, n_iter, steps, eps, tiny, cluster_rtol, stream);
}
