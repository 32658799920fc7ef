// The exp-sum sup error for Hopper: max over i of |1 - x_i g(x_i)|, where
// g(x) = sum_j omega_j exp(-alpha_j x) and x_i = exp(i h) is the log-spaced
// grid on [1, kappa] (h = log(kappa) / (n_grid - 1)), in double-double (df64)
// arithmetic.
//
// Replaces: no Pallas kernel. The JAX package computes the same function on
// the host in longdouble (tensorkrylov_tpu/deflate.py:448, expsum_sup_error);
// the port's host copy of it (deflate.py) stays the CPU path. 1 - x g cancels
// down to ~1e-9, so f64 would keep only ~7 digits of the sup; a df64 value
// carries ~106 bits where longdouble carries 64.
//
// Bound on the card: f64 operations. Per (point, term) pair that is not
// skipped, one df64 exp (605 f64 operations, an FMA counted as two) and 36
// more; per point one more exp and 28 (ops/expsum.py:expsum_sup_ops counts
// them from the inputs). At the flagship's row (47 terms, 200 000 points)
// that is 4.58 GFLOP, 0.135 ms at 34 TFLOP/s. Few of the operations are FMAs,
// so the f64 pipes' issue rate (one instruction a lane a clock) sets a floor
// near twice that. Bytes: the 47 terms' 752 and one 8-byte result. The design
// keeps the f64 pipes fed and touches no memory:
//   - one thread per grid point, 256 a block: 782 blocks at the flagship; at
//     38 registers a thread an SM holds 6 blocks, so the grid runs in one
//     wave, and 48 warps an SM hide the f64 latency of each thread's serial
//     df64 chain;
//   - omega and alpha travel in the launch's parameter block (by value, no
//     upload, no sync) and are read at a uniform index, one broadcast from
//     the constant cache per term;
//   - terms whose exponent lies below -745 (exp rounds to 0 in f64: a
//     contribution below 1e-300, far under longdouble's 1e-19) are skipped;
//   - the maximum is reduced over the warp by shuffles and over the block in
//     shared memory, then one atomicMax per block on the f64 bit pattern:
//     every r is non-negative, so its bits order as unsigned integers (a NaN
//     sorts above inf, as numpy's max propagates it), and a maximum does not
//     depend on the order of the atomics: the result is the same every run.
//     One launch, no second pass and no scratch.
//
// The df64 operations are QD's (Hida, Li and Bailey): TwoSum, FastTwoSum, and
// TwoProduct by FMA (exact, so equal to the plain version's Dekker split);
// every other product and sum is rounded on its own (no FMA contraction), so
// the kernel gives the plain version's bits (ops/expsum.py). exp_dd is QD's
// dd_real exp with a fixed number of terms: m = rint(a / ln2), r = (a - m
// ln2) / 2^9, the Taylor series of e^r - 1 to r^8 / 8!, nine doublings
// s <- 2 s + s^2, then (1 + s) 2^m.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 63;               // the coefficient tables' TMAX
constexpr double kArgMin = -745.0;          // exp(a) rounds to 0 in f64 below this
constexpr int kHalvings = 9;                // r = (a - m ln2) / 2^9
constexpr double kInvK = 0x1p-9;
constexpr double kInvLn2 = 0x1.71547652b82fep+0;
constexpr double kLn2Hi = 0x1.62e42fefa39efp-1, kLn2Lo = 0x1.abc9e3b39803fp-56;

struct ExpSumTerms {
  double omega[kMaxTerms];
  double alpha[kMaxTerms];
};

struct dd {
  double hi, lo;
};

using tk::add_rn;
using tk::mul_rn;
using tk::sub_rn;

__device__ __forceinline__ dd two_sum(double a, double b) {
  const double s = add_rn(a, b), bb = sub_rn(s, a);
  return {s, add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(b, bb))};
}

__device__ __forceinline__ dd fast_two_sum(double a, double b) {
  const double s = add_rn(a, b);
  return {s, sub_rn(b, sub_rn(s, a))};
}

__device__ __forceinline__ dd two_prod(double a, double b) {
  const double p = mul_rn(a, b);
  return {p, __fma_rn(a, b, -p)};
}

__device__ __forceinline__ dd dd_add(dd a, dd b) {
  const dd s = two_sum(a.hi, b.hi), t = two_sum(a.lo, b.lo);
  const dd u = fast_two_sum(s.hi, add_rn(s.lo, t.hi));
  return fast_two_sum(u.hi, add_rn(u.lo, t.lo));
}

__device__ __forceinline__ dd dd_add_d(dd a, double b) {
  const dd s = two_sum(a.hi, b);
  return fast_two_sum(s.hi, add_rn(s.lo, a.lo));
}

__device__ __forceinline__ dd dd_mul(dd a, dd b) {
  const dd p = two_prod(a.hi, b.hi);
  return fast_two_sum(p.hi, add_rn(p.lo, add_rn(mul_rn(a.hi, b.lo), mul_rn(a.lo, b.hi))));
}

__device__ __forceinline__ dd dd_mul_d(dd a, double b) {
  const dd p = two_prod(a.hi, b);
  return fast_two_sum(p.hi, add_rn(p.lo, mul_rn(a.lo, b)));
}

__device__ __forceinline__ dd dd_scale(dd a, double s) { return {mul_rn(a.hi, s), mul_rn(a.lo, s)}; }

// 2^e for e in [-1022, 1023], built from its bits
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
}

// 1/(i+3)! as df64 pairs, i = 0..5, in constant memory: the unrolled loop reads them at fixed offsets
__constant__ double kInvFactHi[6] = {0x1.5555555555555p-3, 0x1.5555555555555p-5, 0x1.1111111111111p-7,
                                     0x1.6c16c16c16c17p-10, 0x1.a01a01a01a01ap-13, 0x1.a01a01a01a01ap-16};
__constant__ double kInvFactLo[6] = {0x1.5555555555555p-57, 0x1.5555555555555p-59, 0x1.1111111111111p-63,
                                     -0x1.f49f49f49f49fp-65, 0x1.a01a01a01a01ap-73, 0x1.a01a01a01a01ap-76};

__device__ __forceinline__ dd inv_fact(int i) { return {kInvFactHi[i], kInvFactLo[i]}; }

// e^a in df64 for a.hi in [kArgMin, 709]; relative error ~1e-31 where the result is above ~1e-287 (below,
// its low part lies in f64's subnormal range: an absolute error under 1e-320)
__device__ __forceinline__ dd exp_dd(dd a) {
  const double m = rint(mul_rn(a.hi, kInvLn2));
  const dd ml = two_prod(m, kLn2Hi);
  const dd m_ln2 = fast_two_sum(ml.hi, add_rn(ml.lo, mul_rn(m, kLn2Lo)));
  const dd r = dd_scale(dd_add(a, {-m_ln2.hi, -m_ln2.lo}), kInvK);
  dd p = dd_mul(r, r);
  dd s = dd_add(r, dd_scale(p, 0.5));
  p = dd_mul(p, r);
  dd t = dd_mul(p, inv_fact(0));
#pragma unroll
  for (int i = 1; i < 6; ++i) {
    s = dd_add(s, t);
    p = dd_mul(p, r);
    t = dd_mul(p, inv_fact(i));
  }
  s = dd_add(s, t);
#pragma unroll
  for (int i = 0; i < kHalvings; ++i) s = dd_add(dd_scale(s, 2.0), dd_mul(s, s));
  s = dd_add_d(s, 1.0);
  // (1 + s) 2^m as two exact scalings, the second only below the normal range
  const int e = static_cast<int>(m);
  const bool low = e < -1022;
  const double s1 = pow2(low ? e + 64 : e), s2 = pow2(low ? -64 : 0);
  return dd_scale(dd_scale(s, s1), s2);
}

// |1 - x_i g(x_i)| rounded to f64, as its bit pattern
__device__ __forceinline__ unsigned long long residual_bits(const ExpSumTerms& c, int terms, double h_hi,
                                                            double h_lo, int64_t i) {
  const double fi = static_cast<double>(i);
  const dd u = dd_mul_d({h_hi, h_lo}, fi);
  const dd x = exp_dd(u);
  dd g = {0.0, 0.0};
  for (int j = 0; j < terms; ++j) {
    const dd ax = dd_mul_d(x, c.alpha[j]);
    if (ax.hi <= -kArgMin) g = dd_add(g, dd_mul_d(exp_dd({-ax.hi, -ax.lo}), c.omega[j]));
  }
  const dd q = dd_mul(x, g);
  const dd r = dd_add_d({-q.hi, -q.lo}, 1.0);
  return static_cast<unsigned long long>(__double_as_longlong(fabs(r.hi)));
}

__global__ void __launch_bounds__(kThreads)
    expsum_sup_kernel(const __grid_constant__ ExpSumTerms c, int terms, double h_hi, double h_lo, int64_t n_grid,
                      unsigned long long* __restrict__ out) {
  __shared__ unsigned long long warp_max[kThreads / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long v = i < n_grid ? residual_bits(c, terms, h_hi, h_lo, i) : 0ull;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w > v ? w : v;
    }
    if (lane == 0) atomicMax(out, v);
  }
}

}  // namespace

// omega and alpha: `terms` f64 values each in host memory (at most 63, zero
// omegas already left out), copied into the launch's parameters; h = h_hi +
// h_lo the grid's step in log x; out: one f64 on the device, zeroed by the
// caller, that receives the maximum. Returns the cudaError_t of the launch.
extern "C" int tk_expsum_sup_f64(const double* omega, const double* alpha, int64_t terms, double h_hi,
                                 double h_lo, int64_t n_grid, void* out, void* stream) {
  if (terms < 0 || terms > kMaxTerms || n_grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  ExpSumTerms c = {};
  for (int64_t j = 0; j < terms; ++j) {
    c.omega[j] = omega[j];
    c.alpha[j] = alpha[j];
  }
  const int64_t blocks = (n_grid + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  expsum_sup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<int>(terms), h_hi, h_lo, n_grid, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
