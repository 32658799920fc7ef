// Eigenvalues and right eigenvectors of upper Hessenberg matrices for Hopper:
// the active k x k blocks of d factors H (d, K, K) f64, one thread block per
// factor, all in one launch.
//
// Replaces: no Pallas kernel. The nonsymmetric check (ops/expsum.py,
// cp_solve_nonsym_eig) called torch.linalg.eig on the padded (d, K, K) stack,
// a library geev that reduces Arnoldi's H to Hessenberg form again, runs the
// factors one after another in thousands of small launches and waits for the
// host between them. The algorithm here is LAPACK's, in f64 throughout:
// dlahqr (implicit Francis double-shift QR with Schur vectors: the
// Ahues-Kressner deflation test, exceptional shifts after 10 and 20
// iterations, dlanv2 on each 2 x 2 block, at most 30 max(10, k) iterations a
// factor), then dtrevc3's back-substitution on the quasi-triangular T for
// each eigenvalue. The caller forms V = Z X (one batched GEMM) and its unit
// columns (ops/hess_eig.py, whose plain version runs the same sweeps).
//
// Bound on the card: neither bytes nor operations. At k = 304 a factor's QR
// is ~10 k^3 f64 operations (~0.3 GFLOP, ~10 us of the card's 34 TFLOP/s),
// but it is a chain of ~c k^2 dependent bulge-chasing steps (c ~ 1-2), each
// of which needs the previous step's reflector. The design makes each step
// cheap and keeps all other work off that chain:
//   - one block of 512 threads per factor (the d factors run side by side);
//     T (row-major) and Z (column-major) live in global scratch, 1.5 MB a
//     factor at k = 304, resident in L2;
//   - the chain is one thread: it holds the 4 x 4 window of T around the
//     bulge in registers (rows s..s+3, columns s-1..s+2), applies step s's
//     reflector from both sides to it and forms step s+1's reflector there,
//     so it never reads T from memory except the new column, which the
//     column's owner hands over through shared memory, and the diagonal and
//     subdiagonal, staged in shared memory at the sweep's start;
//   - 480 column threads apply each reflector from the left to the columns
//     right of the window, each its own column (up to 3), with its three rows
//     in registers and the next rows (not yet touched in this sweep) loaded
//     two steps ahead; one barrier a step publishes the next reflector (the
//     chain's warp and the column warps run the step loop in separate
//     branches, so their registers are never live at once);
//   - the right-hand updates of the rows above the bulge and the updates of
//     Z touch nothing the chain reads in this sweep, so they wait for the
//     sweep's end and then run as independent row chains, one thread each,
//     the reflectors read from shared memory and each element loaded eight
//     steps ahead: the same operations on each element in the same order as
//     dlahqr's, off the chain;
//   - the deflation test and the search for the sweep's start run over all
//     threads at once, the largest qualifying index by an atomicMax;
//   - the back-substitution runs one warp per eigenvalue (a complex pair
//     once, its conjugate written beside it), each row a warp dot product.
// T packed in a four-block cluster's distributed shared memory was
// considered and not taken: with the window in registers the chain reads
// nothing but shared memory, and the rest is off the chain, so a cluster's
// barriers would cost more per step than they could save.
//
// Outputs: w (d, k) complex as interleaved pairs; Z column-major; X
// column-major interleaved complex (the eigenvectors of T, each column scaled
// so that its largest |re| + |im| is 1); info (d,) int32, 0 or one more than
// the row where the iteration cap stopped it; stats (d, 3) int64, written
// only where the caller passes it (a measurement; the solver passes null): QR
// iterations, bulge steps, and f64 operations (an FMA counted as two) of the
// sweeps, rotations and back-substitution, counted as the plain version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kColThreads = kThreads - 32;   // warp 0 holds the chain
constexpr int kMaxK = 1024;                  // ops/hess_eig.py MAX_K
constexpr int kCols = (kMaxK + kColThreads - 1) / kColThreads;
constexpr int kWarps = kThreads / 32;
constexpr double kUlp = 0x1p-52;             // dlamch('P')
constexpr double kSafMin = 0x1p-1022;        // dlamch('S')
constexpr double kBig = 0x1p500;             // eigenvector rescale threshold
constexpr double kDat1 = 0.75, kDat2 = -0.4375;
constexpr int kExSh = 10;
constexpr int kIterCapPerRow = 30;

struct Refl {
  double beta, v2, v3, tau;
};

__device__ __forceinline__ double sign_of(double a, double b) { return copysign(fabs(a), b); }

// dlarfg on (alpha, x1[, x2]); nr = 2 takes x1 alone. It is on the chain,
// so where no square can leave the normal range the norm of (alpha, x) comes
// from one reciprocal square root r, with tau = (beta - alpha)/beta =
// 1 + |alpha| r and 1/(alpha - beta) = sign(alpha)/(|alpha| + norm), neither
// of which cancels; outside that range dlarfg's own formulas on dlapy2's
// scaled norms.
__device__ __forceinline__ Refl larfg(double alpha, double x1, double x2, int nr) {
  if (nr != 3) x2 = 0.0;
  if (x1 == 0.0 && x2 == 0.0) return {alpha, x1, x2, 0.0};
  const double mx = fmax(fabs(alpha), fmax(fabs(x1), fabs(x2)));
  double nrm, tau, sc;
  if (mx > 0x1p-480 && mx < 0x1p480) {
    const double s2 = alpha * alpha + (x1 * x1 + x2 * x2);
    const double r = rsqrt(s2);
    nrm = s2 * r;
    tau = fma(fabs(alpha), r, 1.0);
    sc = copysign(1.0 / (fabs(alpha) + nrm), alpha);
  } else {
    nrm = hypot(alpha, hypot(x1, x2));
    const double b = -sign_of(nrm, alpha);
    tau = (b - alpha) / b;
    sc = 1.0 / (alpha - b);
  }
  return {-sign_of(nrm, alpha), x1 * sc, x2 * sc, tau};
}

__device__ __forceinline__ double at(const double* T, int k, int r, int c) { return T[(int64_t)r * k + c]; }

__device__ bool negligible(const double* T, int k, int kk, double smlnum) {
  const double h = fabs(at(T, k, kk, kk - 1));
  if (h <= smlnum) return true;
  double tst = fabs(at(T, k, kk - 1, kk - 1)) + fabs(at(T, k, kk, kk));
  if (tst == 0.0) {
    if (kk - 2 >= 0) tst += fabs(at(T, k, kk - 1, kk - 2));
    if (kk + 1 <= k - 1) tst += fabs(at(T, k, kk + 1, kk));
  }
  if (h <= kUlp * tst) {
    const double up = fabs(at(T, k, kk - 1, kk));
    const double ab = fmax(h, up), ba = fmin(h, up);
    const double dk = fabs(at(T, k, kk, kk)), diff = fabs(at(T, k, kk - 1, kk - 1) - at(T, k, kk, kk));
    const double aa = fmax(dk, diff), bb = fmin(dk, diff);
    const double s = aa + ab;
    if (ba * (ab / s) <= fmax(smlnum, kUlp * (bb * (aa / s)))) return true;
  }
  return false;
}

struct Shifts {
  double rt1r, rt1i, rt2r, rt2i;
};

__device__ Shifts shifts(const double* T, int k, int l, int i, int kdefl) {
  double h11, h12, h21, h22;
  if (kdefl % (2 * kExSh) == 0) {
    const double s = fabs(at(T, k, i, i - 1)) + fabs(at(T, k, i - 1, i - 2));
    h11 = kDat1 * s + at(T, k, i, i);
    h12 = kDat2 * s;
    h21 = s;
    h22 = h11;
  } else if (kdefl % kExSh == 0) {
    const double s = fabs(at(T, k, l + 1, l)) + fabs(at(T, k, l + 2, l + 1));
    h11 = kDat1 * s + at(T, k, l, l);
    h12 = kDat2 * s;
    h21 = s;
    h22 = h11;
  } else {
    h11 = at(T, k, i - 1, i - 1);
    h21 = at(T, k, i, i - 1);
    h12 = at(T, k, i - 1, i);
    h22 = at(T, k, i, i);
  }
  const double s = fabs(h11) + fabs(h12) + fabs(h21) + fabs(h22);
  if (s == 0.0) return {0.0, 0.0, 0.0, 0.0};
  h11 /= s;
  h21 /= s;
  h12 /= s;
  h22 /= s;
  const double tr = (h11 + h22) / 2.0;
  const double det = (h11 - tr) * (h22 - tr) - h12 * h21;
  const double rtdisc = sqrt(fabs(det));
  if (det >= 0.0) return {tr * s, rtdisc * s, tr * s, -(rtdisc * s)};
  const double rt1r = tr + rtdisc, rt2r = tr - rtdisc;
  const double rt = fabs(rt1r - h22) <= fabs(rt2r - h22) ? rt1r * s : rt2r * s;
  return {rt, 0.0, rt, 0.0};
}

// dlahqr's V at row m: the first column of (T - s1)(T - s2), scaled
__device__ void shift_vector(const double* T, int k, int m, const Shifts& sh, double& v1, double& v2, double& v3) {
  const double tmm = at(T, k, m, m), t1m = at(T, k, m + 1, m);
  double s = fabs(tmm - sh.rt2r) + fabs(sh.rt2i) + fabs(t1m);
  const double h21s = t1m / s;
  v1 = h21s * at(T, k, m, m + 1) + (tmm - sh.rt1r) * ((tmm - sh.rt2r) / s) - sh.rt1i * (sh.rt2i / s);
  v2 = h21s * (tmm + at(T, k, m + 1, m + 1) - sh.rt1r - sh.rt2r);
  v3 = h21s * at(T, k, m + 2, m + 1);
  s = fabs(v1) + fabs(v2) + fabs(v3);
  v1 /= s;
  v2 /= s;
  v3 /= s;
}

struct Lanv2 {
  double a, b, c, d, rt1r, rt1i, rt2r, rt2i, cs, sn;
};

__device__ Lanv2 lanv2(double a, double b, double c, double d) {
  double cs, sn;
  if (c == 0.0) {
    cs = 1.0;
    sn = 0.0;
  } else if (b == 0.0) {
    cs = 0.0;
    sn = 1.0;
    const double t = d;
    d = a;
    a = t;
    b = -c;
    c = 0.0;
  } else if ((a - d) == 0.0 && copysign(1.0, b) != copysign(1.0, c)) {
    cs = 1.0;
    sn = 0.0;
  } else {
    double temp = a - d;
    double p = 0.5 * temp;
    const double bcmax = fmax(fabs(b), fabs(c));
    const double bcmis = fmin(fabs(b), fabs(c)) * copysign(1.0, b) * copysign(1.0, c);
    const double scale = fmax(fabs(p), bcmax);
    double z = (p / scale) * p + (bcmax / scale) * bcmis;
    if (z >= 4.0 * kUlp) {
      z = p + sign_of(sqrt(scale) * sqrt(z), p);
      a = d + z;
      d = d - (bcmax / z) * bcmis;
      const double tau = hypot(c, z);
      cs = z / tau;
      sn = c / tau;
      b = b - c;
      c = 0.0;
    } else {
      const double sigma = b + c;
      const double tau = hypot(sigma, temp);
      cs = sqrt(0.5 * (1.0 + fabs(sigma) / tau));
      sn = -(p / (tau * cs)) * copysign(1.0, sigma);
      const double aa = a * cs + b * sn, bb = -a * sn + b * cs;
      const double cc = c * cs + d * sn, dd = -c * sn + d * cs;
      a = aa * cs + cc * sn;
      b = bb * cs + dd * sn;
      c = -aa * sn + cc * cs;
      d = -bb * sn + dd * cs;
      temp = 0.5 * (a + d);
      a = temp;
      d = temp;
      if (c != 0.0) {
        if (b != 0.0) {
          if (copysign(1.0, b) == copysign(1.0, c)) {
            const double sab = sqrt(fabs(b)), sac = sqrt(fabs(c));
            p = sign_of(sab * sac, c);
            const double t2 = 1.0 / sqrt(fabs(b + c));
            a = temp + p;
            d = temp - p;
            b = b - c;
            c = 0.0;
            const double cs1 = sab * t2, sn1 = sac * t2;
            const double t3 = cs * cs1 - sn * sn1;
            sn = cs * sn1 + sn * cs1;
            cs = t3;
          }
        } else {
          b = -c;
          c = 0.0;
          const double t = cs;
          cs = -sn;
          sn = t;
        }
      }
    }
  }
  const double rt1i = c == 0.0 ? 0.0 : sqrt(fabs(b)) * sqrt(fabs(c));
  return {a, b, c, d, a, rt1i, d, -rt1i, cs, sn};
}

struct Smem {
  double refl[3 * kMaxK];   // v2, v3, tau of each step of the sweep
  double diag[kMaxK];       // T[r, r] and T[r, r-1] at the sweep's start
  double sub[kMaxK];
  double hand[2][2];        // a column's two rows handed to the chain, by step parity
  double rot[2];            // dlanv2's cs, sn
  int kk, m;
  unsigned long long ops;
};

__device__ __forceinline__ void left3(double (&W)[4][4], int b, double v2, double v3, double t1, double t2,
                                      double t3) {
  const double sum = W[0][b] + v2 * W[1][b] + v3 * W[2][b];
  W[0][b] -= sum * t1;
  W[1][b] -= sum * t2;
  W[2][b] -= sum * t3;
}

__device__ __forceinline__ void right3(double (&W)[4][4], int a, double v2, double v3, double t1, double t2,
                                       double t3) {
  const double sum = W[a][1] + v2 * W[a][2] + v3 * W[a][3];
  W[a][1] -= sum * t1;
  W[a][2] -= sum * t2;
  W[a][3] -= sum * t3;
}

// A row chain of the deferred updates: x[c] = p[c * stride] for the columns
// c = s0..i, the sweep's reflectors s = s0..i-1 applied from the right. Each
// element is loaded kAhead steps before its use (the loop is unrolled by
// kAhead so that the ring of loads in flight stays in registers): the
// elements were final when the chain phase ended, and a load from L2 takes
// longer than a few steps of this chain.
constexpr int kAhead = 8;

__device__ void row_chain(double* p, int64_t stride, int s0, int m, int i, const double* refl) {
  double x0 = p[s0 * stride], x1 = p[(s0 + 1) * stride];
  double x2 = s0 + 2 <= i ? p[(s0 + 2) * stride] : 0.0;
  double ring[kAhead];   // at a group's first step s, ring[u] = x[s + 3 + u]
#pragma unroll
  for (int u = 0; u < kAhead; ++u) ring[u] = s0 + 3 + u <= i ? p[(s0 + 3 + u) * stride] : 0.0;
  for (int s = s0; s < i; s += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = s + u;
      if (t < i) {
        const double v2 = refl[3 * (t - m)], v3 = refl[3 * (t - m) + 1], t1 = refl[3 * (t - m) + 2];
        const double t2 = t1 * v2;
        if (t < i - 1) {
          const double t3 = t1 * v3;
          const double sum = x0 + v2 * x1 + v3 * x2;
          x0 -= sum * t1;
          x1 -= sum * t2;
          x2 -= sum * t3;
          p[t * stride] = x0;
          x0 = x1;
          x1 = x2;
          x2 = ring[u];
          ring[u] = t + 3 + kAhead <= i ? p[(t + 3 + kAhead) * stride] : 0.0;
        } else {
          const double sum = x0 + v2 * x1;
          x0 -= sum * t1;
          x1 -= sum * t2;
          p[t * stride] = x0;
          p[(t + 1) * stride] = x1;
        }
      }
    }
  }
}

// The step loop's barrier. Warp 0 (the chain) and the column warps run the
// loop in separate branches, each warp converged at every barrier and every
// thread passing the same number of them, so that the chain's registers and
// the columns' are never live at once.
__device__ __forceinline__ void step_barrier() { asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory"); }

// One double-shift sweep over rows and columns m..i (dlahqr's loop 130).
// Every thread calls it; it ends after a __syncthreads.
__device__ void sweep(double* T, double* Zc, int k, int l, int m, int i, const Shifts& sh, Smem& sm,
                      long long& ops) {
  const int tid = threadIdx.x;
  for (int r = m + tid; r <= i; r += kThreads) {
    sm.diag[r] = at(T, k, r, r);
    sm.sub[r] = r > 0 ? at(T, k, r, r - 1) : 0.0;
  }
  if (tid < 32) {
    // the chain: the window W (rows s..s+3, columns s-1..s+2) and the step's reflector
    double W[4][4];
    double beta = 0.0, v2 = 0.0, v3 = 0.0, t1 = 0.0;
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = m + a, c = m - 1 + b;
          W[a][b] = (r <= i && c >= 0) ? at(T, k, r, c) : 0.0;
        }
      double x1, x2, x3;
      shift_vector(T, k, m, sh, x1, x2, x3);
      const Refl f = larfg(x1, x2, x3, 3);
      beta = f.beta;
      v2 = f.v2;
      v3 = f.v3;
      t1 = f.tau;
      sm.refl[0] = v2;
      sm.refl[1] = v3;
      sm.refl[2] = t1;
    }
    step_barrier();
    for (int s = m; s < i; ++s) {
      const bool three = s < i - 1;   // the step's reflector has order 3 (else 2: the last step)
      if (tid == 0) {
        if (s > m && three) {         // column s+2 arrives from its owner; its rows s+2, s+3 are untouched
          W[0][3] = sm.hand[(s - 1) & 1][0];
          W[1][3] = sm.hand[(s - 1) & 1][1];
          W[2][3] = sm.diag[s + 2];
          W[3][3] = s + 3 <= i ? sm.sub[s + 3] : 0.0;
        }
        const double t2 = t1 * v2, t3 = t1 * v3;
        if (s > m) {
          W[0][0] = beta;
          W[1][0] = 0.0;
          if (three) W[2][0] = 0.0;
        } else if (m > l) {
          W[0][0] = W[0][0] * (1.0 - t1);
        }
        if (three) {
          left3(W, 1, v2, v3, t1, t2, t3);
          left3(W, 2, v2, v3, t1, t2, t3);
          left3(W, 3, v2, v3, t1, t2, t3);
          right3(W, 0, v2, v3, t1, t2, t3);
          right3(W, 1, v2, v3, t1, t2, t3);
          right3(W, 2, v2, v3, t1, t2, t3);
          if (s + 3 <= i) right3(W, 3, v2, v3, t1, t2, t3);
          // step s+1's reflector from column s, rows s+1..s+3
          const bool next3 = s + 1 < i - 1;
          const Refl f = larfg(W[1][1], W[2][1], next3 ? W[3][1] : 0.0, next3 ? 3 : 2);
          beta = f.beta;
          v2 = f.v2;
          v3 = f.v3;
          t1 = f.tau;
          sm.refl[3 * (s + 1 - m)] = v2;
          sm.refl[3 * (s + 1 - m) + 1] = v3;
          sm.refl[3 * (s + 1 - m) + 2] = t1;
          // row s and column s-1 leave the window
          if (s >= 1) {
            T[(int64_t)s * k + s - 1] = W[0][0];
            T[(int64_t)(s + 1) * k + s - 1] = W[1][0];
            T[(int64_t)(s + 2) * k + s - 1] = W[2][0];
          }
          T[(int64_t)s * k + s] = W[0][1];
          T[(int64_t)s * k + s + 1] = W[0][2];
          T[(int64_t)s * k + s + 2] = W[0][3];
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) W[a][b] = W[a + 1][b + 1];
          W[3][0] = W[3][1] = W[3][2] = 0.0;
          ops += 10LL * ((k - s) + (s + 3 <= i ? s + 3 : i) + 1 + k);
        } else {
#pragma unroll
          for (int b = 1; b <= 2; ++b) {
            const double sum = W[0][b] + v2 * W[1][b];
            W[0][b] -= sum * t1;
            W[1][b] -= sum * t2;
          }
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const double sum = W[a][1] + v2 * W[a][2];
            W[a][1] -= sum * t1;
            W[a][2] -= sum * t2;
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) T[(int64_t)(s + a) * k + s - 1 + b] = W[a][b];
          ops += 6LL * ((k - s) + i + 1 + k);
        }
      }
      step_barrier();
    }
  } else {
    // the column threads: rows s..s+2 of each owned column, the next two rows loaded ahead
    double c0[kCols], c1[kCols], c2[kCols], p0[kCols], p1[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = tid - 32 + q * kColThreads;
      if (j < k && j >= m + 3) {
        c0[q] = at(T, k, m, j);
        c1[q] = at(T, k, m + 1, j);
        c2[q] = at(T, k, m + 2, j);
        p0[q] = m + 3 <= i ? at(T, k, m + 3, j) : 0.0;
        p1[q] = m + 4 <= i ? at(T, k, m + 4, j) : 0.0;
      }
    }
    step_barrier();
    for (int s = m; s < i; ++s) {
      const bool three = s < i - 1;
      const double rv2 = sm.refl[3 * (s - m)], rv3 = sm.refl[3 * (s - m) + 1], rt1 = sm.refl[3 * (s - m) + 2];
      const double rt2 = rt1 * rv2, rt3 = rt1 * rv3;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = tid - 32 + q * kColThreads;
        const int last = j <= i ? j - 3 : i - 1;   // then the chain takes column j, or the sweep ends
        if (j < k && j >= m + 3 && s <= last) {
          if (three) {
            const double sum = c0[q] + rv2 * c1[q] + rv3 * c2[q];
            c0[q] -= sum * rt1;
            c1[q] -= sum * rt2;
            c2[q] -= sum * rt3;
          } else {
            const double sum = c0[q] + rv2 * c1[q];
            c0[q] -= sum * rt1;
            c1[q] -= sum * rt2;
          }
          T[(int64_t)s * k + j] = c0[q];
          if (s == last) {
            if (j <= i) {           // s = j-3: rows s+1, s+2 go to the chain
              sm.hand[s & 1][0] = c1[q];
              sm.hand[s & 1][1] = c2[q];
            } else {                // the last step, rows i-1, i
              T[(int64_t)(s + 1) * k + j] = c1[q];
            }
          } else {
            c0[q] = c1[q];
            c1[q] = c2[q];
            c2[q] = p0[q];
            p0[q] = p1[q];
            p1[q] = s + 5 <= i ? at(T, k, s + 5, j) : 0.0;
          }
        }
      }
      step_barrier();
    }
  }
  // the deferred right-hand updates: rows 0..i-2 of T from step max(m, r+1),
  // then every row of Z from step m
  const int nt = i - 1;
  for (int c = tid; c < nt + k; c += kThreads) {
    if (c < nt)
      row_chain(T + (int64_t)c * k, 1, c + 1 > m ? c + 1 : m, m, i, sm.refl);
    else
      row_chain(Zc + (c - nt), k, m, m, i, sm.refl);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    hess_eig_kernel(const double* __restrict__ H, int64_t K, int k, double* T_all, double* Z_all, double* w_all,
                    double* X_all, int* info_all, long long* stats_all) {
  __shared__ Smem sm;
  const int f = blockIdx.x, tid = threadIdx.x;
  const double* Hf = H + (int64_t)f * K * K;
  double* T = T_all + (int64_t)f * k * k;
  double* Zc = Z_all + (int64_t)f * k * k;
  double* w = w_all + (int64_t)f * k * 2;
  double* X = X_all + (int64_t)f * k * k * 2;
  for (int64_t e = tid; e < (int64_t)k * k; e += kThreads) {
    const int r = (int)(e / k), c = (int)(e % k);
    T[e] = r <= c + 1 ? Hf[(int64_t)r * K + c] : 0.0;   // below the subdiagonal reads as zero
    Zc[e] = r == c ? 1.0 : 0.0;
  }
  if (tid == 0) sm.ops = 0;
  __syncthreads();

  const double smlnum = kSafMin * ((double)k / kUlp);
  const int itmax = kIterCapPerRow * (k > 10 ? k : 10);
  int its = 0, kdefl = 0, info = 0;
  long long steps = 0, ops = 0;
  int i = k - 1;
  while (i >= 0) {
    int l = 0;
    for (;;) {
      if (tid == 0) sm.kk = l;
      __syncthreads();
      for (int kk = l + 1 + tid; kk <= i; kk += kThreads)
        if (negligible(T, k, kk, smlnum)) atomicMax(&sm.kk, kk);
      __syncthreads();
      l = sm.kk;
      if (l >= i - 1) break;
      if (its >= itmax) {
        info = i + 1;
        break;
      }
      ++its;
      ++kdefl;
      const Shifts sh = shifts(T, k, l, i, kdefl);
      if (tid == 0) sm.m = l;
      __syncthreads();
      for (int mm = l + 1 + tid; mm <= i - 2; mm += kThreads) {
        double v1, v2, v3;
        shift_vector(T, k, mm, sh, v1, v2, v3);
        const double h00 = fabs(at(T, k, mm, mm - 1)) * (fabs(v2) + fabs(v3));
        const double h01 = fabs(v1) * (fabs(at(T, k, mm - 1, mm - 1)) + fabs(at(T, k, mm, mm)) +
                                       fabs(at(T, k, mm + 1, mm + 1)));
        if (h00 <= kUlp * h01) atomicMax(&sm.m, mm);
      }
      __syncthreads();
      const int m = sm.m;
      if (tid == 0 && l > 0) T[(int64_t)l * k + l - 1] = 0.0;   // H(L, L-1) is negligible
      __syncthreads();
      sweep(T, Zc, k, l, m, i, sh, sm, ops);
      steps += i - m;
    }
    if (info) break;
    if (tid == 0 && l > 0) T[(int64_t)l * k + l - 1] = 0.0;
    if (l == i) {
      if (tid == 0) {
        w[2 * i] = at(T, k, i, i);
        w[2 * i + 1] = 0.0;
      }
    } else {                          // l == i-1: a 2 x 2 block in standard form
      if (tid == 0) {
        const Lanv2 r = lanv2(at(T, k, i - 1, i - 1), at(T, k, i - 1, i), at(T, k, i, i - 1), at(T, k, i, i));
        T[(int64_t)(i - 1) * k + i - 1] = r.a;
        T[(int64_t)(i - 1) * k + i] = r.b;
        T[(int64_t)i * k + i - 1] = r.c;
        T[(int64_t)i * k + i] = r.d;
        w[2 * (i - 1)] = r.rt1r;
        w[2 * (i - 1) + 1] = r.rt1i;
        w[2 * i] = r.rt2r;
        w[2 * i + 1] = r.rt2i;
        sm.rot[0] = r.cs;
        sm.rot[1] = r.sn;
        ops += 6LL * ((k - 1 - i) + (i - 1) + k);
      }
      __syncthreads();
      const double cs = sm.rot[0], sn = sm.rot[1];
      for (int e = tid; e < (k - 1 - i) + (i - 1) + k; e += kThreads) {
        double *x, *y;
        if (e < k - 1 - i) {          // rows i-1, i right of the block
          x = T + (int64_t)(i - 1) * k + i + 1 + e;
          y = T + (int64_t)i * k + i + 1 + e;
        } else if (e < k - 2) {       // columns i-1, i above it
          const int r = e - (k - 1 - i);
          x = T + (int64_t)r * k + i - 1;
          y = T + (int64_t)r * k + i;
        } else {                      // Z's columns i-1, i
          const int r = e - (k - 2);
          x = Zc + (int64_t)(i - 1) * k + r;
          y = Zc + (int64_t)i * k + r;
        }
        const double xv = *x, yv = *y;
        *x = cs * xv + sn * yv;
        *y = cs * yv - sn * xv;
      }
    }
    __syncthreads();
    kdefl = 0;
    i = l - 1;
  }

  // the eigenvectors of T: one warp per real eigenvalue or conjugate pair
  const int warp = tid / 32, lane = tid % 32;
  if (!info) {
    for (int c = warp; c < k; c += kWarps) {
      const double wr = w[2 * c], wi = w[2 * c + 1];
      if (wi < 0.0) continue;   // the pair's second: its first writes it
      double* xc = X + (int64_t)c * k * 2;
      const double smin = fmax(kUlp * (fabs(wr) + fabs(wi)), smlnum);
      const int end = wi > 0.0 ? c + 1 : c;
      for (int r = lane; r < k; r += 32) {
        double re = 0.0, im = 0.0;
        if (r == c) {
          if (wi == 0.0 || fabs(at(T, k, c, c + 1)) >= fabs(at(T, k, c + 1, c))) {
            re = 1.0;
          } else {
            re = -wi / at(T, k, c + 1, c);
          }
        } else if (r == c + 1 && wi > 0.0) {
          im = fabs(at(T, k, c, c + 1)) >= fabs(at(T, k, c + 1, c)) ? wi / at(T, k, c, c + 1) : 1.0;
        }
        xc[2 * r] = re;
        xc[2 * r + 1] = im;
      }
      __syncwarp();
      long long col_ops = 0;
      int j = c - 1;
      while (j >= 0) {
        const bool two = j > 0 && at(T, k, j, j - 1) != 0.0;
        const int j1 = two ? j - 1 : j;
        // r_j = -sum_{l > j} T[j, l] x_l, and r_{j-1} over the same l
        double ar = 0.0, ai = 0.0, br = 0.0, bi = 0.0;
        for (int q = j + 1 + lane; q <= end; q += 32) {
          const double xr = xc[2 * q], xi = xc[2 * q + 1];
          const double tj = at(T, k, j, q);
          ar += tj * xr;
          ai += tj * xi;
          if (two) {
            const double tq = at(T, k, j - 1, q);
            br += tq * xr;
            bi += tq * xi;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ar += __shfl_xor_sync(0xffffffffu, ar, o);
          ai += __shfl_xor_sync(0xffffffffu, ai, o);
          br += __shfl_xor_sync(0xffffffffu, br, o);
          bi += __shfl_xor_sync(0xffffffffu, bi, o);
        }
        double n1r, n1i, n2r = 0.0, n2i = 0.0;   // x_j (two: x_{j-1}, x_j)
        if (two) {
          const double r1r = -br, r1i = -bi, r2r = -ar, r2i = -ai;
          const double a11r = at(T, k, j - 1, j - 1) - wr, a11i = -wi;
          const double a22r = at(T, k, j, j) - wr, a22i = -wi;
          const double a12 = at(T, k, j - 1, j), a21 = at(T, k, j, j - 1);
          const double cmax = fmax(fmax(fabs(a11r) + fabs(a11i), fabs(a12)), fmax(fabs(a21), fabs(a22r) + fabs(a22i)));
          double dr = a11r * a22r - a11i * a22i - a12 * a21, di = a11r * a22i + a11i * a22r;
          if (cmax < smin) {
            n1r = r1r / smin;
            n1i = r1i / smin;
            n2r = r2r / smin;
            n2i = r2i / smin;
          } else {
            if (fabs(dr) + fabs(di) < smin * cmax) {
              dr = smin * cmax;
              di = 0.0;
            }
            // x1 = (r1 a22 - a12 r2) / det, x2 = (a11 r2 - a21 r1) / det
            const double u1r = r1r * a22r - r1i * a22i - a12 * r2r, u1i = r1r * a22i + r1i * a22r - a12 * r2i;
            const double u2r = a11r * r2r - a11i * r2i - a21 * r1r, u2i = a11r * r2i + a11i * r2r - a21 * r1i;
            const double den = dr * dr + di * di;
            n1r = (u1r * dr + u1i * di) / den;
            n1i = (u1i * dr - u1r * di) / den;
            n2r = (u2r * dr + u2i * di) / den;
            n2i = (u2i * dr - u2r * di) / den;
          }
        } else {
          double dr = at(T, k, j, j) - wr, di = -wi;
          if (fabs(dr) + fabs(di) < smin) {
            dr = smin;
            di = 0.0;
          }
          const double den = dr * dr + di * di;
          n1r = (-ar * dr + -ai * di) / den;
          n1i = (-ai * dr - -ar * di) / den;
        }
        if (lane == 0) {
          if (two) {
            xc[2 * (j - 1)] = n1r;
            xc[2 * (j - 1) + 1] = n1i;
            xc[2 * j] = n2r;
            xc[2 * j + 1] = n2i;
          } else {
            xc[2 * j] = n1r;
            xc[2 * j + 1] = n1i;
          }
        }
        col_ops += 4LL * (end - j) * (two ? 2 : 1);
        // lane 0's values were stored; the lanes' sums may differ in their last bits
        const double big = __shfl_sync(0xffffffffu, fmax(fabs(n1r) + fabs(n1i), fabs(n2r) + fabs(n2i)), 0);
        __syncwarp();
        if (big > kBig) {
          const double sc = 1.0 / big;
          for (int q = j1 + lane; q <= end; q += 32) {
            xc[2 * q] *= sc;
            xc[2 * q + 1] *= sc;
          }
          __syncwarp();
        }
        j = j1 - 1;
      }
      // scale the largest |re| + |im| to 1, then the pair's conjugate
      double emax = 0.0;
      for (int q = lane; q <= end; q += 32) emax = fmax(emax, fabs(xc[2 * q]) + fabs(xc[2 * q + 1]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) emax = fmax(emax, __shfl_xor_sync(0xffffffffu, emax, o));
      const double sc = 1.0 / emax;
      double* xn = xc + (int64_t)k * 2;
      for (int q = lane; q < k; q += 32) {
        const double re = q <= end ? xc[2 * q] * sc : 0.0, im = q <= end ? xc[2 * q + 1] * sc : 0.0;
        xc[2 * q] = re;
        xc[2 * q + 1] = im;
        if (wi > 0.0) {
          xn[2 * q] = re;
          xn[2 * q + 1] = -im;
        }
      }
      if (lane == 0) atomicAdd(&sm.ops, (unsigned long long)col_ops);
      __syncwarp();
    }
  } else {
    for (int64_t e = tid; e < (int64_t)k * k * 2; e += kThreads) X[e] = 0.0;
  }
  __syncthreads();
  if (tid == 0) {
    info_all[f] = info;
    if (stats_all != nullptr) {
      stats_all[3 * f] = its;
      stats_all[3 * f + 1] = steps;
      stats_all[3 * f + 2] = ops + (long long)sm.ops;
    }
  }
}

}  // namespace

extern "C" int tk_hess_eig_f64(const void* H, int64_t d, int64_t K, int64_t k, void* T, void* Z, void* w, void* X,
                               void* info, void* stats, void* stream) {
  if (d < 1 || k < 1 || k > kMaxK || k > K) return (int)cudaErrorInvalidValue;
  hess_eig_kernel<<<(unsigned)d, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)H, K, (int)k, (double*)T, (double*)Z, (double*)w, (double*)X, (int*)info, (long long*)stats);
  return (int)cudaGetLastError();
}
