// Fused plain-Lanczos recurrence core for Hopper, f32 and f64, in two passes
// over memory:
//   pass 1: w = A v_prev - beta * v_pprev,  partial sums of alpha = sum w * v_prev
//   pass 2: u = w - alpha * v_prev,          partial sums of beta^2 = sum u * u and ub = sum u * b
// Each pass is followed by a reduction kernel that sums the per-block partials.
//
// Replaces: tensorkrylov_tpu/ops/pallas/fused_lanczos.py:_k1 and :_k2 (reached
// from fused_lanczos_core), which do the same two passes in f32 only.
//
// Bound on the card: memory bandwidth. Pass 1 reads nb bands, v_prev, v_pprev
// and writes w; pass 2 reads w, v_prev, b and writes u: (nb + 7) elements per
// row element in all, with a few flops each. The reductions move only
// d * n_blocks partials.
//
// Design: one thread per element, a grid of (n blocks) x (factor). A TPU grid
// runs in order and carries its sums in scratch from step to step; Hopper's
// blocks run in parallel in no order, so each block writes its partial sum to
// a (3, d, n_blocks) scratch, and a second kernel sums the partials of each
// row. Both sums are fixed trees in shared memory and no atomics are used, so
// a run repeats bit for bit. alpha stays on the device between the passes:
// no host round trip. w is written into u's buffer and pass 2 turns it into u
// in place, so the wrapper allocates one (d, n) output. The elementwise parts
// round each operation on its own, and the plain PyTorch version
// (fused_lanczos.py:fixed_order_sum) takes the sums in this same order, so the
// two agree bit for bit: without reorthogonalization the recurrence amplifies
// any change in the rounding of these sums by about 2.6x per step.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 256;  // elements per block; a power of two for the tree sum (fused_lanczos.py:BLOCK)

// Sum of x over the block, in a fixed tree order; every thread gets the result.
template <typename T>
__device__ T block_sum(T x, T* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + stride];
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();  // sh may be reused by the caller's next block_sum
  return total;
}

template <typename T>
__global__ void lanczos_pass1(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                              const T* __restrict__ v_prev, const T* __restrict__ v_pprev,
                              const T* __restrict__ beta, T* __restrict__ w, T* __restrict__ alpha_part,
                              int64_t nb, int64_t n, int64_t n_blocks) {
  __shared__ T sh[kThreads];
  const int64_t s = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T part = T(0);
  if (i < n) {
    const T* vp = v_prev + s * n;
    const T av = tk::band_row(bands + s * nb * n, offsets, vp, nb, n, i);
    const T wi = tk::sub_rn(av, tk::mul_rn(beta[s], v_pprev[s * n + i]));
    w[s * n + i] = wi;
    part = tk::mul_rn(wi, vp[i]);
  }
  const T total = block_sum(part, sh);
  if (threadIdx.x == 0) alpha_part[s * n_blocks + blockIdx.x] = total;
}

template <typename T>
__global__ void lanczos_pass2(T* __restrict__ wu, const T* __restrict__ v_prev, const T* __restrict__ b,
                              const T* __restrict__ alpha, T* __restrict__ beta_sq_part,
                              T* __restrict__ ub_part, int64_t n, int64_t n_blocks) {
  __shared__ T sh[kThreads];
  const int64_t s = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T p_uu = T(0), p_ub = T(0);
  if (i < n) {
    const int64_t at = s * n + i;
    const T u = tk::sub_rn(wu[at], tk::mul_rn(alpha[s], v_prev[at]));
    wu[at] = u;
    p_uu = tk::mul_rn(u, u);
    p_ub = tk::mul_rn(u, b[at]);
  }
  const T t_uu = block_sum(p_uu, sh);
  const T t_ub = block_sum(p_ub, sh);
  if (threadIdx.x == 0) {
    beta_sq_part[s * n_blocks + blockIdx.x] = t_uu;
    ub_part[s * n_blocks + blockIdx.x] = t_ub;
  }
}

// out[r] = sum_j part[r, j]: each thread sums a fixed strided subset in order,
// then the block sums the threads' results in a fixed tree.
template <typename T>
__global__ void row_sums(const T* __restrict__ part, T* __restrict__ out, int64_t n_blocks) {
  __shared__ T sh[kThreads];
  const int64_t r = blockIdx.x;
  T acc = T(0);
  for (int64_t j = threadIdx.x; j < n_blocks; j += kThreads) acc = acc + part[r * n_blocks + j];
  const T total = block_sum(acc, sh);
  if (threadIdx.x == 0) out[r] = total;
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev,
           const void* beta, const void* b, void* u, void* partials, void* sums, int64_t d,
           int64_t nb, int64_t n, void* stream_ptr) {
  if (d == 0 || n == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n_blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(d));
  T* part = static_cast<T*>(partials);  // (3, d, n_blocks): alpha, beta^2, ub
  T* out = static_cast<T*>(sums);       // (3, d):           alpha, beta^2, ub
  T* wu = static_cast<T*>(u);
  const T* vp = static_cast<const T*>(v_prev);

  lanczos_pass1<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(bands), static_cast<const int64_t*>(offsets), vp,
      static_cast<const T*>(v_pprev), static_cast<const T*>(beta), wu, part, nb, n, n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sums<T><<<static_cast<unsigned>(d), kThreads, 0, stream>>>(part, out, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lanczos_pass2<T><<<grid, kThreads, 0, stream>>>(wu, vp, static_cast<const T*>(b), out,
                                                   part + d * n_blocks, part + 2 * d * n_blocks,
                                                   n, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sums<T><<<static_cast<unsigned>(2 * d), kThreads, 0, stream>>>(part + d * n_blocks, out + d,
                                                                      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements of a row that one block of the passes covers; the wrapper sizes
// the (3, d, ceil(n / this)) partial-sum scratch with it.
extern "C" int64_t tk_fused_lanczos_block_elems() { return kThreads; }

// bands (d, nb, n); offsets (nb,) int64; v_prev, v_pprev, b, u (d, n); beta (d,);
// partials (3, d, n_blocks) scratch; sums (3, d) out: alpha, beta^2, ub. All
// contiguous, one dtype, one device. Returns the first cudaError_t of the launches.
extern "C" int tk_fused_lanczos_f32(const void* bands, const void* offsets, const void* v_prev,
                                    const void* v_pprev, const void* beta, const void* b, void* u,
                                    void* partials, void* sums, int64_t d, int64_t nb, int64_t n,
                                    void* stream) {
  return launch<float>(bands, offsets, v_prev, v_pprev, beta, b, u, partials, sums, d, nb, n, stream);
}

extern "C" int tk_fused_lanczos_f64(const void* bands, const void* offsets, const void* v_prev,
                                    const void* v_pprev, const void* beta, const void* b, void* u,
                                    void* partials, void* sums, int64_t d, int64_t nb, int64_t n,
                                    void* stream) {
  return launch<double>(bands, offsets, v_prev, v_pprev, beta, b, u, partials, sums, d, nb, n,
                        stream);
}
