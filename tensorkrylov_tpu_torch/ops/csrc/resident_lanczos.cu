// S complete plain-Lanczos steps per launch for Hopper, f32. Per factor s and
// step j, with vp = v_{j-1} and vpp = v_{j-2}:
//   w   = A vp - beta * vpp        (banded SpMV, masked loads)
//   a   = sum w * vp               (fixed-order reduction)
//   u   = w - a * vp
//   b'  = sqrt(sum u * u)          (fixed-order reduction, correctly rounded sqrt)
//   v_j = u * (1 / b')             (a zero column and b' = 0 when b' <= 1e-30:
//                                   the recurrence then stays frozen)
//
// Replaces: tensorkrylov_tpu/ops/pallas/resident_lanczos.py:_kernel (reached
// from lanczos_resident_steps), which keeps each factor's bands and three ring
// vectors in VMEM for S statically unrolled steps, one pallas_call per factor.
//
// Design: one thread block per factor owns that factor's whole row for all S
// steps, so the SpMV, the two reductions, the update and the column write are
// separated by __syncthreads() alone: no cross-block reduction, no cooperative
// launch, no atomics. S is a runtime argument (no unrolling, no cap). The
// three ring vectors are V itself (v_{j-1} and v_{j-2} are the columns the
// block wrote in its previous steps, or the inputs vp/vpp) and a (d, n) scratch
// row for u; at d=10, n=131072 the bands and these vectors are ~31 MB and stay
// in the 50 MB L2. Loads are masked (0 <= i + offset < n), so any n and any
// offset work, unlike the TPU kernel's n % 128 rule and 128-lane halo.
//
// Bound on the card: one SM per factor. The grid has d blocks, so at d=10 ten
// of the H100's 132 SMs stream their rows while the rest idle; each step moves
// about (nb + 7) * n * 4 bytes per factor through one SM's L1/L2 path, and the
// two reductions add 2 x ceil(n / 8192) + 2 block barriers per step. A thread
// block cluster per factor, holding the row in distributed shared memory, is
// the redesign that spreads a factor over several SMs.
//
// Reduction order: a Lanczos recurrence without reorthogonalization amplifies
// a change in rounding about 2.6x per step, so the sums are taken in an order
// fixed by n alone, the order of ops/fused_lanczos.py:fixed_order_sum: each
// 256-element chunk is tree-summed (upper half onto lower half), chunk c's sum
// is added, in order of c, to slot c % 256 of a running total, and the 256
// slots are tree-summed. Warp w sums chunks w, w + 32, ... as a register tree
// and shuffles, so slot c % 256 is only ever touched by one warp, in order.
// Products and sums are rounded one at a time (no FMA contraction), the
// reciprocal is __fdiv_rn, the square root __fsqrt_rn: the plain version in
// ops/resident_lanczos.py gives the same bits.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 1024;           // one block per factor
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;              // elements per chunk tree (fused_lanczos.py:BLOCK)
constexpr int kPerLane = kChunk / 32;    // elements of a chunk each lane holds
constexpr int kSlots = 256;              // second-stage slots (fused_lanczos.py:BLOCK)
static_assert(kSlots % kWarps == 0, "a slot must belong to one warp");

// Tree sum of the 256 values x[j] of lane l = element l + 32 j of a chunk, in
// fixed_order_sum's pairing (element i + element i + h, h = 128, 64, ..., 1);
// the result is valid in lane 0.
__device__ __forceinline__ float chunk_tree(float (&x)[kPerLane]) {
#pragma unroll
  for (int h = kPerLane / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) x[j] = tk::add_rn(x[j], x[j + h]);
  }
  float t = x[0];
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) t = tk::add_rn(t, __shfl_down_sync(0xffffffffu, t, h));
  return t;
}

// tk::band_row without its __restrict__ on v_row: here v_row is a column this
// block wrote in the previous step, which a non-coherent load could miss.
__device__ __forceinline__ float band_row_coherent(const float* __restrict__ bands_s,
                                                   const int64_t* __restrict__ offsets, const float* v_row,
                                                   int64_t nb, int64_t n, int64_t i) {
  float acc = 0.0f;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t j = i + offsets[b];
    const float x = (j >= 0 && j < n) ? v_row[j] : 0.0f;
    acc = tk::add_rn(acc, tk::mul_rn(bands_s[b * n + i], x));
  }
  return acc;
}

// sum over i < n of elem(i), in the fixed order above; every thread gets the
// result. elem(i) may also write element i of a row: each thread calls it for
// the same indices in every pass.
template <typename F>
__device__ float fixed_order_pass(int64_t n, float* slots, float* result, F elem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    for (int k = warp; k < kSlots; k += kWarps) slots[k] = 0.0f;
  }
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  for (int64_t c = warp; c < n_chunks; c += kWarps) {
    float x[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = c * kChunk + lane + 32 * j;
      x[j] = i < n ? elem(i) : 0.0f;
    }
    const float part = chunk_tree(x);
    if (lane == 0) slots[c % kSlots] = tk::add_rn(slots[c % kSlots], part);
  }
  __syncthreads();
  if (warp == 0) {
    float x[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) x[j] = slots[lane + 32 * j];
    const float total = chunk_tree(x);
    if (lane == 0) *result = total;
  }
  __syncthreads();
  return *result;
}

// V, scratch and the inputs are read and written through plain pointers: the
// block reads back the columns it wrote in earlier steps, so no load may take
// the non-coherent read-only path.
__global__ void __launch_bounds__(kThreads)
resident_lanczos_kernel(const float* __restrict__ bands, const int64_t* __restrict__ offsets,
                        const float* vp_in, const float* vpp_in, const float* beta_in, float* V,
                        float* alpha_out, float* beta_out, float* beta_last, float* scratch,
                        int64_t d, int64_t nb, int64_t n, int64_t S) {
  __shared__ float slots[kSlots];
  __shared__ float result;
  const int64_t s = blockIdx.x;
  const float* bands_s = bands + s * nb * n;
  float* u = scratch + s * n;
  float beta = beta_in[s];
  for (int64_t j = 0; j < S; ++j) {
    const float* vp = j == 0 ? vp_in + s * n : V + ((j - 1) * d + s) * n;
    const float* vpp = j == 0 ? vpp_in + s * n : (j == 1 ? vp_in + s * n : V + ((j - 2) * d + s) * n);
    const float alpha = fixed_order_pass(n, slots, &result, [&](int64_t i) {
      const float w = tk::sub_rn(band_row_coherent(bands_s, offsets, vp, nb, n, i), tk::mul_rn(beta, vpp[i]));
      u[i] = w;
      return tk::mul_rn(w, vp[i]);
    });
    const float beta_sq = fixed_order_pass(n, slots, &result, [&](int64_t i) {
      const float ui = tk::sub_rn(u[i], tk::mul_rn(alpha, vp[i]));
      u[i] = ui;
      return tk::mul_rn(ui, ui);
    });
    const float beta_new = __fsqrt_rn(beta_sq);
    const bool ok = beta_new > 1e-30f;
    const float inv = ok ? __fdiv_rn(1.0f, beta_new) : 0.0f;
    float* v = V + (j * d + s) * n;
    // same element-to-thread mapping as the passes: each thread reads the u it wrote
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int64_t c = warp; c * kChunk < n; c += kWarps) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int64_t i = c * kChunk + lane + 32 * k;
        if (i < n) v[i] = tk::mul_rn(u[i], inv);
      }
    }
    beta = ok ? beta_new : 0.0f;
    if (threadIdx.x == 0) {
      alpha_out[s * S + j] = alpha;
      beta_out[s * S + j] = beta;
    }
    __syncthreads();  // column j is read, shifted, by other threads in step j + 1
  }
  if (threadIdx.x == 0) beta_last[s] = beta;
}

}  // namespace

// bands (d, nb, n) f32; offsets (nb,) int64; vp, vpp (d, n); beta (d,); V out
// (S, d, n); alpha, beta out (d, S); beta_last out (d,); scratch (d, n). All
// contiguous, f32 but the offsets, on one device. Returns the cudaError_t of
// the launch.
extern "C" int tk_resident_lanczos_f32(const void* bands, const void* offsets, const void* vp,
                                       const void* vpp, const void* beta, void* V, void* alpha_out,
                                       void* beta_out, void* beta_last, void* scratch, int64_t d,
                                       int64_t nb, int64_t n, int64_t S, void* stream) {
  if (d == 0 || S == 0) return 0;
  resident_lanczos_kernel<<<static_cast<unsigned>(d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands), static_cast<const int64_t*>(offsets),
      static_cast<const float*>(vp), static_cast<const float*>(vpp), static_cast<const float*>(beta),
      static_cast<float*>(V), static_cast<float*>(alpha_out), static_cast<float*>(beta_out),
      static_cast<float*>(beta_last), static_cast<float*>(scratch), d, nb, n, S);
  return static_cast<int>(cudaGetLastError());
}

// Elements per chunk tree and second-stage slots; the wrapper checks them
// against fused_lanczos.BLOCK, whose fixed_order_sum the plain version uses.
extern "C" int64_t tk_resident_lanczos_block_elems() { return kChunk; }
