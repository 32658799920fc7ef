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
// Design: one thread-block cluster of G blocks per factor (G = 1 .. 16, from
// ops/resident_lanczos.py:resident_lanczos_plan), d clusters in all, for all S
// steps of the launch. Block r of a cluster owns a contiguous run of the
// factor's 256-element chunks and computes the SpMV, the update and the
// column write for them. Per step three cluster barriers
// (barrier.cluster.arrive.release / wait.acquire) order the blocks: after
// each of the two reductions' chunk sums, and after the column write, since
// step j + 1's SpMV reads the H neighbours of v_j that other blocks wrote.
// The loads of V, of the u scratch and of the chunk sums are plain coherent
// loads (never the read-only __ldg path): other SMs wrote them, and the
// barrier's acquire is what makes their writes visible. Clusters never wait on
// each other, so d * G blocks beyond what the card holds at once only queue:
// no cooperative launch. S is a runtime argument (no unrolling, no cap). The
// vectors are V itself (v_{j-1} and v_{j-2} are earlier columns, or the inputs
// vp/vpp), u (each block's part in its shared memory where the wrapper found
// room, else a (d, n) scratch row) and a (d, 2, ceil(n / 256)) scratch for the
// chunk sums. Loads are masked (0 <= i + offset < n), so any n and any offset
// work, unlike the TPU kernel's n % 128 rule and 128-lane halo.
//
// Bound on the card: memory. Each step moves about (nb + 7) * n * 4 bytes per
// factor (bands, vp three times, vpp, u written and read twice, v written),
// now through G SMs per factor instead of one. At d=10, n=131072 that is
// 52 MB per step, mostly L2 hits; at the bench's d=8, n=2^20, 336 MB per step
// from device memory. Each step also pays three cluster barriers.
//
// Reduction order: a Lanczos recurrence without reorthogonalization amplifies
// a change in rounding about 2.6x per step, so the sums are taken in an order
// fixed by n alone, the order of ops/fused_lanczos.py:fixed_order_sum: each
// 256-element chunk is tree-summed (upper half onto lower half), chunk c's sum
// is added, in order of c, to slot c % 256 of a running total, and the 256
// slots are tree-summed. Any ownership of chunks by blocks keeps that order:
// each block writes the sum of chunk c to csum[c]; after the cluster barrier
// every block reads all of csum, thread k adds csum[k], csum[k + 256], ... in
// turn and warp 0 tree-sums the 256 slots. Every block computes the same
// total redundantly, which saves a broadcast and a fourth barrier. Products
// and sums are rounded one at a time (no FMA contraction), the reciprocal is
// __fdiv_rn, the square root __fsqrt_rn: the plain version in
// ops/resident_lanczos.py gives the same bits.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 1024;           // threads per block; G blocks per factor
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = tk::kChunk;       // elements per chunk tree (fused_lanczos.py:BLOCK)
constexpr int kPerLane = tk::kPerLane;   // elements of a chunk each lane holds
constexpr int64_t kMaxCluster = 16;      // the H100's largest cluster, non-portable above 8
static_assert(tk::kSlots <= kThreads, "thread k < 256 owns slot k");

// Launched as d clusters of G blocks: block b works on factor b / G as the
// cluster's block b % G. In each pass a lane loads all 8 of its elements
// before it stores any, and the SpMV runs the band loop outside the element
// loop, so a lane keeps 8 elements' loads of a band in flight at once. V,
// vp_in, vpp_in and the scratch are plain pointers: the loads must not take
// the read-only path, since other blocks wrote the columns and chunk sums.
__global__ void __launch_bounds__(kThreads)
resident_lanczos_kernel(const float* __restrict__ bands, const int64_t* __restrict__ offsets,
                        const float* vp_in, const float* vpp_in, const float* beta_in, float* V,
                        float* alpha_out, float* beta_out, float* beta_last, float* u_all, float* csum_all,
                        int64_t d, int64_t nb, int64_t n, int64_t S, int G, int u_shared) {
  __shared__ float slots[tk::kSlots];
  __shared__ float result;
  extern __shared__ float u_smem[];
  const int64_t s = blockIdx.x / G;
  const int64_t rank = blockIdx.x % G;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const int64_t per_block = (n_chunks + G - 1) / G;
  const int64_t c0 = rank * per_block < n_chunks ? rank * per_block : n_chunks;
  const int64_t c1 = c0 + per_block < n_chunks ? c0 + per_block : n_chunks;
  const float* bands_s = bands + s * nb * n;
  // u[i - ib] is element i of u, for this block's elements [ib, c1 * 256): in
  // shared memory when the launch gave room for them, else in the scratch row
  const int64_t ib = c0 * kChunk;
  float* u = u_shared ? u_smem : u_all + s * n + ib;
  float* csum_alpha = csum_all + s * 2 * n_chunks;
  float* csum_beta = csum_alpha + n_chunks;
  float beta = beta_in[s];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t j = 0; j < S; ++j) {
    const float* vp = j == 0 ? vp_in + s * n : V + ((j - 1) * d + s) * n;
    const float* vpp = j == 0 ? vpp_in + s * n : (j == 1 ? vp_in + s * n : V + ((j - 2) * d + s) * n);
    // u = A vp - beta vpp, each product and sum in band order from zero; x = u * vp
    tk::chunk_sums<kWarps>(c0, c1, csum_alpha, [&](int64_t i0, float (&x)[kPerLane]) {
      tk::lanczos_w_pass(bands_s, offsets, vp, vpp, beta, nb, n, i0, u, ib, x);
    });
    tk::cluster_barrier();  // every chunk sum of alpha written
    const float alpha = tk::chunk_total(csum_alpha, n_chunks, slots, &result);
    // u -= alpha vp; x = u * u
    tk::chunk_sums<kWarps>(c0, c1, csum_beta, [&](int64_t i0, float (&x)[kPerLane]) {
      float ui[kPerLane], vpi[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int64_t i = i0 + 32 * k;
        ui[k] = i < n ? u[i - ib] : 0.0f;
        vpi[k] = i < n ? vp[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int64_t i = i0 + 32 * k;
        ui[k] = tk::sub_rn(ui[k], tk::mul_rn(alpha, vpi[k]));
        if (i < n) u[i - ib] = ui[k];
        x[k] = i < n ? tk::mul_rn(ui[k], ui[k]) : 0.0f;
      }
    });
    // every chunk sum of beta written; and every block has read csum_alpha,
    // which step j + 1 overwrites
    tk::cluster_barrier();
    const float beta_sq = tk::chunk_total(csum_beta, n_chunks, slots, &result);
    const float beta_new = __fsqrt_rn(beta_sq);
    const bool ok = beta_new > 1e-30f;
    const float inv = ok ? __fdiv_rn(1.0f, beta_new) : 0.0f;
    float* v = V + (j * d + s) * n;
    // same element-to-thread mapping as the passes: each thread reads the u it wrote
    for (int64_t c = c0 + warp; c < c1; c += kWarps) {
      const int64_t i0 = c * kChunk + lane;
      float ui[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) ui[k] = i0 + 32 * k < n ? u[i0 + 32 * k - ib] : 0.0f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (i0 + 32 * k < n) v[i0 + 32 * k] = tk::mul_rn(ui[k], inv);
      }
    }
    beta = ok ? beta_new : 0.0f;
    if (rank == 0 && threadIdx.x == 0) {
      alpha_out[s * S + j] = alpha;
      beta_out[s * S + j] = beta;
    }
    // column j complete before any block's step j + 1 reads its neighbours;
    // and every block has read csum_beta, which step j + 1 overwrites
    tk::cluster_barrier();
  }
  if (rank == 0 && threadIdx.x == 0) beta_last[s] = beta;
}

cudaError_t allow_shared(int64_t smem) {
  static tk::SharedAllowance allowance;
  return tk::allow_shared(reinterpret_cast<const void*>(resident_lanczos_kernel), allowance, smem, true);
}

}  // namespace

// bands (d, nb, n) f32; offsets (nb,) int64; vp, vpp (d, n); beta (d,); V out
// (S, d, n); alpha, beta out (d, S); beta_last out (d,); scratch
// d * (n + 2 * ceil(n / 256)) floats. All contiguous, f32 but the offsets, on
// the current device. G blocks per factor, 1 <= G <= 16. u_shared != 0 keeps
// each block's ceil(ceil(n / 256) / G) * 256 elements of u in dynamic shared
// memory instead of the scratch. Returns the cudaError_t of the launch.
extern "C" int tk_resident_lanczos_f32(const void* bands, const void* offsets, const void* vp,
                                       const void* vpp, const void* beta, void* V, void* alpha_out,
                                       void* beta_out, void* beta_last, void* scratch, int64_t d,
                                       int64_t nb, int64_t n, int64_t S, int64_t G, int64_t u_shared,
                                       void* stream) {
  if (d == 0 || S == 0) return 0;
  if (G < 1 || G > kMaxCluster || d * G > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = ((n + kChunk - 1) / kChunk + G - 1) / G;
  // the bytes that ops/resident_lanczos.py:_u_bytes gives the occupancy query
  const size_t smem = u_shared ? static_cast<size_t>(per_block) * kChunk * sizeof(float) : 0;
  cudaError_t err = allow_shared(static_cast<int64_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      tk::cluster_config(d * G, kThreads, G, smem, &attr, static_cast<cudaStream_t>(stream));
  float* u = static_cast<float*>(scratch);
  err = cudaLaunchKernelEx(&cfg, resident_lanczos_kernel, static_cast<const float*>(bands),
                           static_cast<const int64_t*>(offsets), static_cast<const float*>(vp),
                           static_cast<const float*>(vpp), static_cast<const float*>(beta), static_cast<float*>(V),
                           static_cast<float*>(alpha_out), static_cast<float*>(beta_out),
                           static_cast<float*>(beta_last), u, u + d * n, d, nb, n, S, static_cast<int>(G),
                           static_cast<int>(u_shared != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Writes to *clusters how many clusters of G blocks of the kernel, each with
// smem bytes of dynamic shared memory, the current device holds at once
// (cudaOccupancyMaxActiveClusters); 0 when it cannot launch one. Returns a
// cudaError_t.
extern "C" int tk_resident_lanczos_max_clusters(int64_t G, int64_t smem, int64_t* clusters) {
  *clusters = 0;
  if (G < 1 || G > kMaxCluster) return 0;
  cudaError_t err = allow_shared(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tk::cluster_config(G, kThreads, G, static_cast<size_t>(smem), &attr, nullptr);
  int num = 0;
  err = cudaOccupancyMaxActiveClusters(&num, reinterpret_cast<const void*>(resident_lanczos_kernel), &cfg);
  if (err != cudaSuccess) {  // a cluster size the card refuses: none fits
    cudaGetLastError();
    return 0;
  }
  *clusters = num;
  return 0;
}

// Elements per chunk tree and second-stage slots; the wrapper checks them
// against fused_lanczos.BLOCK, whose fixed_order_sum the plain version uses.
extern "C" int64_t tk_resident_lanczos_block_elems() { return kChunk; }
