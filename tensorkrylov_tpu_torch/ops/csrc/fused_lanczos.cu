// Fused plain-Lanczos recurrence core for Hopper, f32 and f64, in one launch.
// Per factor s:
//   w  = A v_prev - beta * v_pprev
//   a  = sum w * v_prev                (fixed-order reduction)
//   u  = w - a * v_prev
//   bb = sum u * u,  ub = sum u * b    (fixed-order reductions)
//
// Replaces: tensorkrylov_tpu/ops/pallas/fused_lanczos.py:_k1 and :_k2 (reached
// from fused_lanczos_core), which do the same in two f32 passes over memory.
//
// Bound on the card: memory bandwidth. The launch reads nb bands, v_prev,
// v_pprev and b and writes u: (nb + 4) elements per row element, a few flops
// each; at d=10, n=131072, f64 that is 73 MB, 0.022 ms at 3.35 TB/s.
//
// Design: one thread-block cluster of G blocks per factor (G from
// ops/fused_lanczos.py:fused_lanczos_plan), d clusters in all. Block r of a
// cluster owns a contiguous run of the factor's 256-element chunks. Pass 1
// computes w for its chunks, keeps it on chip (in the block's shared memory
// where the wrapper found room, else in u's own row, which pass 2 overwrites)
// and writes each chunk's sum of w * v_prev to a scratch. A cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) makes every chunk sum
// visible; every block then forms a itself, pass 2 turns its w into u and
// writes the chunk sums of u * u and u * b, and after a second cluster barrier
// block 0 of the cluster forms bb and ub. So w and the first reduction never
// leave the chip between a and u, the call is one launch instead of four, and
// clusters never wait on each other, so d * G blocks beyond what the card
// holds at once only queue. Loads are masked (0 <= i + offset < n): any n,
// any offset.
//
// Reduction order (tk_common.cuh): each 256-element chunk is tree-summed,
// chunk sums are added in order of c into 256 slots, the slots are
// tree-summed: the order of ops/fused_lanczos.py:fixed_order_sum, fixed by n
// alone and the same at every G. No atomics touch a sum, so a second launch
// repeats bit for bit. Products and sums are rounded one at a time, so the
// plain PyTorch version gives the same bits: without reorthogonalization the
// recurrence amplifies any change in the rounding of these sums by about 2.6x
// per step.
#include "tk_common.cuh"

namespace {

constexpr int kThreads = 1024;  // threads per block; G blocks per factor
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = tk::kPerLane;
constexpr int64_t kMaxCluster = 16;  // the H100's largest cluster, non-portable above 8
static_assert(tk::kSlots <= kThreads, "thread k < 256 owns slot k");

// The barrier between the passes: every block of the factor's cluster.
// (scripts/fused_grid_probe.cu launches the same kernel as one cooperative
// grid with a grid-wide barrier, to time that design against this one.)
struct ClusterBarrier {
  __device__ __forceinline__ void operator()() const { tk::cluster_barrier(); }
};

// Launched as d clusters of G blocks: block x works on factor x / G as the
// cluster's block x % G. scratch holds the sums (3, d): a, bb, ub, then the
// chunk sums (d, 3, ceil(n / 256)). The scratch and u are plain pointers: other
// blocks wrote the chunk sums, and pass 2 reads back the w it wrote into u.
template <typename T, typename Barrier>
__global__ void __launch_bounds__(kThreads)
fused_lanczos_kernel(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                     const T* __restrict__ v_prev, const T* __restrict__ v_pprev, const T* __restrict__ beta,
                     const T* __restrict__ b, T* u_all, T* scratch, int64_t d, int64_t nb, int64_t n, int G,
                     int w_shared) {
  __shared__ T slots[tk::kSlots];
  __shared__ T result;
  extern __shared__ __align__(16) unsigned char w_smem[];
  const int64_t s = blockIdx.x / G;
  const int64_t rank = blockIdx.x % G;
  const int64_t n_chunks = (n + tk::kChunk - 1) / tk::kChunk;
  const int64_t per_block = (n_chunks + G - 1) / G;
  const int64_t c0 = rank * per_block < n_chunks ? rank * per_block : n_chunks;
  const int64_t c1 = c0 + per_block < n_chunks ? c0 + per_block : n_chunks;
  const int64_t ib = c0 * tk::kChunk;
  T* u = u_all + s * n;
  // w[i - ib] is element i of w, for this block's elements [ib, c1 * 256)
  T* w = w_shared ? reinterpret_cast<T*>(w_smem) : u + ib;
  T* csum = scratch + 3 * d + s * 3 * n_chunks;  // chunk sums of a, bb, ub
  const T* bands_s = bands + s * nb * n;
  const T* vp = v_prev + s * n;
  const T* vpp = v_pprev + s * n;
  const T* bs = b + s * n;
  const T bt = beta[s];

  // pass 1: w = A vp - beta vpp, each product and sum in band order from zero; x = w * vp
  tk::chunk_sums<kWarps>(c0, c1, csum, [&](int64_t i0, T (&x)[kPerLane]) {
    tk::lanczos_w_pass(bands_s, offsets, vp, vpp, bt, nb, n, i0, w, ib, x);
  });
  Barrier()();  // every chunk sum of a written
  const T alpha = tk::chunk_total(csum, n_chunks, slots, &result);

  // pass 2, the same element-to-thread mapping (each thread reads the w it
  // wrote): u = w - a vp; the chunk sums of u * u and u * b
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t c = c0 + warp; c < c1; c += kWarps) {
    const int64_t i0 = c * tk::kChunk + lane;
    T wk[kPerLane], vpi[kPerLane], bk[kPerLane], uu[kPerLane], ub[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t i = i0 + 32 * k;
      wk[k] = i < n ? w[i - ib] : T(0);
      vpi[k] = i < n ? vp[i] : T(0);
      bk[k] = i < n ? bs[i] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t i = i0 + 32 * k;
      const T uk = tk::sub_rn(wk[k], tk::mul_rn(alpha, vpi[k]));
      if (i < n) u[i] = uk;
      uu[k] = i < n ? tk::mul_rn(uk, uk) : T(0);
      ub[k] = i < n ? tk::mul_rn(uk, bk[k]) : T(0);
    }
    const T p_uu = tk::chunk_tree(uu);
    const T p_ub = tk::chunk_tree(ub);
    if (lane == 0) {
      csum[n_chunks + c] = p_uu;
      csum[2 * n_chunks + c] = p_ub;
    }
  }
  Barrier()();  // every chunk sum of bb and ub written
  if (rank == 0) {
    const T bb = tk::chunk_total(csum + n_chunks, n_chunks, slots, &result);
    const T ubt = tk::chunk_total(csum + 2 * n_chunks, n_chunks, slots, &result);
    if (threadIdx.x == 0) {
      scratch[s] = alpha;
      scratch[d + s] = bb;
      scratch[2 * d + s] = ubt;
    }
  }
}


// The dynamic shared memory of a launch: a block's ceil(ceil(n / 256) / G)
// chunks of w, or none when w stays in u's row.
template <typename T>
size_t w_bytes(int64_t n, int64_t G, int64_t w_shared) {
  const int64_t per_block = ((n + tk::kChunk - 1) / tk::kChunk + G - 1) / G;
  return w_shared ? static_cast<size_t>(per_block) * tk::kChunk * sizeof(T) : 0;
}

template <typename T>
cudaError_t set_attributes(size_t smem) {
  static tk::SharedAllowance allowance;
  const auto kernel = reinterpret_cast<const void*>(fused_lanczos_kernel<T, ClusterBarrier>);
  return tk::allow_shared(kernel, allowance, static_cast<int64_t>(smem), true);
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev, const void* beta,
           const void* b, void* u, void* scratch, int64_t d, int64_t nb, int64_t n, int64_t G, int64_t w_shared,
           void* stream) {
  if (d == 0 || n == 0) return 0;
  if (G < 1 || G > kMaxCluster || d * G > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = w_bytes<T>(n, G, w_shared);
  cudaError_t err = set_attributes<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      tk::cluster_config(d * G, kThreads, G, smem, &attr, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, fused_lanczos_kernel<T, ClusterBarrier>, static_cast<const T*>(bands),
                           static_cast<const int64_t*>(offsets), static_cast<const T*>(v_prev),
                           static_cast<const T*>(v_pprev), static_cast<const T*>(beta), static_cast<const T*>(b),
                           static_cast<T*>(u), static_cast<T*>(scratch), d, nb, n, static_cast<int>(G),
                           static_cast<int>(w_shared != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per chunk tree and second-stage slots; the wrapper checks them
// against fused_lanczos.BLOCK, whose fixed_order_sum the plain version uses.
extern "C" int64_t tk_fused_lanczos_block_elems() { return tk::kChunk; }

// bands (d, nb, n); offsets (nb,) int64; v_prev, v_pprev, b, u (d, n); beta
// (d,); scratch 3 d + 3 d ceil(n / 256) elements, whose first 3 d receive the
// sums (3, d): alpha, beta^2, ub. All contiguous, one dtype but the offsets,
// on the current device. G blocks per factor, 1 <= G <= 16; w_shared != 0
// keeps each block's ceil(ceil(n / 256) / G) * 256 elements of w in dynamic
// shared memory instead of u's row. Returns the cudaError_t of the launch.
extern "C" int tk_fused_lanczos_f32(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev,
                                    const void* beta, const void* b, void* u, void* scratch, int64_t d, int64_t nb,
                                    int64_t n, int64_t G, int64_t w_shared, void* stream) {
  return launch<float>(bands, offsets, v_prev, v_pprev, beta, b, u, scratch, d, nb, n, G, w_shared, stream);
}

extern "C" int tk_fused_lanczos_f64(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev,
                                    const void* beta, const void* b, void* u, void* scratch, int64_t d, int64_t nb,
                                    int64_t n, int64_t G, int64_t w_shared, void* stream) {
  return launch<double>(bands, offsets, v_prev, v_pprev, beta, b, u, scratch, d, nb, n, G, w_shared, stream);
}

// Writes to *clusters how many clusters of G blocks of the elt-byte kernel,
// each with smem bytes of dynamic shared memory, the current device holds at
// once (cudaOccupancyMaxActiveClusters); 0 when it cannot launch one. Returns
// a cudaError_t.
extern "C" int tk_fused_lanczos_max_clusters(int64_t G, int64_t smem, int64_t elt, int64_t* clusters) {
  *clusters = 0;
  if (G < 1 || G > kMaxCluster || (elt != 4 && elt != 8)) return 0;
  const void* kernel = elt == 8 ? reinterpret_cast<const void*>(fused_lanczos_kernel<double, ClusterBarrier>)
                                : reinterpret_cast<const void*>(fused_lanczos_kernel<float, ClusterBarrier>);
  cudaError_t err = elt == 8 ? set_attributes<double>(static_cast<size_t>(smem))
                             : set_attributes<float>(static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tk::cluster_config(G, kThreads, G, static_cast<size_t>(smem), &attr, nullptr);
  int num = 0;
  err = cudaOccupancyMaxActiveClusters(&num, kernel, &cfg);
  if (err != cudaSuccess) {  // a cluster size the card refuses: none fits
    cudaGetLastError();
    return 0;
  }
  *clusters = num;
  return 0;
}
