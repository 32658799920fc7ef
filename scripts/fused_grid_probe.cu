// The fused Lanczos core's kernel (ops/csrc/fused_lanczos.cu) launched as one
// cooperative grid, with a grid-wide barrier between its passes in place of
// the cluster barrier: the alternative design, timed against the cluster
// design by scripts/fused_grid_probe.py. The kernel body, its chunk ownership
// and its summation order are the port's, so both designs give the same bits.
// The port does not use this file.
#include <cooperative_groups.h>

#include "fused_lanczos.cu"

namespace {

struct GridBarrier {
  __device__ __forceinline__ void operator()() const { cooperative_groups::this_grid().sync(); }
};

template <typename T>
const void* grid_kernel() {
  return reinterpret_cast<const void*>(fused_lanczos_kernel<T, GridBarrier>);
}

// Allows the elt-byte grid kernel smem bytes of dynamic shared memory (one
// allowance per kernel, so that it only grows).
template <typename T>
cudaError_t allow(int64_t smem) {
  static tk::SharedAllowance allowance;
  return tk::allow_shared(grid_kernel<T>(), allowance, smem, false);
}

template <typename T>
int grid_launch(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev, const void* beta,
                const void* b, void* u, void* scratch, int64_t d, int64_t nb, int64_t n, int64_t G,
                int64_t w_shared, void* stream) {
  if (d == 0 || n == 0) return 0;
  const size_t smem = w_bytes<T>(n, G, w_shared);
  cudaError_t err = allow<T>(static_cast<int64_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(d * G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_lanczos_kernel<T, GridBarrier>, static_cast<const T*>(bands),
                           static_cast<const int64_t*>(offsets), static_cast<const T*>(v_prev),
                           static_cast<const T*>(v_pprev), static_cast<const T*>(beta), static_cast<const T*>(b),
                           static_cast<T*>(u), static_cast<T*>(scratch), d, nb, n, static_cast<int>(G),
                           static_cast<int>(w_shared != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of tk_fused_lanczos_f32/f64, with G blocks per factor in one
// cooperative grid of d * G blocks (at most probe_fused_grid_blocks).
extern "C" int probe_fused_grid_f32(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev,
                                    const void* beta, const void* b, void* u, void* scratch, int64_t d, int64_t nb,
                                    int64_t n, int64_t G, int64_t w_shared, void* stream) {
  return grid_launch<float>(bands, offsets, v_prev, v_pprev, beta, b, u, scratch, d, nb, n, G, w_shared, stream);
}

extern "C" int probe_fused_grid_f64(const void* bands, const void* offsets, const void* v_prev, const void* v_pprev,
                                    const void* beta, const void* b, void* u, void* scratch, int64_t d, int64_t nb,
                                    int64_t n, int64_t G, int64_t w_shared, void* stream) {
  return grid_launch<double>(bands, offsets, v_prev, v_pprev, beta, b, u, scratch, d, nb, n, G, w_shared, stream);
}

// Writes to *blocks how many blocks of the elt-byte grid kernel, each with smem
// bytes of dynamic shared memory, the current device holds at once: the most
// a cooperative launch may take. Returns a cudaError_t.
extern "C" int probe_fused_grid_blocks(int64_t smem, int64_t elt, int64_t* blocks) {
  const void* kernel = elt == 8 ? grid_kernel<double>() : grid_kernel<float>();
  cudaError_t err = elt == 8 ? allow<double>(smem) : allow<float>(smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, static_cast<size_t>(smem));
  *blocks = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(err);
}
