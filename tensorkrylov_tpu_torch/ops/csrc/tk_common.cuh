// Shared device helpers of the port's kernels.
//
// Products and sums are rounded one at a time (no FMA contraction), so the
// elementwise parts of a kernel give the same bits as the plain PyTorch
// version, which also rounds each operation on its own. The fixed-order sums
// below are those of the fused and resident Lanczos kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tk {

// The dynamic shared memory a kernel has been allowed on each device, so that
// cudaFuncSetAttribute runs only when a launch asks for more than before.
struct SharedAllowance {
  static constexpr int kMaxDevices = 64;
  std::mutex mu;
  int64_t bytes[kMaxDevices] = {};  // 1 + the bytes allowed on each device; 0: none yet
};

// Allows kernel fn up to smem bytes of dynamic shared memory on the current
// device (and, with `cluster`, cluster sizes above the portable 8). The
// allowance only grows, so a launch that another thread configured with a
// larger one still launches. Returns a cudaError_t.
inline cudaError_t allow_shared(const void* fn, SharedAllowance& a, int64_t smem, bool cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SharedAllowance::kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(a.mu);
  if (a.bytes[dev] > smem) return cudaSuccess;
  if (cluster) err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) a.bytes[dev] = smem + 1;
  return err;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// a - b: negation is exact, so this is the correctly rounded difference
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) { return add_rn(a, -b); }

// (A v)[i] for one factor row: bands[b*n + i] * v[i + offsets[b]] summed in
// band order; entries whose column falls outside [0, n) contribute zero.
template <typename T>
__device__ __forceinline__ T band_row(const T* __restrict__ bands_s, const int64_t* __restrict__ offsets,
                                     const T* __restrict__ v_row, int64_t nb, int64_t n, int64_t i) {
  T acc = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t j = i + offsets[b];
    const T x = (j >= 0 && j < n) ? v_row[j] : T(0);
    acc = add_rn(acc, mul_rn(bands_s[b * n + i], x));
  }
  return acc;
}

// The fixed summation order of ops/fused_lanczos.py:fixed_order_sum, which a
// Lanczos recurrence without reorthogonalization needs (it amplifies a change
// in rounding about 2.6x per step): each kChunk-element chunk is tree-summed
// (element i + element i + h, h = 128, 64, ..., 1), chunk c's sum is added, in
// order of c, to slot c % kSlots of a running total, and the slots are
// tree-summed.
constexpr int kChunk = 256;             // elements per chunk tree (fused_lanczos.py:BLOCK)
constexpr int kPerLane = kChunk / 32;   // elements of a chunk each lane holds
constexpr int kSlots = 256;             // second-stage slots (fused_lanczos.py:BLOCK)

// Tree sum of the 256 values x[j] of lane l = element l + 32 j of a chunk, in
// fixed_order_sum's pairing; the result is valid in lane 0.
template <typename T>
__device__ __forceinline__ T chunk_tree(T (&x)[kPerLane]) {
#pragma unroll
  for (int h = kPerLane / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) x[j] = add_rn(x[j], x[j + h]);
  }
  T t = x[0];
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) t = add_rn(t, __shfl_down_sync(0xffffffffu, t, h));
  return t;
}

// A launch of `blocks` blocks of `threads` threads in clusters of G blocks,
// with smem bytes of dynamic shared memory; attr receives the cluster
// dimension, which the returned configuration points to.
inline cudaLaunchConfig_t cluster_config(int64_t blocks, int threads, int64_t G, size_t smem,
                                         cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(G);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Every thread of every block of the cluster arrives; the release makes this
// thread's earlier writes (global memory included) visible at cluster scope,
// the acquire makes every other thread's visible to the loads that follow.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// csum[c] = the tree sum of the values fill(i0, x) puts in x for chunk c,
// lane l holding elements i0 + 32 k, i0 = c * 256 + l (x[k] = 0 past n); for
// the chunks [c0, c1) of a block of kWarps warps, warp w taking chunks c0 + w,
// c0 + w + kWarps, ... fill may also write those elements of a row: each
// thread fills the same elements in every pass over [c0, c1).
template <int kWarps, typename T, typename F>
__device__ __forceinline__ void chunk_sums(int64_t c0, int64_t c1, T* csum, F fill) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t c = c0 + warp; c < c1; c += kWarps) {
    T x[kPerLane];
    fill(c * kChunk + lane, x);
    const T part = chunk_tree(x);
    if (lane == 0) csum[c] = part;
  }
}

// The first pass of a Lanczos step for a lane's elements i = i0 + 32 k of a
// chunk (k < kPerLane): w = A vp - beta vpp, each product and sum in band
// order from zero, stored to w_out[i - ib]; x[k] = w * vp (0 past n). The
// loads of a band for all k come before its sums, so a lane keeps kPerLane
// of them in flight.
template <typename T>
__device__ __forceinline__ void lanczos_w_pass(const T* bands_s, const int64_t* offsets, const T* vp, const T* vpp,
                                               T beta, int64_t nb, int64_t n, int64_t i0, T* w_out, int64_t ib,
                                               T (&x)[kPerLane]) {
  T w[kPerLane], vpi[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) w[k] = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t off = offsets[b];
    const T* band = bands_s + b * n;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t i = i0 + 32 * k, col = i + off;
      const T a = i < n ? band[i] : T(0);
      const T y = (i < n && col >= 0 && col < n) ? vp[col] : T(0);
      w[k] = add_rn(w[k], mul_rn(a, y));
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int64_t i = i0 + 32 * k;
    vpi[k] = i < n ? vp[i] : T(0);
    w[k] = sub_rn(w[k], mul_rn(beta, i < n ? vpp[i] : T(0)));
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int64_t i = i0 + 32 * k;
    if (i < n) w_out[i - ib] = w[k];
    x[k] = i < n ? mul_rn(w[k], vpi[k]) : T(0);
  }
}

// The fixed-order total of the n_chunks chunk sums that the whole cluster
// wrote before its barrier; every thread of the block (at least kSlots
// threads) gets it. csum is read with plain loads: other SMs wrote it.
template <typename T>
__device__ T chunk_total(const T* csum, int64_t n_chunks, T* slots, T* result) {
  if (threadIdx.x < kSlots) {
    T acc = T(0);
#pragma unroll 8
    for (int64_t c = threadIdx.x; c < n_chunks; c += kSlots) acc = add_rn(acc, csum[c]);
    slots[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    T x[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) x[j] = slots[threadIdx.x + 32 * j];
    const T total = chunk_tree(x);
    if (threadIdx.x == 0) *result = total;
  }
  __syncthreads();
  return *result;
}

}  // namespace tk
