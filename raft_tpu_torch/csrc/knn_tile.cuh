// The shared selection primitives of the port's kNN kernels for Hopper:
// the (distance, id) order with ties to the lowest id, the empty-slot id,
// the widest top-k queue, the NaN that marks a pair no test accepts, the
// 16-byte steps of a shared-memory layout, round-to-nearest-even bf16, the
// warp-cooperative
// insertion into a sorted queue in shared memory (B1's merge,
// knn_gemm.cuh), and the opt-in to more than 48 KB of dynamic shared
// memory. B1 (knn_gemm.cuh), B2 (cells_knn.cu), B3 (batch_knn.cu) and B4
// (pq_scan.cu) build on it; cell_select.cuh holds the cell-level selection
// B2, B3 and B4 share.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace knn {

constexpr int KMAX = 256;    // widest top-k queue
constexpr int NONE = 0x7fffffff;  // id of an empty queue slot

// A quiet NaN: no comparison accepts it.
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Reserve `bytes` (rounded up to 16) of a shared-memory layout at offset
// `at`; returns the region's offset.
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  size_t here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

// Round to the nearest bf16 (ties to even), as astype(bfloat16) does.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending queue of length k; warp-cooperative.
__device__ inline void queue_insert(float* kd, int* ki, int k, float d, int i,
                                    int lane) {
  int pos = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    int j = j0 + lane;
    bool less = j < k && pair_less(kd[j], ki[j], d, i);
    pos += __popc(__ballot_sync(0xffffffffu, less));
  }
  float od[KMAX / 32];
  int oi[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    int j = t * 32 + lane;
    if (j < k && j > pos) { od[t] = kd[j - 1]; oi[t] = ki[j - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    int j = t * 32 + lane;
    if (j < k && j > pos) { kd[j] = od[t]; ki[j] = oi[t]; }
    if (j == pos && j < k) { kd[j] = d; ki[j] = i; }
  }
  __syncwarp();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace knn
