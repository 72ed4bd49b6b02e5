// The shared selection primitives of the port's kNN kernels for Hopper:
// the (distance, id) order with ties to the lowest id, the empty-slot id,
// the widest top-k queue, the NaN that marks a pair no test accepts, the
// 16-byte steps of a shared-memory layout, and the opt-in to more than
// 48 KB of dynamic shared memory. B1 (knn_tf32.cu, knn_mma.cu), B2
// (cells_knn.cu, cells_mma.cu), B3 (batch_knn.cu) and B4 (pq_scan.cu)
// build on it; cell_select.cuh holds the cell-level selection B1-B4 share.

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

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace knn
