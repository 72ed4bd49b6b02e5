// The pre-pass of the row scans that walk only live 128-slot tiles: B2
// (cells_tf32.cu for its f32 tier, cells_mma.cu for its bf16 tiers) and B3
// (batch_knn.cu). Part of every call; the index keeps nothing, so extend /
// upsert / compact cannot leave it stale.

#pragma once

#include "knn_tile.cuh"

namespace cell_norms {

constexpr int BN = 128;  // slots per tile

// The element types of a store (`kind`): B2's f32 tier passes 0 or 1, B3
// passes 1, B2's tensor-core scan (cells_mma.cu) any of the four.
enum Kind { KIND_F32 = 0, KIND_BF16 = 1, KIND_U8 = 2, KIND_I8 = 3 };

// The f32 value of element i of row x.
template <int KIND>
__device__ __forceinline__ float elem(const void* __restrict__ x, int i) {
  if constexpr (KIND == KIND_F32)
    return __ldg(static_cast<const float*>(x) + i);
  else if constexpr (KIND == KIND_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  else if constexpr (KIND == KIND_U8)
    return (float)static_cast<const uint8_t*>(x)[i];
  else
    return (float)static_cast<const int8_t*>(x)[i];
}

// |x|^2 over d elements, lanes over the features, summed across the warp.
template <int KIND>
__device__ __forceinline__ float row_norm(const void* x, int d, int lane) {
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = elem<KIND>(x, c);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// One block of 128 threads per (128-slot tile, list) of an (n_lists, cap,
// d) store of element type `kind`. Each tile's live flag (it holds a valid
// slot) and each slot's norm: NaN for an invalid slot or one past cap,
// else |y|^2 in f32 of the unrounded (widened) row for L2, 0 for inner
// product. A warp reads a row at a time, lanes over the features, and
// sums with shuffles.
__global__ void __launch_bounds__(BN)
b2_norms_kernel(const void* __restrict__ db, int kind,
                const uint8_t* __restrict__ invalid, float* __restrict__ yn,
                uint8_t* __restrict__ live, int cap, int capp, int d,
                int l2) {
  const int list = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = t * BN + warp * 32;
  const int slot = base + lane;
  const bool valid = slot < cap && !invalid[(size_t)list * cap + slot];
  float* out = yn + (size_t)list * capp;
  if (!valid || !l2) out[slot] = valid ? 0.f : knn::nan_f();
  unsigned bits = __ballot_sync(0xffffffffu, valid);
  const int any = __syncthreads_or(valid);
  if (threadIdx.x == 0) live[(size_t)list * gridDim.x + t] = any != 0;
  if (!l2) return;
  while (bits) {
    const int s = __ffs(bits) - 1;
    bits &= bits - 1;
    const size_t row = ((size_t)list * cap + base + s) * d;
    float acc;
    if (kind == KIND_BF16)
      acc = row_norm<KIND_BF16>(static_cast<const __nv_bfloat16*>(db) + row,
                                d, lane);
    else if (kind == KIND_U8)
      acc = row_norm<KIND_U8>(static_cast<const uint8_t*>(db) + row, d,
                              lane);
    else if (kind == KIND_I8)
      acc = row_norm<KIND_I8>(static_cast<const int8_t*>(db) + row, d,
                              lane);
    else
      acc = row_norm<KIND_F32>(static_cast<const float*>(db) + row, d, lane);
    if (lane == 0) out[base + s] = acc;
  }
}

// Launch the pre-pass over n_lists lists of a `kind` store into yn
// (n_lists, capp) and live (n_lists, capp / 128); capp is cap rounded up
// to 128.
inline cudaError_t launch(const void* db, int kind, const uint8_t* invalid,
                          float* yn, uint8_t* live, int n_lists, int cap,
                          int capp, int d, int l2, cudaStream_t st) {
  b2_norms_kernel<<<dim3(capp / BN, (unsigned)n_lists), BN, 0, st>>>(
      db, kind, invalid, yn, live, cap, capp, d, l2);
  return cudaGetLastError();
}

}  // namespace cell_norms
