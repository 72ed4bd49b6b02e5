// The pre-pass of the row scans that walk only live 128-slot tiles: B2
// (cells_knn.cu) and B3 (batch_knn.cu). Part of every call; the index
// keeps nothing, so extend / upsert / compact cannot leave it stale.

#pragma once

#include "knn_tile.cuh"

namespace cell_norms {

constexpr int BN = 128;  // slots per tile

// One block of 128 threads per (128-slot tile, list) of an (n_lists, cap,
// d) f32 or bf16 (db16) store. Each tile's live flag (it holds a valid
// slot) and each slot's norm: NaN for an invalid slot or one past cap,
// else |y|^2 in f32 of the unrounded (widened) row for L2, 0 for inner
// product. A warp reads a row at a time, lanes over the features, and
// sums with shuffles.
__global__ void __launch_bounds__(BN)
b2_norms_kernel(const void* __restrict__ db, int db16,
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
    float acc = 0.f;
    if (db16) {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(db) + row;
      for (int c = lane; c < d; c += 32) {
        const float v = __bfloat162float(x[c]);
        acc = fmaf(v, v, acc);
      }
    } else {
      const float* x = static_cast<const float*>(db) + row;
      for (int c = lane; c < d; c += 32) {
        const float v = __ldg(x + c);
        acc = fmaf(v, v, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[base + s] = acc;
  }
}

// Launch the pre-pass over n_lists lists into yn (n_lists, capp) and live
// (n_lists, capp / 128); capp is cap rounded up to 128.
inline cudaError_t launch(const void* db, int db16, const uint8_t* invalid,
                          float* yn, uint8_t* live, int n_lists, int cap,
                          int capp, int d, int l2, cudaStream_t st) {
  b2_norms_kernel<<<dim3(capp / BN, (unsigned)n_lists), BN, 0, st>>>(
      db, db16, invalid, yn, live, cap, capp, d, l2);
  return cudaGetLastError();
}

}  // namespace cell_norms
