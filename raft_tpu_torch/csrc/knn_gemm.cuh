// The pieces of kernel B1 (fused_knn) that its tensor-core scans share,
// and the cp.async copies with zero fill that B1's and B2's f32-tier scans
// use: B1's f32 tier runs the 3xTF32 scan of knn_tf32.cu, its bf16 tiers
// knn_mma.cu; both merge their database slices with b1_merge_kernel, and
// the f32 tier takes its norms from b1_norms_kernel (the bf16 tiers'
// pre-pass is their own). B2's f32 tier (cells_tf32.cu) stages its rows
// with the copies here.
//
// b1_merge_kernel: when B1's query blocks alone cannot fill the card, each
// database slice sweeps a contiguous range of whole tiles and writes its
// sorted top-k to a workspace, merged here by (distance, id). The per-pair
// arithmetic does not depend on the slice, so the result is the one
// sweep's, bit for bit.

#pragma once

#include "knn_tile.cuh"

namespace knn_gemm {

using knn::NONE;
using knn::pair_less;

constexpr int MAX_SLICES = 256;  // database slices the merge takes

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// |x|^2 of the m rows of q, then the n rows of db, into out[0, m + n), f32
// from the unrounded values: one warp a row, lane l summing features l,
// l + 32, ... with FMAs in order, then the 32 lane sums by an xor tree
// (the bf16 tiers' pre-pass sums so too). The rows are read as coalesced
// lines, and the tree keeps the error of a long row near a blocked sum's:
// a thread summing a whole row in feature order read each row's lines by
// a different thread and, at d = 1024, carried 4.5x the error of the
// plain version's norms against float64 on an H100.
constexpr int NORMS_THREADS = 256;

__global__ void __launch_bounds__(NORMS_THREADS)
    b1_norms_kernel(const float* __restrict__ q, const float* __restrict__ db,
                    float* __restrict__ out, int m, int n, int d) {
  const long long r = (long long)blockIdx.x * (NORMS_THREADS / 32) +
                      threadIdx.x / 32;
  if (r >= (long long)m + n) return;
  const int lane = threadIdx.x & 31;
  const float* x = r < m ? q + r * d : db + (r - m) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = __ldg(x + c);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = acc;
}

// Merge the S sorted slice lists ws[s][query][0, k) of each query by
// (distance, id) into out[query][0, k); empty or inf slots report id -1.
// One warp per query; lane l owns the lists l, l + 32, ...
constexpr int MERGE_WARPS = 8;

__global__ void __launch_bounds__(MERGE_WARPS * 32)
b1_merge_kernel(const float* __restrict__ wd, const int* __restrict__ wi,
                float* __restrict__ out_d, int* __restrict__ out_i, int m,
                int k, int S) {
  __shared__ int cur[MERGE_WARPS][MAX_SLICES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qr = blockIdx.x * MERGE_WARPS + warp;
  if (qr >= m) return;
  int* cw = cur[warp];
  for (int s = lane; s < S; s += 32) cw[s] = 0;
  __syncwarp();
  // This lane's best head over its lists.
  auto best_head = [&](float& hd, int& hi, int& hs) {
    hd = INFINITY;
    hi = NONE;
    hs = -1;
    for (int s = lane; s < S; s += 32) {
      int p = cw[s];
      if (p >= k) continue;
      size_t e = ((size_t)s * m + qr) * k + p;
      float v = wd[e];
      int id = wi[e];
      if (hs < 0 || pair_less(v, id, hd, hi)) {
        hd = v;
        hi = id;
        hs = s;
      }
    }
  };
  float hd;
  int hi, hs;
  best_head(hd, hi, hs);
  for (int j = 0; j < k; ++j) {
    float bv = hd;
    int bid = hi, bl = hs < 0 ? 32 : lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float v = __shfl_xor_sync(0xffffffffu, bv, o);
      int id = __shfl_xor_sync(0xffffffffu, bid, o);
      int l = __shfl_xor_sync(0xffffffffu, bl, o);
      bool take = pair_less(v, id, bv, bid) ||
                  (!pair_less(bv, bid, v, id) && l < bl);
      if (take) {
        bv = v;
        bid = id;
        bl = l;
      }
    }
    if (lane == 0) {
      out_d[(size_t)qr * k + j] = bv;
      out_i[(size_t)qr * k + j] = (bid == NONE || isinf(bv)) ? -1 : bid;
    }
    if (lane == bl) {
      cw[hs] += 1;
      best_head(hd, hi, hs);
    }
    __syncwarp();
  }
}

}  // namespace knn_gemm
