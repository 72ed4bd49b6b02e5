// The shared tile loop of the port's kNN kernels (B1-B4) for Hopper.
//
// One CTA of NT threads keeps the running top-k of up to BQ query rows. It
// sweeps "rows" (database rows for B1-B3, PQ code slots for B4) in tiles of
// BN, and features in chunks of BK staged through shared memory by a
// Loader, which writes the raw f32 values of rows [t0, t0 + BN) and features
// [c0, c0 + BK) into ds[feature * DS + row] (0 outside the data). B1-B3 load
// database rows; B4 decodes PQ codes through a codeword table. Per tile:
//
//   * the gram tile: each thread accumulates a 4x4 micro-tile with f32 FMA,
//     on operands rounded to bf16 (round to nearest even, as astype does)
//     when `bf16`, plus the low half of the split query when `qsplit`;
//     bf16 products are exact in f32, so the bf16 tiers are exact products
//     with f32 sums, like the reference's bf16 matmul with f32 accumulation;
//   * row norms in f32 from the unrounded values, query norms likewise;
//   * the epilogue: max(|q|^2 + |y|^2 - 2g, 0) for L2, -g for inner product
//     (selection is always "min of work");
//   * selection: one warp per query filters the tile against its current
//     k-th (distance, id) pair with a ballot and inserts the survivors into
//     a sorted queue in shared memory, ties to the lowest id.
//
// Tiles whose rows are all invalid (or past n) are skipped whole, so a
// list's capacity padding costs no arithmetic. Slots left at inf report -1.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace knn {

constexpr int BQ = 32;       // queries per CTA
constexpr int BN = 128;      // rows per tile
constexpr int BK = 32;       // features per staged chunk
constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int QS = BQ + 4;   // padded row stride of the query chunk
constexpr int DS = BN + 4;   // padded row stride of the row chunk / dist tile
constexpr int KMAX = 256;    // widest top-k queue
constexpr int NONE = 0x7fffffff;  // id of an empty queue slot

// Round to the nearest bf16 (ties to even), as astype(bfloat16) does.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

struct Smem {
  float* qs;   // [BK][QS] query chunk (hi part when qsplit)
  float* ql;   // [BK][QS] low part of the split query
  float* ds;   // [BK][DS] row chunk
  float* dt;   // [BQ][DS] distance tile
  float* qn;   // [BQ] query norms
  float* yn;   // [BN] row norms of the current tile
  int* ok;     // [BN] slot is a real, valid row
  float* kd;   // [BQ][k] queue distances, ascending
  int* ki;     // [BQ][k] queue ids
};

__device__ inline Smem carve(char* base, int k) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.qs = f; f += BK * QS;
  s.ql = f; f += BK * QS;
  s.ds = f; f += BK * DS;
  s.dt = f; f += BQ * DS;
  s.qn = f; f += BQ;
  s.yn = f; f += BN;
  s.ok = reinterpret_cast<int*>(f); f += BN;
  s.kd = f; f += BQ * k;
  s.ki = reinterpret_cast<int*>(f);
  return s;
}

inline size_t smem_bytes(int k) {
  return sizeof(float) * (2 * BK * QS + BK * DS + BQ * DS + BQ + 2 * BN)
         + (sizeof(float) + sizeof(int)) * BQ * (size_t)k;
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

// Scan rows [0, n) for the nq <= BQ queries at q (row stride d = the
// feature count), keeping each query's best k in s.kd / s.ki. Slot r is
// skipped when invalid != nullptr && invalid[r]. `load` stages row chunks.
template <typename Loader>
__device__ void scan_tiles(const Smem& s, const float* __restrict__ q, int nq,
                           int n, int d, const uint8_t* __restrict__ invalid,
                           int k, bool l2, bool bf16, bool qsplit,
                           const Loader& load) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 31;   // tile columns tx*4 .. tx*4+3
  const int ty = tid >> 5;   // query rows ty*4 .. ty*4+3
  qsplit = qsplit && bf16;   // the split query exists on the bf16 path only

  for (int j = tid; j < BQ * k; j += NT) {
    s.kd[j] = INFINITY;
    s.ki[j] = NONE;
  }
  // Query norms, f32 from the unrounded query.
  for (int r = warp; r < BQ; r += NW) {
    float acc = 0.f;
    if (r < nq)
      for (int c = lane; c < d; c += 32) {
        float v = q[(size_t)r * d + c];
        acc = fmaf(v, v, acc);
      }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s.qn[r] = acc;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += BN) {
    int any = 0;
    if (tid < BN) {
      int r = t0 + tid;
      int ok = r < n && !(invalid != nullptr && invalid[r]);
      s.ok[tid] = ok;
      any = ok;
    }
    if (!__syncthreads_or(any)) continue;

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    float ynorm = 0.f;

    for (int c0 = 0; c0 < d; c0 += BK) {
      // Stage the query chunk (rounded / split on the bf16 path).
      for (int e = tid; e < BQ * BK; e += NT) {
        int r = e / BK, c = e % BK;
        float v = (r < nq && c0 + c < d) ? q[(size_t)r * d + c0 + c] : 0.f;
        if (bf16) {
          float h = round_bf16(v);
          s.qs[c * QS + r] = h;
          s.ql[c * QS + r] = qsplit ? round_bf16(v - h) : 0.f;
        } else {
          s.qs[c * QS + r] = v;
        }
      }
      // Stage the row chunk, unrounded (the norms need the raw values).
      load(s.ds, t0, c0);
      __syncthreads();
      if (tid < BN) {
#pragma unroll 8
        for (int c = 0; c < BK; ++c) {
          float v = s.ds[c * DS + tid];
          ynorm = fmaf(v, v, ynorm);
        }
      }
      if (bf16) {
        __syncthreads();
        for (int e = tid; e < BN * BK; e += NT) {
          int r = e % BN, c = e / BN;
          s.ds[c * DS + r] = round_bf16(s.ds[c * DS + r]);
        }
        __syncthreads();
      }
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float4 a = *reinterpret_cast<const float4*>(&s.qs[c * QS + ty * 4]);
        float4 b = *reinterpret_cast<const float4*>(&s.ds[c * DS + tx * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        if (qsplit) {
          float4 l = *reinterpret_cast<const float4*>(&s.ql[c * QS + ty * 4]);
          float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(lv[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    if (tid < BN) s.yn[tid] = ynorm;
    __syncthreads();

    // Epilogue: min-order distances into the tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty * 4 + i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float g = acc[i][j];
        o[j] = l2 ? fmaxf(s.qn[r] + s.yn[tx * 4 + j] - 2.0f * g, 0.f) : -g;
      }
      *reinterpret_cast<float4*>(&s.dt[r * DS + tx * 4]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    // Selection: warp w keeps the queues of queries w, w+NW, ...
    for (int r = warp; r < nq; r += NW) {
      float* kd = s.kd + r * k;
      int* ki = s.ki + r * k;
      float td = kd[k - 1];
      int ti = ki[k - 1];
      for (int c0 = 0; c0 < BN; c0 += 32) {
        int c = c0 + lane;
        float v = s.dt[r * DS + c];
        int id = t0 + c;
        bool cand = s.ok[c] && pair_less(v, id, td, ti);
        unsigned mask = __ballot_sync(0xffffffffu, cand);
        while (mask) {
          int src = __ffs(mask) - 1;
          mask &= mask - 1;
          float cv = __shfl_sync(0xffffffffu, v, src);
          int cid = __shfl_sync(0xffffffffu, id, src);
          if (pair_less(cv, cid, td, ti)) {
            queue_insert(kd, ki, k, cv, cid, lane);
            td = kd[k - 1];
            ti = ki[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }
}

__device__ inline void write_queues(const Smem& s, int nq, int k,
                                    float* out_d, int* out_i) {
  for (int e = threadIdx.x; e < nq * k; e += NT) {
    float v = s.kd[e];
    int id = s.ki[e];
    out_d[e] = v;
    // Empty or starved slots (inf distance) report the -1 sentinel.
    out_i[e] = (id == NONE || isinf(v)) ? -1 : id;
  }
}

// A whole CTA writes the (inf, -1) sentinels of an unused cell.
__device__ inline void write_sentinels(int nq, int k, float* out_d,
                                       int* out_i) {
  for (int e = threadIdx.x; e < nq * k; e += NT) {
    out_d[e] = INFINITY;
    out_i[e] = -1;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace knn
