// Fused exact kNN and packed-cells IVF-Flat scan for Hopper (sm_90a).
//
// Replaces two Pallas kernels of raft_tpu/ops/fused_knn.py:
//   * fused_knn_kernel (B1) replaces _fused_knn / _fused_knn_kernel: exact
//     kNN of m queries against an (n, d) database; with k=1 it is also the
//     k-means assignment (distance/fused_l2_nn.py);
//   * fused_cells_knn_kernel (B2) replaces fused_cells_knn /
//     _cells_knn_kernel: cell c scores its qrows queries against the list
//     cell_list[c] of a capacity-padded (L, cap, d) store, with a per-slot
//     invalid mask; cell_list[c] == -1 writes sentinels.
//
// Both compute what the Pallas kernels compute: a gram tile in f32 (or on
// operands rounded to bf16, optionally with the hi/lo split query), the
// clamped expanded-L2 max(|q|^2 + |y|^2 - 2g, 0) or the negated inner
// product, and a top-k ordered by (distance, id) so ties go to the lowest
// id. Norms are always f32 from the unrounded operands.
//
// What bounds them on the H100: the work's own bound is arithmetic (2*d
// flops per (query, row) pair at the FP32 non-tensor-core rate; the inputs
// are read once). This design does not reach it: every 32-query CTA
// re-reads the whole database, so at the brute-force shape (10k queries x
// 1M x 128) about 313 CTAs stream 512 MB each, ~160 GB in all, which is
// 2*32 flops per 4 bytes = 16 flop/B, under the card's ~20 flop/B ridge.
// Unless L2 catches the reuse, the kernel is bound by that memory traffic.
// The lever is more queries per CTA or a db-tile-major schedule whose
// tiles stay in L2 across query blocks. The f32 path must not use TF32
// tensor cores (about 3 decimal digits; it breaks parity with the
// reference's Precision.HIGHEST), so the product is a plain register-tiled
// FMA product: a CTA of 256 threads holds 32 queries, streams the database
// in 128-row tiles through shared memory in 32-feature chunks, and each
// thread accumulates a 4x4 micro-tile. The TPU grid's sequential db axis
// becomes this loop inside the CTA. The distance tile then goes through
// shared memory to a per-query running top-k (k <= 256) kept sorted in
// shared memory: one warp per query filters the tile against the current
// k-th best with a ballot and inserts the few survivors, which replaces the
// reference's k-pass select and k-pass merge. B2 skips 128-row tiles whose
// slots are all invalid, so a list's capacity padding costs no arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BQ = 32;       // queries per CTA
constexpr int BN = 128;      // database rows per tile
constexpr int BK = 32;       // features per staged chunk
constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int QS = BQ + 4;   // padded row stride of the query chunk
constexpr int DS = BN + 4;   // padded row stride of the db chunk / dist tile
constexpr int KMAX = 256;    // widest top-k queue
constexpr int NONE = 0x7fffffff;  // id of an empty queue slot

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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
  float* ds;   // [BK][DS] db chunk
  float* dt;   // [BQ][DS] distance tile
  float* qn;   // [BQ] query norms
  float* yn;   // [BN] db-row norms of the current tile
  int* ok;     // [BN] slot is a real, valid row
  float* kd;   // [BQ][k] queue distances, ascending
  int* ki;     // [BQ][k] queue ids
};

__device__ Smem carve(char* base, int k) {
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

size_t smem_bytes(int k) {
  return sizeof(float) * (2 * BK * QS + BK * DS + BQ * DS + BQ + 2 * BN)
         + (sizeof(float) + sizeof(int)) * BQ * (size_t)k;
}

// Insert (d, i) into the ascending queue of length k; warp-cooperative.
__device__ void queue_insert(float* kd, int* ki, int k, float d, int i,
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

// Scan rows [0, n) of db (row stride d) for the nq <= BQ queries at q (row
// stride d), keeping each query's best k in s.kd / s.ki. Slot r is skipped
// when invalid != nullptr && invalid[r].
template <typename DbT>
__device__ void scan_rows(const Smem& s, const float* __restrict__ q, int nq,
                          const DbT* __restrict__ db, int n, int d,
                          const uint8_t* __restrict__ invalid, int k,
                          bool l2, bool bf16, bool qsplit) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 31;   // db columns tx*4 .. tx*4+3
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
      // Stage the db chunk, unrounded (the norms need the raw values).
      for (int e = tid; e < BN * BK; e += NT) {
        int r = e / BK, c = e % BK;
        float v = 0.f;
        if (t0 + r < n && c0 + c < d)
          v = to_f(db[(size_t)(t0 + r) * d + c0 + c]);
        s.ds[c * DS + r] = v;
      }
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

__device__ void write_queues(const Smem& s, int nq, int k, float* out_d,
                             int* out_i) {
  for (int e = threadIdx.x; e < nq * k; e += NT) {
    float v = s.kd[e];
    int id = s.ki[e];
    out_d[e] = v;
    // Empty or starved slots (inf distance) report the -1 sentinel.
    out_i[e] = (id == NONE || isinf(v)) ? -1 : id;
  }
}

__global__ void __launch_bounds__(NT)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 float* __restrict__ out_d, int* __restrict__ out_i, int m,
                 int n, int d, int k, int l2, int bf16, int qsplit) {
  extern __shared__ __align__(16) char smem[];
  Smem s = carve(smem, k);
  int q0 = blockIdx.x * BQ;
  int nq = min(BQ, m - q0);
  scan_rows<float>(s, q + (size_t)q0 * d, nq, db, n, d, nullptr, k, l2, bf16,
                   qsplit);
  write_queues(s, nq, k, out_d + (size_t)q0 * k, out_i + (size_t)q0 * k);
}

template <typename DbT>
__global__ void __launch_bounds__(NT)
fused_cells_knn_kernel(const int* __restrict__ cell_list,
                       const float* __restrict__ q, const DbT* __restrict__ db,
                       const uint8_t* __restrict__ invalid,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int qrows, int cap, int d, int k, int l2, int bf16,
                       int qsplit) {
  extern __shared__ __align__(16) char smem[];
  Smem s = carve(smem, k);
  int cell = blockIdx.x;
  int q0 = blockIdx.y * BQ;
  int nq = min(BQ, qrows - q0);
  size_t row0 = (size_t)cell * qrows + q0;
  int list = cell_list[cell];
  if (list < 0) {
    for (int e = threadIdx.x; e < nq * k; e += NT) {
      out_d[row0 * k + e] = INFINITY;
      out_i[row0 * k + e] = -1;
    }
    return;
  }
  scan_rows<DbT>(s, q + row0 * d, nq, db + (size_t)list * cap * d, cap, d,
                 invalid + (size_t)list * cap, k, l2, bf16, qsplit);
  write_queues(s, nq, k, out_d + row0 * k, out_i + row0 * k);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int fused_knn_launch(const float* q, const float* db, float* out_d,
                     int* out_i, int m, int n, int d, int k, int l2, int bf16,
                     int qsplit, void* stream) {
  if (m <= 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_bytes(k);
  cudaError_t err = allow_smem(fused_knn_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + BQ - 1) / BQ);
  fused_knn_kernel<<<grid, NT, bytes, (cudaStream_t)stream>>>(
      q, db, out_d, out_i, m, n, d, k, l2, bf16, qsplit);
  return (int)cudaGetLastError();
}

int fused_cells_knn_launch(const int* cell_list, const float* q,
                           const void* db, int db_is_bf16,
                           const uint8_t* invalid, float* out_d, int* out_i,
                           int n_cells, int qrows, int cap, int d, int k,
                           int l2, int bf16, int qsplit, void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_bytes(k);
  dim3 grid(n_cells, (qrows + BQ - 1) / BQ);
  cudaError_t err;
  if (db_is_bf16) {
    auto kern = fused_cells_knn_kernel<__nv_bfloat16>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        cell_list, q, (const __nv_bfloat16*)db, invalid, out_d, out_i, qrows,
        cap, d, k, l2, bf16, qsplit);
  } else {
    auto kern = fused_cells_knn_kernel<float>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        cell_list, q, (const float*)db, invalid, out_d, out_i, qrows, cap, d,
        k, l2, bf16, qsplit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
