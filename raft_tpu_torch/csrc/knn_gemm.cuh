// The register-tiled FP32 kNN tile of kernel B1 (fused_knn) for Hopper:
// B1's f32 tier, and the tile of B2's f32 tier (cells_knn.cu).
//
// Replaces raft_tpu/ops/fused_knn.py::_fused_knn / _fused_knn_kernel on its
// f32 tier: the exact kNN of m queries against an (n, d) database, ordered
// by (distance, id) with ties to the lowest id, L2 (max(|q|^2 + |y|^2 -
// 2g, 0)) or inner product (-g). B1's bf16 tiers (operands rounded to
// bf16, optionally plus the low half of the split query) run on bf16
// tensor cores in knn_mma.cu, which shares this file's copies and slice
// merge; B2's in cells_mma.cu.
//
// What bounds it: 2*d flops per (query, row) pair at the FP32 rate outside
// the tensor cores (TF32 would break parity with the reference's
// Precision.HIGHEST, so the f32 tier runs FP32 FMA). At the
// brute-force shape (10,000 x 1M x 128) that is 38 ms on an H100 SXM; the
// bytes (0.5 GB) are 0.15 ms. What the design does about it:
//
//   * a CTA of 256 threads owns BQ queries (128, or 64 / 32 when the top-k
//     queue needs the room or m is small) and sweeps 128-row database
//     tiles; each thread accumulates a (BQ/16) x 8 register micro-tile, so
//     a CTA re-reads the database once per 128 queries (64 flop per byte of
//     db traffic, above the card's ridge). With k = 1 two CTAs share an SM
//     (their registers allow it), so one CTA's start and end overlap the
//     other's FMAs;
//   * features come in chunks of BK. 16-byte cp.async copies (4-byte ones
//     unless d % 4 == 0 and both operands start on 16 bytes) land each chunk row-major in a ring of STAGES
//     staging buffers, zero past m, n and d, STAGES chunks ahead of the one
//     being multiplied. Each thread moves its own pieces of the next chunk
//     through registers into feature-major buffers (double-buffered, one
//     barrier per chunk) in the middle of the current chunk's FMAs, so the
//     move does not idle the FMA pipe. Lane pairs share a 32-byte sector;
//     the staging stride (BK + 8) and the feature-major stride (rows + 4)
//     keep the piece reads, the transposing stores and the inner loop's
//     float4 reads free of bank conflicts;
//   * the inner loop reads 8 query and 8 row values per feature (four
//     16-byte loads, a warp covering 4 x 8 threads) for 64 FMAs;
//   * the norms come from a pre-pass, once per call (f32, sequential in
//     feature order, from the unrounded values);
//   * selection filters in registers: at the end of a tile the
//     accumulators become distances in place (NaN marks a pair past the
//     slice or already sent, which no test accepts), each compared with its
//     query's k-th (distance, id) in shared memory, a float test first.
//     Only the pairs that pass go through an atomic counter into a
//     per-query candidate buffer, and one warp per query that received any
//     inserts them into its sorted queue; a tile where no pair passes costs
//     one barrier. A buffer that overflows is drained and the unsent pairs
//     are offered again against the tighter k-th. With k = 1 each thread
//     keeps a running (min, id) per query in registers, reduced across the
//     CTA at the end;
//   * the grid is (query blocks, database slices): when the query blocks
//     alone cannot fill the card, each slice sweeps a contiguous range of
//     whole tiles and writes its sorted top-k to a workspace, and
//     b1_merge_kernel merges the slices by (distance, id). The per-pair
//     arithmetic does not depend on the slice, so the result is the one
//     sweep's, bit for bit.
//
// B2's f32 tier (cells_knn.cu) runs the same pieces (staging, which also
// reads bf16 rows, the transposing move, the chunk's FMAs, the k = 1
// reduction) over the cells of the packed IVF-Flat scan.
//
// On the H100 this runs at about half the FP32 peak (PERF.md); the k = 1
// scan, which does no selection, runs faster than k > 1, whose queue and
// epilogue need the registers of a second CTA.

#pragma once

#include <type_traits>

#include "knn_tile.cuh"

namespace knn_gemm {

using knn::KMAX;
using knn::nan_f;
using knn::NONE;
using knn::pair_less;

constexpr int NT = 256;          // threads per CTA
constexpr int NW = NT / 32;      // warps per CTA
constexpr int BN = 128;          // database rows per tile
constexpr int BK = 16;           // features per staged chunk
constexpr int SKP = BK + 8;      // row stride of a staging buffer
constexpr int STAGES = 2;        // staged chunks in flight
constexpr int CAND = 4096;       // candidate slots per CTA (CAND / BQ each)
constexpr int MAX_SLICES = 256;  // database slices the merge takes

static_assert(BK % 16 == 0, "a staged row is whole 32-byte sectors");

// Shared-memory bytes of one CTA (ops/fused_knn.py::_b1_smem_bytes).
inline size_t smem_bytes(int bq, int k, bool qsplit) {
  size_t stage = sizeof(float) * STAGES * (size_t)(bq + BN) * SKP;
  size_t tiles = sizeof(float) * 2 * BK *
                 ((size_t)(bq + 4) * (qsplit ? 2 : 1) + (BN + 4));
  if (k == 1) return stage + tiles;
  int c = CAND / bq;
  return stage + tiles + 8 * (size_t)bq * k + 8 * (size_t)bq * c +
         4 * (size_t)bq + 4 * (size_t)((bq + 31) / 32);
}

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

// The staged chunk holds BQ query rows, then BN database rows, BK features
// each, as 16-byte pieces. Piece u of this thread (u = tid, tid + NT, ...)
// is row (u / 2) % (BQ + BN), features 4 * (2 * ((u / 2) / (BQ + BN)) +
// u % 2) onward: a lane pair covers one 32-byte sector of one row.
template <int BQ>
struct Piece {
  static constexpr int ROWS = BQ + BN;
  static constexpr int COUNT = ROWS * BK / 4;
  int row, c4;
  __device__ __forceinline__ explicit Piece(int u) {
    int pr = u >> 1;
    row = pr % ROWS;
    c4 = 2 * (pr / ROWS) + (u & 1);
  }
};

// Issue this thread's copies of the chunk at features [c0, c0 + BK):
// queries q0 + [0, BQ) (valid below m), database rows t0 + [0, BN) (valid
// below r1). f32 rows take 16-byte copies with `vec` (queries) / `dvec`
// (rows), else 4-byte ones. A bf16 row's 4 features of a piece are 8 bytes
// and land in the first half of the piece's slot (transpose_piece widens
// them): one 8-byte copy with `dvec`, else 2-byte loads and stores.
template <int BQ, typename DbT = float>
__device__ __forceinline__ void stage(float* stg, const float* __restrict__ q,
                                      const DbT* __restrict__ db, int q0,
                                      int m, int t0, int r1, int c0, int d,
                                      bool vec, bool dvec) {
#pragma unroll
  for (int u = threadIdx.x; u < Piece<BQ>::COUNT; u += NT) {
    Piece<BQ> p(u);
    bool is_q = p.row < BQ;
    int r = is_q ? q0 + p.row : t0 + p.row - BQ;
    bool row_ok = r < (is_q ? m : r1);
    int c = c0 + 4 * p.c4;
    float* s = stg + p.row * SKP + 4 * p.c4;
    if constexpr (!std::is_same<DbT, float>::value) {
      if (!is_q) {
        const DbT* g = db + (size_t)(row_ok ? r : 0) * d;
        if (dvec) {
          bool ok = row_ok && c < d;
          cp_async8(s, ok ? g + c : db, ok ? 8 : 0);
        } else {
          unsigned short* h = reinterpret_cast<unsigned short*>(s);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            h[j] = row_ok && c + j < d ? __bfloat16_as_ushort(g[c + j]) : 0;
        }
        continue;
      }
    }
    const float* x = is_q ? q : reinterpret_cast<const float*>(db);
    const float* g = x + (size_t)(row_ok ? r : 0) * d;
    if (is_q ? vec : dvec) {
      bool ok = row_ok && c < d;
      cp_async16(s, ok ? g + c : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool ok = row_ok && c + j < d;
        cp_async4(s + j, ok ? g + c + j : x, ok ? 4 : 0);
      }
    }
  }
}

// Move this thread's landed piece u into the feature-major tiles A[f][row]
// (queries) and B[f][row] (database rows), widening bf16 rows (`db16`) to
// f32. Branch-free, so that it schedules among the FMAs of the chunk being
// multiplied.
template <int BQ>
__device__ __forceinline__ void transpose_piece(const float* stg, float* A,
                                                float* B, int u, bool db16) {
  constexpr int LDA = BQ + 4, LDB = BN + 4;
  Piece<BQ> p(u);
  float4 v = *reinterpret_cast<const float4*>(stg + p.row * SKP + 4 * p.c4);
  float x[4] = {v.x, v.y, v.z, v.w};
  const bool is_q = p.row < BQ;
  if (db16 && !is_q) {
    const unsigned lo = __float_as_uint(v.x), hi = __float_as_uint(v.y);
    x[0] = __uint_as_float(lo << 16);
    x[1] = __uint_as_float(lo & 0xffff0000u);
    x[2] = __uint_as_float(hi << 16);
    x[3] = __uint_as_float(hi & 0xffff0000u);
  }
  float* dst = is_q ? A + p.row : B + (p.row - BQ);
  const int ld = is_q ? LDA : LDB;
  const int f = 4 * p.c4;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[(f + e) * ld] = x[e];
}

// All of this thread's pieces of a landed chunk.
template <int BQ>
__device__ __forceinline__ void transpose(const float* stg, float* A,
                                          float* B, bool db16) {
#pragma unroll
  for (int u = threadIdx.x; u < Piece<BQ>::COUNT; u += NT)
    transpose_piece<BQ>(stg, A, B, u, db16);
}

// Thread (tx, ty) of the 16 x 16 grid: a warp covers tx = 8 (w % 2) + l % 8
// and ty = 4 (w / 2) + l / 8. Its query rows and database rows:
template <int TM>
__device__ __forceinline__ int qrow(int ty, int i) {
  if constexpr (TM == 8) return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
  else return ty * TM + i;
}

__device__ __forceinline__ int dcol(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
}

template <int TM>
__device__ __forceinline__ void load_a(float (&a)[TM], const float* A, int ty) {
  if constexpr (TM == 8) {
    float4 u = *reinterpret_cast<const float4*>(A + ty * 4);
    float4 v = *reinterpret_cast<const float4*>(A + 64 + ty * 4);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
  } else if constexpr (TM == 4) {
    float4 u = *reinterpret_cast<const float4*>(A + ty * 4);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  } else if constexpr (TM == 2) {
    float2 u = *reinterpret_cast<const float2*>(A + ty * 2);
    a[0] = u.x; a[1] = u.y;
  } else {
    a[0] = A[ty];
  }
}

// acc[i][j] += the chunk's products, feature by feature. Meanwhile this
// thread moves its pieces of the next chunk from the staging buffer `nstg`
// into the other tile buffers (An, Bn), one piece every few features.
template <int BQ>
__device__ __forceinline__ void compute_chunk(
    float (&acc)[BQ / 16][8], const float* __restrict__ A,
    const float* __restrict__ B, int tx, int ty,
    const float* __restrict__ nstg, float* __restrict__ An,
    float* __restrict__ Bn, bool db16) {
  constexpr int TM = BQ / 16, LDA = BQ + 4, LDB = BN + 4;
  constexpr int COUNT = Piece<BQ>::COUNT;
  constexpr int PPT = (COUNT + NT - 1) / NT;  // pieces per thread
  constexpr int EVERY = BK / PPT > 0 ? BK / PPT : 1;
#pragma unroll
  for (int f = 0; f < BK; ++f) {
    float a[TM], b[8];
    float4 u = *reinterpret_cast<const float4*>(B + f * LDB + tx * 4);
    float4 v = *reinterpret_cast<const float4*>(B + f * LDB + 64 + tx * 4);
    b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
    b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
    load_a<TM>(a, A + f * LDA, ty);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    if (f % EVERY == 0 && f / EVERY < PPT) {
      const int piece = threadIdx.x + NT * (f / EVERY);
      if (COUNT % NT == 0 || piece < COUNT)
        transpose_piece<BQ>(nstg, An, Bn, piece, db16);
    }
  }
}

// Write the k = 1 result of each of the CTA's nq query rows to od / oi[r]:
// each row's 16 running (min, id) pairs sit in lanes l % 8 of warps w and
// w ^ 1; reduce the 8 in a warp by shuffles, the two warps through
// `scratch` (4 * BQ words of idle shared memory). With `direct`, ids of
// empty or inf slots become -1. Called by the whole CTA, synchronised.
template <int BQ>
__device__ __forceinline__ void write_k1(float (&bd)[BQ / 16],
                                         int (&bi)[BQ / 16], float* scratch,
                                         int nq, float* od, int* oi,
                                         bool direct) {
  constexpr int TM = BQ / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = 4 * (warp >> 1) + (lane >> 3);
  float* red_d = scratch;                                  // [2][BQ]
  int* red_i = reinterpret_cast<int*>(scratch + 2 * BQ);   // [2][BQ]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      float v = __shfl_xor_sync(0xffffffffu, bd[i], o);
      int id = __shfl_xor_sync(0xffffffffu, bi[i], o);
      if (pair_less(v, id, bd[i], bi[i])) {
        bd[i] = v;
        bi[i] = id;
      }
    }
    if ((lane & 7) == 0) {
      int r = qrow<TM>(ty, i);
      red_d[(warp & 1) * BQ + r] = bd[i];
      red_i[(warp & 1) * BQ + r] = bi[i];
    }
  }
  __syncthreads();
  for (int r = tid; r < nq; r += NT) {
    float v = red_d[r];
    int id = red_i[r];
    if (pair_less(red_d[BQ + r], red_i[BQ + r], v, id)) {
      v = red_d[BQ + r];
      id = red_i[BQ + r];
    }
    od[r] = v;
    oi[r] = (direct && (id == NONE || isinf(v))) ? -1 : id;
  }
}

// Write the sorted queues kd / ki [nq][k] to od / oi; with `direct`, ids
// of empty or inf slots become -1.
__device__ __forceinline__ void write_queue(const float* kd, const int* ki,
                                            int nq, int k, float* od,
                                            int* oi, bool direct) {
  for (int e = threadIdx.x; e < nq * k; e += NT) {
    float v = kd[e];
    int id = ki[e];
    od[e] = v;
    oi[e] = (direct && (id == NONE || isinf(v))) ? -1 : id;
  }
}

// One CTA: queries [q0, q0 + BQ) against database slice blockIdx.y, rows
// [r0, r1). Writes the slice's top-k, ascending by (distance, id), to
// out + (blockIdx.y * m + query) * k; with `direct` (one slice) the ids
// of empty or inf slots become -1 there, else they stay for the merge.
// `vec`: every row of q and db starts on 16 bytes (16-byte copies).
template <int BQ, bool K1>
__global__ void __launch_bounds__(NT, K1 ? 2 : 1)
b1_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
               const float* __restrict__ qn, const float* __restrict__ yn,
               float* __restrict__ out_d, int* __restrict__ out_i, int m,
               int n, int d, int k, int l2, int slice_rows, int direct,
               int vec) {
  constexpr int TM = BQ / 16;
  constexpr int C = CAND / BQ;
  constexpr int LDA = BQ + 4, LDB = BN + 4;
  extern __shared__ __align__(16) float smem[];
  constexpr int SSZ = (BQ + BN) * SKP;
  float* stg = smem;                                   // [STAGES][SSZ]
  float* At = stg + STAGES * SSZ;                      // [2][BK][LDA]
  float* Bt = At + 2 * BK * LDA;                       // [2][BK][LDB]
  float* kd = Bt + 2 * BK * LDB;                       // [BQ][k]
  int* ki = reinterpret_cast<int*>(kd + BQ * k);       // [BQ][k]
  float* cd = reinterpret_cast<float*>(ki + BQ * k);   // [BQ][C]
  int* ci = reinterpret_cast<int*>(cd + BQ * C);       // [BQ][C]
  int* cnt = ci + BQ * C;                              // [BQ]
  unsigned* qmask = reinterpret_cast<unsigned*>(cnt + BQ);  // [BQ / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = 8 * (warp & 1) + (lane & 7);
  const int ty = 4 * (warp >> 1) + (lane >> 3);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, m - q0);
  const int r0 = blockIdx.y * slice_rows;
  const int r1 = min(n, r0 + slice_rows);
  const int nchunk = (d + BK - 1) / BK;
  const int total = ((r1 - r0 + BN - 1) / BN) * nchunk;

  bool qok[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) qok[i] = qrow<TM>(ty, i) < nq;
  float bd[TM];
  int bi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bd[i] = INFINITY;
    bi[i] = NONE;
  }
  if (!K1) {
    for (int j = tid; j < BQ * k; j += NT) {
      kd[j] = INFINITY;
      ki[j] = NONE;
    }
    for (int j = tid; j < BQ; j += NT) cnt[j] = 0;
    for (int j = tid; j < (BQ + 31) / 32; j += NT) qmask[j] = 0;
  }
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Chunk j (tile j / nchunk, features (j % nchunk) * BK on) lands in
  // staging buffer j % STAGES and is moved into tile buffer j % 2 while
  // chunk j - 1 is multiplied; every step commits one group, empty or not.
  auto issue = [&](int j) {
    if (j < total)
      stage<BQ>(stg + (j % STAGES) * SSZ, q, db, q0, m, r0 + (j / nchunk) * BN,
                r1, (j % nchunk) * BK, d, vec, vec);
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES; ++j) issue(j);
  cp_wait<STAGES - 1>();
  transpose<BQ>(stg, At, Bt, false);
  issue(STAGES);
  __syncthreads();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1, tile = it / nchunk, c = it % nchunk;
    const int nb = buf ^ 1;
    // Chunk it + 1 has landed (this thread's copies of it).
    cp_wait<STAGES - 1>();
    compute_chunk<BQ>(acc, At + buf * BK * LDA, Bt + buf * BK * LDB, tx, ty,
                      stg + ((it + 1) % STAGES) * SSZ, At + nb * BK * LDA,
                      Bt + nb * BK * LDB, false);
    // This thread has read its pieces of chunk it + 1: refill the buffer.
    issue(it + 1 + STAGES);

    if (c == nchunk - 1) {
      // Epilogue of the tile at rows t0 + [0, BN). The accumulators become
      // the pairs' distances in place; NaN marks a pair past the slice (or,
      // below, one already sent), which every test below rejects.
      const int t0 = r0 + tile * BN;
      float qnr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qnr[i] = (l2 && qok[i]) ? qn[q0 + qrow<TM>(ty, i)] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int id = t0 + dcol(tx, j);
        const bool ok = id < r1;
        const float y = (l2 && ok) ? yn[id] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float g = acc[i][j];
          float v = l2 ? fmaxf((qnr[i] + y) - 2.0f * g, 0.f) : -g;
          acc[i][j] = ok ? v : nan_f();
        }
      }
      if (K1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int id = t0 + dcol(tx, j);
            if (pair_less(acc[i][j], id, bd[i], bi[i])) {
              bd[i] = acc[i][j];
              bi[i] = id;
            }
          }
      } else {
        const unsigned mine = 0x01010101u << warp;  // queries r % NW == warp
        while (true) {
          bool over = false, any = false;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (!qok[i]) continue;
            const int r = qrow<TM>(ty, i);
            const float td = kd[r * k + k - 1];
            const int ti = ki[r * k + k - 1];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float v = acc[i][j];
              const int id = t0 + dcol(tx, j);
              // The float test first: almost every pair fails it.
              if (v <= td && pair_less(v, id, td, ti)) {
                any = true;
                int slot = atomicAdd(&cnt[r], 1);
                if (slot < C) {
                  cd[r * C + slot] = v;
                  ci[r * C + slot] = id;
                  acc[i][j] = nan_f();
                  atomicOr(&qmask[r >> 5], 1u << (r & 31));
                } else {
                  over = true;
                }
              }
            }
          }
          if (!__syncthreads_or(any)) break;
          // Warp w inserts the candidates of its queries r % NW == w that
          // have any (the bits of qmask), then clears its bits.
          for (int w0 = 0; w0 < (BQ + 31) / 32; ++w0) {
            unsigned bits = __shfl_sync(0xffffffffu, qmask[w0], 0) & mine;
            while (bits) {
              const int r = 32 * w0 + __ffs(bits) - 1;
              bits &= bits - 1;
              const int nc_r = min(cnt[r], C);
              float* qd = kd + r * k;
              int* qi = ki + r * k;
              float td = qd[k - 1];
              int ti = qi[k - 1];
              for (int j0 = 0; j0 < nc_r; j0 += 32) {
                int j = j0 + lane;
                float v = j < nc_r ? cd[r * C + j] : INFINITY;
                int id = j < nc_r ? ci[r * C + j] : NONE;
                bool cand = j < nc_r && pair_less(v, id, td, ti);
                unsigned mask = __ballot_sync(0xffffffffu, cand);
                while (mask) {
                  int src = __ffs(mask) - 1;
                  mask &= mask - 1;
                  float cv = __shfl_sync(0xffffffffu, v, src);
                  int cid = __shfl_sync(0xffffffffu, id, src);
                  if (pair_less(cv, cid, td, ti)) {
                    knn::queue_insert(qd, qi, k, cv, cid, lane);
                    td = qd[k - 1];
                    ti = qi[k - 1];
                  }
                }
              }
              __syncwarp();
              if (lane == 0) cnt[r] = 0;
            }
            if (lane == 0) atomicAnd(&qmask[w0], ~mine);
          }
          if (!__syncthreads_or(over)) break;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();
  }

  float* od = out_d + ((size_t)blockIdx.y * m + q0) * k;
  int* oi = out_i + ((size_t)blockIdx.y * m + q0) * k;
  __syncthreads();
  if (K1)
    write_k1<BQ>(bd, bi, stg, nq, od, oi, direct);
  else
    write_queue(kd, ki, nq, k, od, oi, direct);
}

// |x|^2 of the m rows of q, then the n rows of db, into out[0, m + n): one
// thread per row, f32 FMA in feature order; float4 loads with `vec`.
__global__ void b1_norms_kernel(const float* __restrict__ q,
                                const float* __restrict__ db,
                                float* __restrict__ out, int m, int n, int d,
                                int vec) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)m + n) return;
  const float* x = r < m ? q + (size_t)r * d : db + (size_t)(r - m) * d;
  float acc = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int c = 0; c < d / 4; ++c) {
      float4 v = __ldg(x4 + c);
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
  } else {
    for (int c = 0; c < d; ++c) {
      float v = __ldg(x + c);
      acc = fmaf(v, v, acc);
    }
  }
  out[r] = acc;
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
