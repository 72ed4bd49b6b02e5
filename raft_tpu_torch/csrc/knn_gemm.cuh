// The register-tiled FP32 kNN tile for Hopper, the tile of B2's f32 tier
// (cells_knn.cu), and the pieces of kernel B1 (fused_knn) that its
// tensor-core scans share: the norm pre-pass, the slice merge and the
// cp.async copies with zero fill.
//
// B1 runs on tensor cores at every tier: its f32 tier on the 3xTF32 scan
// of knn_tf32.cu, which keeps the parity of an f32 gram with the
// reference's Precision.HIGHEST (one TF32 product would not), its bf16
// tiers on knn_mma.cu. Both take their norms from b1_norms_kernel (the f32
// tier; the bf16 tiers' pre-pass is their own) and merge their database
// slices with b1_merge_kernel.
//
// The FMA tile (B2's f32 tier; B2's bf16 tiers are cells_mma.cu). What
// bounds it: 2*d flops per (query, row) pair at the FP32 rate outside the
// tensor cores, where it has had no tensor-core design yet (knn_tf32.cu's
// split would keep its parity; ROADMAP B.1). What the design does about
// it:
//
//   * a CTA of 256 threads owns BQ query rows and sweeps 128-row database
//     tiles; each thread accumulates a (BQ/16) x 8 register micro-tile, so
//     a CTA re-reads the database once per BQ queries;
//   * features come in chunks of BK. 16-byte cp.async copies (4-byte ones
//     unless d % 4 == 0 and both operands start on 16 bytes; 8-byte ones
//     for a bf16 store) land each chunk row-major in a ring of STAGES
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
//   * write_k1 reduces a register (min, id) per query across the CTA
//     (k = 1), write_queue writes sorted queues.
//
// b1_merge_kernel: when B1's query blocks alone cannot fill the card, each
// database slice sweeps a contiguous range of whole tiles and writes its
// sorted top-k to a workspace, merged here by (distance, id). The per-pair
// arithmetic does not depend on the slice, so the result is the one
// sweep's, bit for bit.

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
