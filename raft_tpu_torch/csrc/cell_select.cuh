// Cell-level top-k selection of the packed scans for Hopper: B2
// (cells_knn.cu), B3 (batch_knn.cu) and B4 (pq_scan.cu).
//
// Each scan gives one CTA of 256 threads the rows of one query cell (B3:
// one block of a bucket) and sweeps the 128-slot tiles of one list. Each
// tile ends as a register filter (in the kernel, because it depends on the
// tile's register map): the pairs that beat their row's k-th (distance,
// slot) go into per-row candidate buffers in shared memory. The pieces
// here then serve all three:
//
//   * next_live: the next tile of a list that holds a valid slot, from
//     the per-tile live flags of a pre-pass, with no barrier;
//   * first_tile_bounds: a cell's first live tile meets empty queues, so
//     every pair would pass. For k <= NET_K, the k-th smallest of the
//     per-thread minima of a row (each a distinct pair) bounds the row's
//     k-th smallest from above, so only about k pairs a row pass;
//   * drain_network / drain_merge: the buffered candidates enter the
//     sorted queues. For k <= NET_K one thread per row runs them through
//     an unrolled insertion network on the queue held in registers; for
//     k > NET_K one warp per row sorts them (warp bitonic sort) and
//     merges by rank.
//
// Candidate j of row r sits at cd[r * rs + j * js]: slot-major (rs = 1,
// js = BQ) for k <= NET_K, so each thread reads its row's candidates side
// by side with the other rows', and row-major (rs = C, js = 1) above.

#pragma once

#include "knn_tile.cuh"

namespace cell_select {

using knn::KMAX;
using knn::NONE;
using knn::pair_less;

constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int NET_K = 16;    // widest queue kept in registers

// Selection of a scan instance: k = 1 (a register minimum per row),
// k <= NET_K (the insertion network), k > NET_K (warp merges), or either
// of the last two by k at run time.
enum Sel { SEL_MIN, SEL_NET, SEL_MERGE, SEL_ANY };

// The shared-memory queues of one CTA's BQ rows.
struct Queues {
  float* kd;        // [BQ][k] queue distances, ascending
  int* ki;          // [BQ][k] queue slots
  float* cd;        // candidate distances (C per row)
  int* ci;          // candidate slots
  int* cnt;         // [BQ] candidates offered this round
  unsigned* qmask;  // [ceil(BQ / 32)] rows with candidates (k > NET_K)
  float* tm;        // [BQ][NE] per-thread row minima (k <= NET_K)
  float* thr;       // [BQ] first-tile bounds (k <= NET_K)
};

// The next tile after t that holds a valid slot (ntiles if none), from
// the pre-pass's live flags of the list, 32 tiles a load. Every warp
// computes the same answer, so no barrier is needed.
__device__ __forceinline__ int next_live(const uint8_t* __restrict__ live,
                                         int t, int ntiles) {
  const int lane = threadIdx.x & 31;
  for (int t0 = t + 1; t0 < ntiles; t0 += 32) {
    const unsigned m = __ballot_sync(
        0xffffffffu, t0 + lane < ntiles && live[t0 + lane]);
    if (m) return t0 + __ffs(m) - 1;
  }
  return ntiles;
}

// Warp-wide bitonic sort of 32 * E (distance, slot) pairs, E per lane
// (element lane * E + e), ascending by pair_less.
template <int E>
__device__ __forceinline__ void warp_sort(float (&d)[E], int (&id)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int f = e | j;
          if (e & j) continue;
          const bool up = ((lane * E + e) & size) == 0;
          if (pair_less(d[f], id[f], d[e], id[e]) == up) {
            const float td = d[e];
            const int ti = id[e];
            d[e] = d[f];
            id[e] = id[f];
            d[f] = td;
            id[f] = ti;
          }
        }
      } else {
        const int lj = j / E;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float od = __shfl_xor_sync(0xffffffffu, d[e], lj);
          const int oi = __shfl_xor_sync(0xffffffffu, id[e], lj);
          const bool up = ((lane * E + e) & size) == 0;
          const bool other_less = pair_less(od, oi, d[e], id[e]);
          if (lower == up ? other_less : !other_less) {
            d[e] = od;
            id[e] = oi;
          }
        }
      }
    }
  }
}

// How many of the n ascending pairs (d[i], id[i]) come before (x, xi).
__device__ __forceinline__ int rank_in(const float* d, const int* id, int n,
                                       float x, int xi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pair_less(d[mid], id[mid], x, xi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One warp merges the nc <= 32 * E candidates cd / ci of a row into its
// ascending queue qd / qi of length k: sort the candidates, then place
// every element of both lists at its rank in the union (the pairs are
// distinct: each slot is offered once) and keep the first k.
template <int E>
__device__ __forceinline__ void merge_row(float* qd, int* qi, int k,
                                          float* cd, int* ci, int nc) {
  const int lane = threadIdx.x & 31;
  float d[E];
  int id[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    d[e] = j < nc ? cd[j] : INFINITY;
    id[e] = j < nc ? ci[j] : NONE;
  }
  warp_sort<E>(d, id);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    if (j < nc) {
      cd[j] = d[e];
      ci[j] = id[e];
    }
  }
  __syncwarp();
  int cpos[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    cpos[e] = (j < nc && j < k) ? j + rank_in(qd, qi, k, d[e], id[e]) : k;
  }
  constexpr int QT = KMAX / 32;
  float vd[QT];
  int vi[QT], vpos[QT];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    const int q = t * 32 + lane;
    vpos[t] = k;
    if (q < k) {
      vd[t] = qd[q];
      vi[t] = qi[q];
      vpos[t] = q + rank_in(cd, ci, nc, vd[t], vi[t]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < QT; ++t)
    if (vpos[t] < k) {
      qd[vpos[t]] = vd[t];
      qi[vpos[t]] = vi[t];
    }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (cpos[e] < k) {
      qd[cpos[e]] = d[e];
      qi[cpos[e]] = id[e];
    }
  __syncwarp();
}

// One thread inserts the nc candidates cd / ci[j * stride] of a row, in
// order, into its ascending queue qd / qi of length k <= NET_K. The queue
// lives in registers meanwhile and each candidate goes through an
// unrolled insertion network (no dependent shared-memory round trips);
// entries past k are ignored.
__device__ __forceinline__ void insert_regs(float* qd, int* qi, int k,
                                            const float* cd, const int* ci,
                                            int stride, int nc) {
  float qv[NET_K];
  int qx[NET_K];
  float td = INFINITY;
  int ti = NONE;
#pragma unroll
  for (int j = 0; j < NET_K; ++j) {
    qv[j] = j < k ? qd[j] : INFINITY;
    qx[j] = j < k ? qi[j] : NONE;
    if (j == k - 1) {
      td = qv[j];
      ti = qx[j];
    }
  }
  for (int c = 0; c < nc; ++c) {
    const float v = cd[c * stride];
    const int id = ci[c * stride];
    if (!pair_less(v, id, td, ti)) continue;
    bool lt[NET_K];
#pragma unroll
    for (int j = 0; j < NET_K; ++j) lt[j] = pair_less(v, id, qv[j], qx[j]);
#pragma unroll
    for (int j = NET_K - 1; j >= 0; --j) {
      if (j > 0 && lt[j - 1]) {
        qv[j] = qv[j - 1];
        qx[j] = qx[j - 1];
      } else if (lt[j]) {
        qv[j] = v;
        qx[j] = id;
      }
      if (j == k - 1) {
        td = qv[j];
        ti = qx[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NET_K; ++j)
    if (j < k) {
      qd[j] = qv[j];
      qi[j] = qx[j];
    }
}

// The first-tile bound of every row (k <= NET_K <= NE): thr[r] = the k-th
// smallest of the NE per-thread minima tm[r][0, NE) (ties by position).
// Called by the whole CTA once tm is written; ends synchronised.
template <int BQ, int NE>
__device__ __forceinline__ void first_tile_bounds(const float* tm, float* thr,
                                                  int k) {
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * NE; i += NT) {
    const float* row = tm + (i / NE) * NE;
    const int e = i % NE;
    const float v = row[e];
    int rank = 0;
    for (int f = 0; f < NE; ++f)
      rank += row[f] < v || (row[f] == v && f < e);
    if (rank == k - 1) thr[i / NE] = v;
  }
  __syncthreads();
}

// Insert every row's buffered candidates (min(cnt[r], C) of them, slot-
// major) into its queue of length k <= NET_K, one thread per row, and
// clear the counts and the row mask. Called by the whole CTA after a
// filter round and a barrier; the caller synchronises after it.
template <int BQ, int C>
__device__ __forceinline__ void drain_network(const Queues& s, int nq,
                                              int k) {
  static_assert(BQ <= NT, "one thread per row");
  const int r = threadIdx.x;
  if (r < nq && s.cnt[r] > 0) {
    insert_regs(s.kd + r * k, s.ki + r * k, k, s.cd + r, s.ci + r, BQ,
                min(s.cnt[r], C));
    s.cnt[r] = 0;
  }
  if (threadIdx.x < (BQ + 31) / 32) s.qmask[threadIdx.x] = 0;
}

// The same for k > NET_K (row-major candidates): warp w merges the
// candidates of its rows r % NW == w that have any (the bits of qmask)
// into their queues, then clears its bits.
template <int BQ, int C>
__device__ __forceinline__ void drain_merge(const Queues& s, int k) {
  static_assert(NW == 8, "8 warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mine = 0x01010101u << warp;
  for (int w0 = 0; w0 < (BQ + 31) / 32; ++w0) {
    unsigned bits = __shfl_sync(0xffffffffu, s.qmask[w0], 0) & mine;
    while (bits) {
      const int r = 32 * w0 + __ffs(bits) - 1;
      bits &= bits - 1;
      const int nc_r = min(s.cnt[r], C);
      if (nc_r <= 32)
        merge_row<1>(s.kd + r * k, s.ki + r * k, k, s.cd + r * C,
                     s.ci + r * C, nc_r);
      else
        merge_row<C / 32>(s.kd + r * k, s.ki + r * k, k, s.cd + r * C,
                          s.ci + r * C, nc_r);
      if (lane == 0) s.cnt[r] = 0;
    }
    if (lane == 0) atomicAnd(&s.qmask[w0], ~mine);
  }
}

// drain_network for k <= NET_K, else drain_merge.
template <int BQ, int C>
__device__ __forceinline__ void drain(const Queues& s, int nq, int k) {
  if (k <= NET_K)
    drain_network<BQ, C>(s, nq, k);
  else
    drain_merge<BQ, C>(s, k);
}

}  // namespace cell_select
