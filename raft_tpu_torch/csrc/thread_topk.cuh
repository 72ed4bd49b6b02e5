// Top-k selection kept in the registers of the threads that hold the
// distances, for a bf16 tensor-core scan whose k is at most QMAX. B4
// (pq_scan.cu) takes it for 1 < k <= 16.
//
// The tile: 8 warps each own 16 rows (one m16 tile) of the BQ x 128 block
// and WN = 128 / WARPS_N of its slots (RowGeo). The mma leaves a thread
// two rows (g and g + 8 of its warp's 16); one shuffle per value inside
// each quad gives lanes tq < 2 row g and lanes tq >= 2 row g + 8, so each
// thread holds 4 * NT8 slots of one row per tile, the row shared with
// lane ^ 1, and the slot sets of the threads are disjoint. Per row a
// thread keeps a sorted queue of Q (distance, slot) pairs over its slots.
// Per tile (select_regs):
//
//   * the accumulators become min-order distances in place as
//     mma_tile.cuh's select_tile computes them, +inf marking invalid
//     slots and rows past nq (no test accepts it);
//   * a thread meets its slots in ascending order, so a pair enters its
//     queue iff its distance is strictly below the queue's k-th: a tie
//     goes to the slot seen first, the lowest. Any thread's k-th bounds
//     the row's k-th from above, so a pair above the least k-th the row's
//     threads have published in shared memory (rb, read and written
//     without a barrier: any value there is a bound) cannot reach the
//     row's top-k either;
//   * the pairs that pass are inserted in slot order, one a round from
//     each thread's mask, so a warp runs as many rounds as its busiest
//     thread has passes (the item's first tile, whose queues are empty,
//     inserts every pair). Insertion is an unrolled network over the
//     queue in registers. No atomic, no barrier, and no shared memory but
//     the one bound a row.
//
// The queue holds k real entries at [Q - k, Q) behind Q - k entries of
// -inf that no pair displaces, so the k-th is always entry Q - 1 and k is
// read at run time; Q is k rounded up to the kernel's instance. At the end
// of an item (merge_rows) the entries move to [0, k), the two queues of a
// row in a warp merge by shuffles (a bitonic merge of the pair order), and
// the WARPS_N warps of a row through shared memory by rank. Every pair of
// a row's final top-k is in the top-k of the thread queue that saw it, so
// the result is exact: ids and distances as one queue over the row gives
// them, ties to the lowest slot, -1 for inf.

#pragma once

#include "mma_tile.cuh"

namespace thread_topk {

using knn::NONE;
using knn::pair_less;
using mma_tile::BN;
using mma_tile::NT;
using mma_tile::NW;

constexpr int QMAX = 16;  // the widest queue (k <= QMAX)

// Warp geometry of a BQ x BN block with 16-row warp tiles: WARPS_M x
// WARPS_N warps, each 16 x WN (NT8 n8 tiles).
template <int BQ>
struct RowGeo {
  static constexpr int WARPS_M = BQ / 16;
  static constexpr int WARPS_N = NW / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int NT8 = WN / 8;
  static_assert(BQ % 16 == 0 && WARPS_M * WARPS_N == NW && NT8 % 2 == 0,
                "warp tile");
};

// acc += A[rows wm0 + [0, 16)][k0 + [0, kw)] * Bt[slots wn0 + [0, WN)][0,
// kw), as mma_tile.cuh's mma_range does for its own geometry.
template <int BQ>
__device__ __forceinline__ void mma_rows(
    float (&acc)[RowGeo<BQ>::NT8][4], const unsigned short* As, int SA,
    const unsigned short* Bt, int SB, int k0, int kw, int wm0, int wn0) {
  using G = RowGeo<BQ>;
  const int lane = threadIdx.x & 31;
  const unsigned short* a_row =
      As + (wm0 + (lane & 15)) * SA + k0 + (lane >> 4) * 8;
  const unsigned short* b_row =
      Bt + (wn0 + (lane >> 4) * 8 + (lane & 7)) * SB + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < kw; kk += 16) {
    uint32_t af[4];
    mma_bf16::ldmatrix_x4(af, a_row + kk);
#pragma unroll
    for (int p = 0; p < G::NT8 / 2; ++p) {
      uint32_t bf[4];
      mma_bf16::ldmatrix_x4(bf, b_row + p * 16 * SB + kk);
      mma_bf16::mma_16816(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16::mma_16816(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// One thread's queue: Q ascending (distance, slot) pairs of its row.
template <int Q>
struct Queue {
  float d[Q];
  int i[Q];
};

// An empty queue for k entries: Q - k entries of -inf, then k of (inf,
// NONE).
template <int Q>
__device__ __forceinline__ void reset(Queue<Q>& q, int k) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    q.d[j] = j < Q - k ? -INFINITY : INFINITY;
    q.i[j] = NONE;
  }
}

// Insert (v, id) into the ascending queue qd / qi, dropping its last
// entry, where v is below that entry (strictly: the queue's slots are all
// lower than id); otherwise, and for NaN or +inf, nothing changes.
template <int Q>
__device__ __forceinline__ void insert(float (&qd)[Q], int (&qi)[Q], float v,
                                       int id) {
  bool lt[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) lt[j] = v < qd[j];
#pragma unroll
  for (int j = Q - 1; j >= 0; --j) {
    if (j > 0 && lt[j - 1]) {
      qd[j] = qd[j - 1];
      qi[j] = qi[j - 1];
    } else if (lt[j]) {
      qd[j] = v;
      qi[j] = id;
    }
  }
}

// w[j], j in [0, N) at run time, by a tree of selects (no local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&w)[N], int j) {
  float t[N];
#pragma unroll
  for (int u = 0; u < N; ++u) t[u] = w[u];
#pragma unroll
  for (int s = 1; s < N; s <<= 1) {
    const bool up = (j & s) != 0;
#pragma unroll
    for (int u = 0; u + s < N; u += 2 * s) t[u] = up ? t[u + s] : t[u];
  }
  return t[0];
}

// The epilogue and selection of tile t (slots t * BN + [0, BN)): acc
// becomes distances as select_tile computes them (qn: the rows' f32 norms,
// read for L2; yn: the tile's slot norms, +inf at invalid slots and 0 at
// valid ones for inner product), +inf where select_tile has NaN, which no
// test accepts either; the two rows of a quad pass to one row a lane, and
// the pairs that can still reach a row's top-k enter the lane's queue. rb:
// the rows' published bounds. first: the item's first tile (its queues
// are empty).
template <int BQ, int Q>
__device__ __forceinline__ void select_regs(
    float (&acc)[RowGeo<BQ>::NT8][4], Queue<Q>& q, const float* qn_s,
    const float* yn, volatile float* rb, int t, int nq, bool l2, int wm0,
    int wn0, bool first) {
  using G = RowGeo<BQ>;
  constexpr int NV = 4 * G::NT8;  // values of the lane's row
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // +inf marks rows past nq (qn) and invalid slots (yn).
    const int row = wm0 + g + h * 8;
    const float qn = row >= nq ? INFINITY : l2 ? qn_s[row] : 0.f;
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = yn[wn0 + nt * 8 + 2 * tq + e];
        const float gv = acc[nt][2 * h + e];
        acc[nt][2 * h + e] = l2 ? fmaxf(qn + y - 2.0f * gv, 0.f)
                                : (qn + y == 0.f ? -gv : INFINITY);
      }
  }
  // Lanes tq < 2 keep row g, lanes tq >= 2 row g + 8, each with the values
  // of its row from lane ^ 2: w[4 nt + m] is column nt * 8 + 2 (tq & 1) +
  // (m & 1) + 4 (m >> 1), ascending in m.
  const bool lo = tq < 2;
  float w[NV];
#pragma unroll
  for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float got = __shfl_xor_sync(
          0xffffffffu, lo ? acc[nt][2 + e] : acc[nt][e], 2);
      w[4 * nt + e] = lo ? acc[nt][e] : got;
      w[4 * nt + 2 + e] = lo ? got : acc[nt][2 + e];
    }
  const int s0 = t * BN + wn0 + 2 * (tq & 1);
  auto slot = [s0](int u) {
    return s0 + (u >> 2) * 8 + (u & 1) + (u & 2) * 2;
  };
  // rb[row]: the least k-th any lane of the row has published.
  const int row = wm0 + g + 8 * (tq >> 1);
  if (first) {
#pragma unroll
    for (int u = 0; u < NV; ++u) insert(q.d, q.i, w[u], slot(u));
  } else {
    const float own = q.d[Q - 1];
    const float bound = fminf(own, rb[row]);
    unsigned pass = 0;
#pragma unroll
    for (int u = 0; u < NV; ++u)
      if (w[u] < own && w[u] <= bound) pass |= 1u << u;
    while (__any_sync(0xffffffffu, pass != 0)) {
      const int u = __ffs(pass) - 1;
      const float v = pass ? pick(w, u) : INFINITY;
      pass &= pass - 1;
      insert(q.d, q.i, v, slot(u));
    }
  }
  const float kth = q.d[Q - 1];
  const float pub = fminf(kth, __shfl_xor_sync(0xffffffffu, kth, 1));
  if ((tq & 1) == 0 && pub < rb[row]) rb[row] = pub;
}

// Compare-exchange of entries a < b of a queue by the pair order.
template <int Q>
__device__ __forceinline__ void exchange(float (&qd)[Q], int (&qi)[Q], int a,
                                         int b) {
  if (pair_less(qd[b], qi[b], qd[a], qi[a])) {
    const float td = qd[a];
    const int ti = qi[a];
    qd[a] = qd[b];
    qi[a] = qi[b];
    qd[b] = td;
    qi[b] = ti;
  }
}

// Merge the ascending queue of this lane with that of lane ^ mask: both
// end with the Q smallest pairs of the two, ascending. The minima of one
// queue against the other reversed form a bitonic sequence (rising, then
// falling); behind P - Q entries of -inf, P the power of two at or above
// Q, it stays one, and the half-cleaners of width P sort it. Exchanges
// that touch those entries change nothing and are left out.
template <int Q>
__device__ __forceinline__ void merge_lanes(float (&qd)[Q], int (&qi)[Q],
                                            int mask) {
  constexpr int P = Q <= 4 ? 4 : Q <= 8 ? 8 : 16;
  constexpr int O = P - Q;
  static_assert(Q <= P && P <= 16, "queue length");
  float od[Q];
  int oi[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    od[j] = __shfl_xor_sync(0xffffffffu, qd[Q - 1 - j], mask);
    oi[j] = __shfl_xor_sync(0xffffffffu, qi[Q - 1 - j], mask);
  }
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (pair_less(od[j], oi[j], qd[j], qi[j])) {
      qd[j] = od[j];
      qi[j] = oi[j];
    }
#pragma unroll
  for (int s = P / 2; s > 0; s >>= 1)
#pragma unroll
    for (int j = O; j < P; ++j)
      if ((j & s) == 0) exchange(qd, qi, j - O, j + s - O);
}

// How many of the n ascending pairs (d[i], id[i]) come before (x, xi), or
// with `equal`, are not after it.
__device__ __forceinline__ int rank_of(const float* d, const int* id, int n,
                                       float x, int xi, bool equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = equal ? !pair_less(x, xi, d[mid], id[mid])
                              : pair_less(d[mid], id[mid], x, xi);
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The end of an item: merge each row's lane queues and write its top-k
// to od / oi (row stride k; ids of inf entries as -1). md / mi: BQ *
// WARPS_N * k words each of shared memory. Called by the whole CTA.
template <int BQ, int Q>
__device__ __forceinline__ void merge_rows(Queue<Q>& q, float* md, int* mi,
                                           int nq, int k, int wm0, int wn0,
                                           float* od, int* oi) {
  using G = RowGeo<BQ>;
  const int lane = threadIdx.x & 31;
  const int wn = wn0 / G::WN;
  // The k entries to [0, k), (inf, NONE) after them.
  const int shift = Q - k;
#pragma unroll
  for (int s = 1; s < Q; s <<= 1)
    if (shift & s) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        q.d[j] = j + s < Q ? q.d[j + s] : INFINITY;
        q.i[j] = j + s < Q ? q.i[j + s] : NONE;
      }
    }
  merge_lanes(q.d, q.i, 1);
  const int row = wm0 + (lane >> 2) + ((lane >> 1) & 1) * 8;
  if ((lane & 1) == 0 && row < nq) {
    const int at = (row * G::WARPS_N + wn) * k;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (j < k) {
        md[at + j] = q.d[j];
        mi[at + j] = q.i[j];
      }
  }
  __syncthreads();
  // Entry j of list p of row r (md[(r * WARPS_N + p) * k + j], two
  // threads a list) goes to its rank in the union, ties between lists to
  // the lower list.
  constexpr int LISTS = BQ * G::WARPS_N;
  static_assert(NT == 2 * LISTS, "two threads a list");
  const int list = threadIdx.x % LISTS;
  const int r = list / G::WARPS_N, p = list % G::WARPS_N;
  if (r < nq) {
    const float* rd = md + r * G::WARPS_N * k;
    const int* ri = mi + r * G::WARPS_N * k;
    for (int j = threadIdx.x / LISTS; j < k; j += 2) {
      const float v = rd[p * k + j];
      const int id = ri[p * k + j];
      int rank = j;
#pragma unroll
      for (int p2 = 0; p2 < G::WARPS_N; ++p2)
        if (p2 != p)
          rank += rank_of(rd + p2 * k, ri + p2 * k, k, v, id, p2 < p);
      if (rank < k) {
        od[r * k + rank] = v;
        oi[r * k + rank] = (id == NONE || isinf(v)) ? -1 : id;
      }
    }
  }
}

}  // namespace thread_topk
