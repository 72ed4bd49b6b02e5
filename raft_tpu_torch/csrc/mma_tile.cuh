// The bf16 tensor-core tile and its selection, shared by the packed scans
// that multiply on mma.sync: B3 (batch_knn.cu) and B4 (pq_scan.cu).
//
// Both give one CTA of 256 threads BQ query rows (64, 32 or 16) held as a
// bf16 operand A (BQ x kp, row stride kp + 8) and sweep 128-slot tiles of
// bf16 rows Bt (slot-major, row stride kp + 8), double-buffered. Per tile:
//
//   * mma_range: the BQ x 128 gram block by mma.sync m16n8k16 (bf16
//     operands, f32 accumulators; operands by ldmatrix), 8 warps tiling
//     it as Geo<BQ> says. bf16 products are exact in f32; within a k16
//     step the tensor core sums in its own order, so results equal an FMA
//     order bit for bit only where the partial sums are exact;
//   * select_tile: the accumulators become min-order distances in place
//     (NaN for invalid slots and padding rows, which no test accepts);
//     k = 1 folds them into a register (min, slot) per row; k > 1 sends
//     only the pairs that beat their row's k-th (distance, slot) into the
//     per-row candidate buffers of cell_select.cuh, bounded on an item's
//     first tile by the k-th smallest per-thread minimum (k <= NET_K), and
//     drains them into the sorted queues (the insertion network for
//     k <= NET_K, warp merges above). With LAZY the network drains only
//     when the caller says so or a buffer fills (B2's schedule);
//   * write_rows: the rows' results, ids of empty or inf slots as -1.
//
// What fills A and Bt differs: B4 decodes PQ codes through a codeword
// table, B3 copies bf16 rows. So does each tile's slot metadata (B4's
// valid flags and code norms, B3's row norms with NaN marking invalid
// slots); each scan keeps its own tile_meta.

#pragma once

#include "cell_select.cuh"
#include "mma_bf16.cuh"

namespace mma_tile {

using cell_select::NET_K;
using cell_select::SEL_ANY;
using cell_select::SEL_MERGE;
using cell_select::SEL_MIN;
using cell_select::SEL_NET;
using knn::KMAX;
using knn::nan_f;
using knn::NONE;
using knn::pair_less;
using knn::take;

constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int BN = 128;      // slots per tile
constexpr int CAND = 4096;   // candidate slots per CTA (CAND / BQ a row)

// Round to the nearest bf16 (ties to even): its bits.
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// cp.async of BYTES (16, 8 or 4) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = mma_bf16::smem_addr(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Warp geometry of a BQ x 128 block: WARPS_M x WARPS_N warps, each WM x WN
// (MT m16 tiles by NT8 n8 tiles).
template <int BQ>
struct Geo {
  static constexpr int WARPS_M = BQ >= 32 ? BQ / 32 : 1;
  static constexpr int WARPS_N = NW / WARPS_M;
  static constexpr int WM = BQ / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT8 = WN / 8;
  static_assert(WM % 16 == 0 && NT8 % 2 == 0, "warp tile");
};

// acc += A[rows of this warp][k0 + [0, kw)] * Bt[cols of this warp][0, kw).
template <int BQ>
__device__ __forceinline__ void mma_range(
    float (&acc)[Geo<BQ>::MT][Geo<BQ>::NT8][4], const unsigned short* As,
    int SA, const unsigned short* Bt, int SB, int k0, int kw, int wm0,
    int wn0) {
  using G = Geo<BQ>;
  const int lane = threadIdx.x & 31;
  const unsigned short* a_row = As + (wm0 + (lane & 15)) * SA + k0 + (lane >> 4) * 8;
  const unsigned short* b_row =
      Bt + (wn0 + (lane >> 4) * 8 + (lane & 7)) * SB + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < kw; kk += 16) {
    uint32_t af[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
      mma_bf16::ldmatrix_x4(af[mt], a_row + mt * 16 * SA + kk);
#pragma unroll
    for (int p = 0; p < G::NT8 / 2; ++p) {
      uint32_t bf[4];
      mma_bf16::ldmatrix_x4(bf, b_row + p * 16 * SB + kk);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        mma_bf16::mma_16816(acc[mt][2 * p], af[mt], bf[0], bf[1]);
        mma_bf16::mma_16816(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// The epilogue and selection of tile t (slots t * 128 + [0, 128)) for the
// nq rows of this CTA: acc becomes min-order distances in place (NaN for
// invalid slots and padding rows), then k = 1 folds them into the running
// (bd, bi) of each row, k > 1 filters them against the queues q. qn: the
// rows' f32 norms (read for L2); yn / ok: the tile's slot norms and valid
// flags; CN candidate slots in all (CN / BQ a row). Without LAZY every
// tile's candidates enter the queues before it returns. With LAZY and k <=
// NET_K they wait in the buffers unless `drain_now` or a buffer fills;
// *pending says on return whether some wait (the caller drains them after
// its last tile).
template <int BQ, int SEL, int CN = CAND, bool LAZY = false>
__device__ __forceinline__ void select_tile(
    float (&acc)[Geo<BQ>::MT][Geo<BQ>::NT8][4], float (&bd)[2 * Geo<BQ>::MT],
    int (&bi)[2 * Geo<BQ>::MT], const float* qn_s,
    const cell_select::Queues& q, const float* yn, const int* ok, int t,
    int nq, int k, bool l2, int wm0, int wn0, bool first,
    bool drain_now = true, bool* pending = nullptr) {
  using G = Geo<BQ>;
  constexpr int C = CN / BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = t * BN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm0 + mt * 16 + g + h * 8;
      const bool rok = row < nq;
      const float qn = l2 ? qn_s[row] : 0.f;
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn0 + nt * 8 + 2 * tq + e;
          const float gv = acc[mt][nt][2 * h + e];
          const float v = l2 ? fmaxf(qn + yn[col] - 2.0f * gv, 0.f) : -gv;
          acc[mt][nt][2 * h + e] = (rok && ok[col]) ? v : nan_f();
        }
    }
  if (SEL == SEL_MIN) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int id = t0 + wn0 + nt * 8 + 2 * tq + e;
            const float v = acc[mt][nt][2 * h + e];
            if (pair_less(v, id, bd[2 * mt + h], bi[2 * mt + h])) {
              bd[2 * mt + h] = v;
              bi[2 * mt + h] = id;
            }
          }
    return;
  }
  // Row r's candidate j is at cd[r * rs + j * js]: slot-major (all rows'
  // j-th side by side) when each thread inserts its row (k <= NET_K),
  // row-major when a warp merges a row.
  const bool small_k = SEL == SEL_NET || (SEL == SEL_ANY && k <= NET_K);
  const int rs = small_k ? 1 : C, js = small_k ? BQ : 1;
  // On an item's first tile the queues are empty, so every pair would
  // pass. For k <= NET_K the k-th smallest of the per-thread minima of
  // a row (WARPS_N x 4 threads hold its 128 values, each min a distinct
  // pair) bounds the row's k-th smallest from above: pairs above it
  // cannot enter the queue.
  const bool bound = first && small_k;
  if (bound) {
    constexpr int NE = G::WARPS_N * 4;  // minima per row
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mn = INFINITY;  // fminf skips the NaN marks
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) mn = fminf(mn, acc[mt][nt][2 * h + e]);
        q.tm[(wm0 + mt * 16 + g + h * 8) * NE + (warp % G::WARPS_N) * 4 + tq] =
            mn;
      }
    cell_select::first_tile_bounds<BQ, NE>(q.tm, q.thr, k);
  }
  // Candidates left from tiles that did not drain (LAZY).
  bool carry = LAZY && *pending;
  const bool hold = LAZY && small_k && !drain_now;
  while (true) {
    bool over = false, any = false;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + mt * 16 + g + h * 8;
        if (row >= nq) continue;
        const float td = q.kd[row * k + k - 1];
        const int ti = q.ki[row * k + k - 1];
        const float tb = bound ? fminf(td, q.thr[row]) : td;
        // The float test first: almost every pair fails it. One atomic
        // per (thread, row) reserves the buffer slots of its passes.
        unsigned pass = 0;
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[mt][nt][2 * h + e];
            const int id = t0 + wn0 + nt * 8 + 2 * tq + e;
            if (v <= tb && pair_less(v, id, td, ti)) pass |= 1u << (2 * nt + e);
          }
        if (!pass) continue;
        any = true;
        int slot = atomicAdd(&q.cnt[row], __popc(pass));
        if (slot == 0) atomicOr(&q.qmask[row >> 5], 1u << (row & 31));
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!(pass >> (2 * nt + e) & 1)) continue;
            if (slot < C) {
              q.cd[row * rs + slot * js] = acc[mt][nt][2 * h + e];
              q.ci[row * rs + slot * js] = t0 + wn0 + nt * 8 + 2 * tq + e;
              acc[mt][nt][2 * h + e] = nan_f();
            } else {
              over = true;
            }
            ++slot;
          }
      }
    if (hold) {
      if (!__syncthreads_or(over)) {
        *pending = true;
        return;
      }
    } else if (!__syncthreads_or(any || carry)) {
      break;
    }
    if (SEL == SEL_NET)
      cell_select::drain_network<BQ, C>(q, nq, k);
    else if (SEL == SEL_MERGE)
      cell_select::drain_merge<BQ, C>(q, k);
    else
      cell_select::drain<BQ, C>(q, nq, k);
    carry = false;
    if (!__syncthreads_or(over)) break;
  }
  if (LAZY) *pending = false;
}

// Write the results of the CTA's nq rows to od / oi (row stride k): for
// k = 1 the running (bd, bi) of each row, which sit in the 4 lanes of a
// quad and the WARPS_N warps of its warp row (shuffles, then red_d /
// red_i, WARPS_N * BQ words each), else the sorted queues kd / ki. Ids of
// empty or inf slots become -1. Called by the whole CTA.
template <int BQ, bool K1>
__device__ __forceinline__ void write_rows(float (&bd)[2 * Geo<BQ>::MT],
                                           int (&bi)[2 * Geo<BQ>::MT],
                                           float* red_d, int* red_i,
                                           const float* kd, const int* ki,
                                           int nq, int k, int wm0, float* od,
                                           int* oi) {
  using G = Geo<BQ>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (K1) {
    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2 * G::MT; ++i) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, bd[i], o);
        const int id = __shfl_xor_sync(0xffffffffu, bi[i], o);
        if (pair_less(v, id, bd[i], bi[i])) {
          bd[i] = v;
          bi[i] = id;
        }
      }
      if ((lane & 3) == 0) {
        const int row = wm0 + (i >> 1) * 16 + g + (i & 1) * 8;
        const int wn = warp % G::WARPS_N;
        red_d[wn * BQ + row] = bd[i];
        red_i[wn * BQ + row] = bi[i];
      }
    }
    __syncthreads();
    for (int r = tid; r < nq; r += NT) {
      float v = red_d[r];
      int id = red_i[r];
      for (int wn = 1; wn < G::WARPS_N; ++wn)
        if (pair_less(red_d[wn * BQ + r], red_i[wn * BQ + r], v, id)) {
          v = red_d[wn * BQ + r];
          id = red_i[wn * BQ + r];
        }
      od[r] = v;
      oi[r] = (id == NONE || isinf(v)) ? -1 : id;
    }
  } else {
    for (int e = tid; e < nq * k; e += NT) {
      const float v = kd[e];
      const int id = ki[e];
      od[e] = v;
      oi[e] = (id == NONE || isinf(v)) ? -1 : id;
    }
  }
}

}  // namespace mma_tile
