// The packed-cells IVF-Flat scan (B2) for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/fused_knn.py::fused_cells_knn / _cells_knn_kernel:
// cell c scores its qrows queries against list cell_list[c] of a
// capacity-padded (L, cap, d) store (f32 or bf16), skipping the slots a
// per-slot `invalid` mask sets (padding and tombstones); a -1 cell writes
// (inf, -1). The function (ops/fused_knn.py::_fused_cells_knn_plain):
// a gram in f32, or on operands rounded to bf16 with f32 sums plus the
// split query's low half with qsplit; max(|q|^2 + |y|^2 - 2g, 0) for L2
// with f32 norms of the unrounded values, or -g for inner product; the
// exact top-k by (distance, slot), ties to the lowest slot, -1 for slots
// left at inf.
//
// What bounds it on the H100: 2 * d flops per (query, valid row) pair at
// the FP32 rate outside the tensor cores (TF32 would break parity with
// the reference's Precision.HIGHEST; bf16 products are exact in f32), 2.2
// ms at the main path (6024 cells x 64 rows, ~1470 valid rows a cell, d
// 128); its bytes (the valid rows once, the queries, the results) are a
// tenth of that. What the design does about it:
//
//   * one CTA of 256 threads per (cell, block of BQ query rows): BQ = 64,
//     the cell height, or 32 / 16 when the top-k queue needs the room or
//     the cells are short (ops/fused_knn.py::_b2_plan), so each list is
//     staged once per cell. It runs B1's register-tiled FP32 tile
//     (knn_gemm.cuh): a (BQ / 16) x 8 micro-tile per thread over 128-row
//     tiles, 16-feature chunks landed by cp.async (16 bytes for f32, 8 for
//     bf16 rows, narrower copies for unaligned operands) and moved into
//     double-buffered feature-major tiles inside the previous chunk's
//     FMAs; the queries are staged with every chunk. With 64 rows and
//     k <= 16 two CTAs share an SM, so one's setup and selection overlap
//     the other's FMAs;
//   * a pre-pass, part of every call, writes each 128-slot tile's live
//     flag and each slot's f32 norm (NaN for an invalid slot or one past
//     cap) into scratch the wrapper allocates per call; the index keeps
//     nothing, so extend / upsert / compact cannot leave it stale. The
//     scan walks only the live tiles (the store is padded to the largest
//     list; most lists fill a fraction of it), and a NaN norm marks a pair
//     that no test accepts;
//   * selection after B1 and B4: the accumulators become distances in
//     place, a register filter sends only the pairs that beat their row's
//     k-th into per-row candidate buffers, the cell's first live tile is
//     bounded by the k-th smallest per-thread minimum (k <= 16), and the
//     candidates enter the queues through cell_select.cuh (an insertion
//     network for k <= 16, a warp sort and merge above). k = 1 keeps a
//     register (min, slot) per row. Each of the three is its own
//     instance, so the merge's registers do not crowd the others. The
//     network drains only on the 1st, 2nd, 4th, 8th, ... live tile of a
//     cell (or when a buffer fills); in between a tile costs one barrier,
//     and the candidates wait against bounds that are already tight.
//
// Callers pass finite operands (the entry points reject non-finite
// inputs): an L2 NaN would come out of fmaxf as distance 0.

#include "cell_norms.cuh"
#include "cell_select.cuh"
#include "knn_gemm.cuh"

namespace {

using cell_select::NET_K;
using cell_select::SEL_MERGE;
using cell_select::SEL_MIN;
using cell_select::SEL_NET;
using knn::KMAX;
using knn::NONE;
using knn::pair_less;
using knn::take;
using namespace knn_gemm;

constexpr int NE = 16;  // threads (and per-thread minima) per query row

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b2_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t stg, At, Lt, Bt, qn, kd, ki, cd, ci, cnt, qmask, tm, thr;
  size_t total;
  __host__ __device__ Layout(int bq, int k, bool qsplit) {
    size_t at = 0;
    stg = take(at, sizeof(float) * STAGES * (size_t)(bq + BN) * SKP);
    At = take(at, sizeof(float) * 2 * BK * (size_t)(bq + 4));
    Lt = take(at, qsplit ? sizeof(float) * 2 * BK * (size_t)(bq + 4) : 0);
    Bt = take(at, sizeof(float) * 2 * BK * (size_t)(BN + 4));
    qn = take(at, sizeof(float) * (size_t)bq);
    kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k > 1) {
      kd = take(at, 4 * (size_t)bq * k);
      ki = take(at, 4 * (size_t)bq * k);
      cd = take(at, 4 * (size_t)CAND);
      ci = take(at, 4 * (size_t)CAND);
      cnt = take(at, 4 * (size_t)bq);
      qmask = take(at, 4 * (size_t)((bq + 31) / 32));
      if (k <= NET_K) {
        tm = take(at, 4 * (size_t)bq * NE);
        thr = take(at, 4 * (size_t)bq);
      }
    }
    total = at;
  }
};

struct Args {
  const int* cell_list;  // (n_cells,)
  const float* q;        // (n_cells, qrows, d)
  const void* db;        // (n_lists, cap, d) f32 or bf16
  const float* yn;       // (n_lists, capp): the pre-pass's norms / NaN
  const uint8_t* live;   // (n_lists, capp / 128): the pre-pass's flags
  const int* live_rows;  // (n_cells,): rows scanned per cell, or nullptr
  float* out_d;          // (n_cells, qrows, k)
  int* out_i;
  int n_cells, qrows, cap, capp, d, k, l2, db16, qvec, dvec;
};

// One CTA: query rows [q0, q0 + BQ) of cell blockIdx.x / ceil(qrows / BQ)
// against the live tiles of its list. With live_rows, rows of cell c at or
// past live_rows[c] are not scanned and report (inf, -1).
template <int BQ, bool BF16, bool QSPLIT, int SEL>
__global__ void __launch_bounds__(NT, 2) b2_scan_kernel(const Args a) {
  constexpr bool K1 = SEL == SEL_MIN, NET = SEL == SEL_NET;
  constexpr int TM = BQ / 16, C = CAND / BQ;
  constexpr int LDA = BQ + 4, LDB = BN + 4, SSZ = (BQ + BN) * SKP;
  extern __shared__ __align__(16) char smem[];
  const Layout lay(BQ, K1 ? 1 : a.k, QSPLIT);
  float* stg = reinterpret_cast<float*>(smem + lay.stg);
  float* At = reinterpret_cast<float*>(smem + lay.At);
  float* Lt = reinterpret_cast<float*>(smem + lay.Lt);
  float* Bt = reinterpret_cast<float*>(smem + lay.Bt);
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
  const cell_select::Queues sq{
      reinterpret_cast<float*>(smem + lay.kd),
      reinterpret_cast<int*>(smem + lay.ki),
      reinterpret_cast<float*>(smem + lay.cd),
      reinterpret_cast<int*>(smem + lay.ci),
      reinterpret_cast<int*>(smem + lay.cnt),
      reinterpret_cast<unsigned*>(smem + lay.qmask),
      reinterpret_cast<float*>(smem + lay.tm),
      reinterpret_cast<float*>(smem + lay.thr)};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = 8 * (warp & 1) + (lane & 7);
  const int ty = 4 * (warp >> 1) + (lane >> 3);
  const int k = a.k;
  const bool l2 = a.l2 != 0, db16 = a.db16 != 0;
  const int nqb = (a.qrows + BQ - 1) / BQ;
  const int cell = blockIdx.x / nqb, q0 = (blockIdx.x % nqb) * BQ;
  const int rows = min(BQ, a.qrows - q0);
  const int nq = a.live_rows == nullptr
                     ? rows
                     : max(0, min(rows, a.live_rows[cell] - q0));
  const size_t row0 = (size_t)cell * a.qrows + q0;
  float* od = a.out_d + row0 * k;
  int* oi = a.out_i + row0 * k;
  const int list = a.cell_list[cell];
  // The rows not scanned: sentinels.
  for (int e = (list < 0 ? 0 : nq * k) + tid; e < rows * k; e += NT) {
    od[e] = INFINITY;
    oi[e] = -1;
  }
  if (list < 0 || nq == 0) return;
  const float* q = a.q + row0 * a.d;
  const int ntiles = a.capp / BN;
  const uint8_t* live = a.live + (size_t)list * ntiles;
  const float* yn = a.yn + (size_t)list * a.capp;
  const size_t lofs = (size_t)list * a.cap * a.d;
  const float* dbf = static_cast<const float*>(a.db) + lofs;
  const __nv_bfloat16* dbh = static_cast<const __nv_bfloat16*>(a.db) + lofs;
  const int nchunk = (a.d + BK - 1) / BK;

  // The staging cursor: chunk s_c of live tile s_tile goes into staging
  // buffer s_j % STAGES; every call commits one group, empty or not.
  int s_tile = cell_select::next_live(live, -1, ntiles), s_c = 0, s_j = 0;
  const int t_first = s_tile;
  auto issue = [&]() {
    if (s_tile < ntiles) {
      float* buf = stg + (s_j % STAGES) * SSZ;
      if (db16)
        stage<BQ, __nv_bfloat16>(buf, q, dbh, 0, nq, s_tile * BN, a.cap,
                                 s_c * BK, a.d, a.qvec, a.dvec);
      else
        stage<BQ, float>(buf, q, dbf, 0, nq, s_tile * BN, a.cap, s_c * BK,
                         a.d, a.qvec, a.dvec);
      if (++s_c == nchunk) {
        s_c = 0;
        s_tile = cell_select::next_live(live, s_tile, ntiles);
      }
    }
    ++s_j;
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES; ++j) issue();

  // While the first chunks land: the f32 query norms of the unrounded
  // rows (a warp per row), the queues, the running minima.
  for (int r = warp; r < BQ; r += NW) {
    float acc = 0.f;
    if (r < nq)
      for (int c = lane; c < a.d; c += 32) {
        const float v = __ldg(q + (size_t)r * a.d + c);
        acc = fmaf(v, v, acc);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) qn[r] = acc;
  }
  if (!K1) {
    for (int j = tid; j < BQ * k; j += NT) {
      sq.kd[j] = INFINITY;
      sq.ki[j] = NONE;
    }
    for (int j = tid; j < BQ; j += NT) sq.cnt[j] = 0;
    for (int j = tid; j < (BQ + 31) / 32; j += NT) sq.qmask[j] = 0;
  }
  bool qok[TM];
  float bd[TM];
  int bi[TM];
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qok[i] = qrow<TM>(ty, i) < nq;
    bd[i] = INFINITY;
    bi[i] = NONE;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  cp_wait<STAGES - 1>();
  transpose<BQ, BF16, QSPLIT>(stg, At, Lt, Bt, db16);
  issue();
  __syncthreads();

  // Offer this thread's pairs of the tile at slots t0 + [0, BN) that beat
  // their row's k-th (and, for the network, the first-tile bound) to the
  // rows' candidate buffers: slot-major for the network, row-major for
  // the merge. Sent pairs become NaN; returns whether a buffer was full.
  auto offer = [&](int t0, bool& any) {
    constexpr int rs = NET ? 1 : C, js = NET ? BQ : 1;
    bool over = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (!qok[i]) continue;
      const int r = qrow<TM>(ty, i);
      const float td = sq.kd[r * k + k - 1];
      const int ti = sq.ki[r * k + k - 1];
      const float tb = NET ? fminf(td, sq.thr[r]) : td;
      // The float test first: almost every pair fails it. One atomic
      // per (thread, row) reserves the buffer slots of its passes.
      unsigned pass = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[i][j];
        if (v <= tb && pair_less(v, t0 + dcol(tx, j), td, ti))
          pass |= 1u << j;
      }
      if (!pass) continue;
      any = true;
      int slot = atomicAdd(&sq.cnt[r], __popc(pass));
      if (!NET && slot == 0) atomicOr(&sq.qmask[r >> 5], 1u << (r & 31));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!(pass >> j & 1)) continue;
        if (slot < C) {
          sq.cd[r * rs + slot * js] = acc[i][j];
          sq.ci[r * rs + slot * js] = t0 + dcol(tx, j);
          acc[i][j] = nan_f();
        } else {
          over = true;
        }
        ++slot;
      }
    }
    return over;
  };

  // The compute cursor: chunk c_c of live tile c_tile, the it-th chunk;
  // n_done live tiles selected, `pending` candidates not yet drained.
  int c_tile = t_first, c_c = 0, it = 0, n_done = 0;
  bool pending = false;
  while (c_tile < ntiles) {
    const int buf = it & 1, nb = buf ^ 1;
    // The norms of this thread's 8 slots of the tile, loaded a chunk
    // before the epilogue needs them.
    float yt[8];
    if (c_c == nchunk - 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        yt[j] = __ldg(yn + c_tile * BN + dcol(tx, j));
    }
    // Chunk it + 1 has landed (this thread's copies of it).
    cp_wait<STAGES - 1>();
    compute_chunk<BQ, BF16, QSPLIT>(
        acc, At + buf * BK * LDA, Lt + buf * BK * LDA, Bt + buf * BK * LDB,
        tx, ty, stg + ((it + 1) % STAGES) * SSZ, At + nb * BK * LDA,
        Lt + nb * BK * LDA, Bt + nb * BK * LDB, db16);
    // This thread has read its pieces of chunk it + 1: refill the buffer.
    issue();
    ++it;
    if (++c_c < nchunk) {
      __syncthreads();
      continue;
    }
    // Epilogue of the tile at slots t0 + [0, BN): the accumulators become
    // min-order distances in place; NaN marks a pair of an invalid slot
    // (its pre-pass norm is NaN) or of a row past nq.
    const int t0 = c_tile * BN;
    float qnr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) qnr[i] = l2 ? qn[qrow<TM>(ty, i)] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = yt[j];
      const bool ok = !isnan(y);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float g = acc[i][j];
        const float v = l2 ? fmaxf((qnr[i] + y) - 2.0f * g, 0.f) : -g;
        acc[i][j] = (ok && qok[i]) ? v : nan_f();
      }
    }
    bool synced = false;  // the selection ended on a barrier
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
      if (NET && n_done == 0) {
        // Thread tx holds 8 of row r's 128 pairs: its minimum is one of
        // the NE = 16 minima of the row.
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float mn = INFINITY;  // fminf skips the NaN marks
#pragma unroll
          for (int j = 0; j < 8; ++j) mn = fminf(mn, acc[i][j]);
          sq.tm[qrow<TM>(ty, i) * NE + tx] = mn;
        }
        cell_select::first_tile_bounds<BQ, NE>(sq.tm, sq.thr, k);
      }
      // The network drains on the 1st, 2nd, 4th, 8th, ... live tile (and
      // whenever a buffer overflows): in between, candidates pile up
      // against the last drained k-th and the first-tile bound, both
      // upper bounds of the row's k-th. The merge drains every tile.
      ++n_done;
      const bool drain_now = !NET || (n_done & (n_done - 1)) == 0;
      while (true) {
        bool any_sent = false;
        const bool over = offer(t0, any_sent);
        if (NET) {
          const bool ov = __syncthreads_or(over);
          if (!ov && !drain_now) {
            synced = true;
            break;
          }
          cell_select::drain_network<BQ, C>(sq, nq, k);
          pending = false;
          if (!ov) break;
          __syncthreads();  // the drained queues, then offer the rest
        } else {
          if (!__syncthreads_or(any_sent)) break;
          cell_select::drain_merge<BQ, C>(sq, k);
          if (!__syncthreads_or(over)) break;
        }
      }
      if (NET && !drain_now) pending = true;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    c_c = 0;
    c_tile = cell_select::next_live(live, c_tile, ntiles);
    if (!synced) __syncthreads();
  }

  cp_wait<0>();
  __syncthreads();
  if (NET && pending) {
    // The candidates offered since the last drain.
    cell_select::drain_network<BQ, C>(sq, nq, k);
    __syncthreads();
  }
  if (K1)
    write_k1<BQ>(bd, bi, stg, nq, od, oi, true);
  else
    write_queue(sq.kd, sq.ki, nq, k, od, oi, true);
}

template <int BQ, bool BF16, bool QSPLIT, int SEL>
cudaError_t run_scan(const Args& a, size_t bytes, cudaStream_t st) {
  auto kern = b2_scan_kernel<BQ, BF16, QSPLIT, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  const long long grid =
      (long long)a.n_cells * ((a.qrows + BQ - 1) / BQ);
  kern<<<(unsigned)grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ, bool BF16, bool QSPLIT>
cudaError_t scan_sel(const Args& a, size_t bytes, cudaStream_t st) {
  if (a.k == 1) return run_scan<BQ, BF16, QSPLIT, SEL_MIN>(a, bytes, st);
  if (a.k <= NET_K) return run_scan<BQ, BF16, QSPLIT, SEL_NET>(a, bytes, st);
  return run_scan<BQ, BF16, QSPLIT, SEL_MERGE>(a, bytes, st);
}

template <bool BF16, bool QSPLIT>
cudaError_t scan_tier(const Args& a, int bq, size_t bytes, cudaStream_t st) {
  if (bq == 64) return scan_sel<64, BF16, QSPLIT>(a, bytes, st);
  if (bq == 32) return scan_sel<32, BF16, QSPLIT>(a, bytes, st);
  return scan_sel<16, BF16, QSPLIT>(a, bytes, st);
}

}  // namespace

extern "C" {

// One B2 call: the pre-pass into yn (n_lists, capp) and live (n_lists,
// capp / 128), capp = cap rounded up to 128, then the scan on the plan of
// ops/fused_knn.py::_b2_plan (bq query rows per CTA, smem bytes, which
// must equal this file's Layout). db is f32, or bf16 with db_is_bf16.
// live_rows (n_cells,), or nullptr for every row: rows of cell c at or past
// live_rows[c] are not scanned and report (inf, -1) (B3's bucket callers
// fill each bucket from slot 0 upward).
// Operands need only their element alignment: the 16-byte copies (8-byte
// for bf16 rows) run when d % 4 == 0 and the operand starts on 16 (8)
// bytes. Returns the first launch error.
int fused_cells_knn_launch(const int* cell_list, const float* q,
                           const void* db, int db_is_bf16,
                           const uint8_t* invalid, const int* live_rows,
                           float* yn, uint8_t* live, float* out_d, int* out_i,
                           int n_cells, int n_lists, int qrows, int cap, int d,
                           int k, int l2, int bf16, int qsplit, int bq,
                           int smem, void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  qsplit = qsplit && bf16;
  const int capp = (cap + BN - 1) / BN * BN;
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || n_lists < 1 ||
      n_lists > 65535 || !(bq == 16 || bq == 32 || bq == 64) ||
      (long long)n_cells * ((qrows + bq - 1) / bq) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout lay(bq, k, qsplit != 0);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cell_norms::launch(db, db_is_bf16, invalid, yn, live,
                                      n_lists, cap, capp, d, l2, st);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t da = reinterpret_cast<uintptr_t>(db);
  const Args a{cell_list, q, db, yn, live, live_rows, out_d, out_i, n_cells,
               qrows, cap, capp, d, k, l2, db_is_bf16,
               d % 4 == 0 && (qa & 15) == 0,
               d % 4 == 0 && (da & (db_is_bf16 ? 7 : 15)) == 0};
  if (!bf16)
    err = scan_tier<false, false>(a, bq, lay.total, st);
  else if (!qsplit)
    err = scan_tier<true, false>(a, bq, lay.total, st);
  else
    err = scan_tier<true, true>(a, bq, lay.total, st);
  return (int)err;
}

}  // extern "C"
