// The batched independent kNN (B3) for Hopper (sm_90a): its bf16 tier on
// a bf16 store, on tensor cores.
//
// Replaces raft_tpu/ops/fused_knn.py::_fused_batch_knn / _batch_knn_kernel:
// element b scores its m query rows queries[b] against its own (n, d)
// slab db[b], skipping the slots invalid[b] sets. This file computes the
// tier every main-path call runs (the IVF-PQ recon tier and decode scan,
// the IVF-Flat bucket engine on bf16 storage): bf16 rows, queries rounded
// to bf16, f32 sums, no split query. The function (ops/fused_knn.py::
// _fused_batch_knn_plain): g = sum bf16(q) * y with f32 sums; max(|q|^2 +
// |y|^2 - 2g, 0) for L2 with f32 norms of the unrounded values, or -g for
// inner product; the exact top-k by (distance, slot), ties to the lowest
// slot, -1 for slots left at inf. Every other tier (f32, f32 stores, the
// split query) and any shape whose tile does not fit shared memory runs
// B2's scan (cells_knn.cu) with the identity cell map; the plan that
// picks the path is ops/fused_knn.py::_b3_plan.
//
// Rows [live_rows[b], m) of element b are not scanned and report (inf,
// -1): the callers fill each bucket of m query slots from slot 0 upward
// and never read the rest (at the main path 29 of 256 slots are live on
// average, 10 at the median).
//
// What bounds it on the H100: the bytes of the valid rows (2 * d each) and
// of the live query rows; the products, 2 * d operations per (live query
// row, valid slot) pair at the bf16 tensor-core rate, take less. What
// holds a design back is the latency of each short item (about 8 live
// tiles a slab, 10 live rows at the median) and selection. What this one
// does:
//
//   * one CTA of 256 threads per (element, block of BQ query rows); BQ =
//     64, or 32 / 16 when m is small or the queue needs the room
//     (_b3_plan). A block at or past live_rows[b] writes its sentinels and
//     returns, so each slab is staged once per live block. Two CTAs share
//     an SM (128 registers, half of B4's candidate buffer) except on the
//     merge path (k > 16);
//   * with more slabs than SMs, a one-block counting sort orders the slabs
//     by work (live tiles x live row blocks) and the grid takes them
//     largest first: list sizes and probe counts are skewed (at the main
//     path 1 to ~3100 valid rows, 0 to 256 live rows), and a long item
//     that starts late sets the tail of the last wave;
//   * the pre-pass of B2 (cell_norms.cuh), part of every call: each
//     128-slot tile's live flag and each slot's f32 norm from the
//     unrounded row, NaN marking an invalid slot. The scan walks only the
//     live tiles (the store is padded to the largest list);
//   * staging: a live tile's 128 bf16 rows land by cp.async straight in
//     the slot-major operand tile (row stride d rounded up to 16, plus 8:
//     conflict-free ldmatrix), 16 bytes a copy (8, 4 or 2 when d or the
//     store's alignment does not allow it), double-buffered one live tile
//     ahead. Features past d are zero, written once;
//   * the f32 query block is rounded to bf16 once per item into the A
//     operand while the first tile lands (each warp's rows' loads in
//     flight together); its norms come from the unrounded rows;
//   * the product and selection are mma_tile.cuh's, which B4 shares:
//     mma.sync m16n8k16 bf16 with f32 accumulators, the register filter,
//     the first-tile bound and the insertion network for k <= 16 (drained
//     on the 1st, 2nd, 4th, 8th, ... live tile, as B2 does), warp merges
//     above, a register (min, slot) per row for k = 1.
//
// k <= 256 (the queue); callers pass finite operands (the entry points
// reject non-finite inputs): an L2 NaN would come out of fmaxf as 0.

#include "cell_norms.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

// Candidate slots per CTA (B3_CAND / BQ a row): half of B4's, so that a
// 64-row CTA of the network path fits twice in an SM's shared memory.
constexpr int B3_CAND = 2048;

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b3_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t A, Bt, qn, yn, ok, red, kd, ki, cd, ci, cnt, qmask, tm, thr;
  size_t total;
  __host__ __device__ Layout(int bq, int warps_n, int kp, int k) {
    size_t at = 0;
    A = take(at, (size_t)bq * (kp + 8) * 2);
    Bt = take(at, (size_t)2 * BN * (kp + 8) * 2);
    qn = take(at, (size_t)bq * 4);
    yn = take(at, 2 * BN * 4);
    ok = take(at, 2 * BN * 4);
    red = kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k == 1) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else {
      kd = take(at, (size_t)bq * k * 4);
      ki = take(at, (size_t)bq * k * 4);
      cd = take(at, (size_t)B3_CAND * 4);
      ci = take(at, (size_t)B3_CAND * 4);
      cnt = take(at, (size_t)bq * 4);
      qmask = take(at, 4 * (size_t)((bq + 31) / 32));
      if (k <= NET_K) {
        tm = take(at, (size_t)bq * warps_n * 4 * 4);
        thr = take(at, (size_t)bq * 4);
      }
    }
    total = at;
  }
};

struct Args {
  const float* q;            // (batch, m, d)
  const __nv_bfloat16* db;   // (batch, n, d)
  const float* yn;           // (batch, capp): the pre-pass's norms / NaN
  const uint8_t* live;       // (batch, capp / 128): the pre-pass's flags
  const int* live_rows;      // (batch,), or nullptr for every row
  const int* order;          // (batch,): slabs, largest first; or nullptr
  float* out_d;              // (batch, m, k)
  int* out_i;
  int m, n, capp, d, kp, k, l2, vec;  // vec: bytes a copy (16, 8, 4, 2)
};

// The rows of tile t (slots t * 128 + [0, 128) below n) of a slab into Bt
// (row stride SB), features [0, d), VEC bytes a piece.
template <int VEC>
__device__ __forceinline__ void copy_rows(unsigned short* Bt,
                                          const __nv_bfloat16* __restrict__ db,
                                          int t, int n, int d, int SB) {
  const int r0 = t * BN, nr = min(BN, n - r0);
  const __nv_bfloat16* src = db + (size_t)r0 * d;
  if constexpr (VEC == 2) {
    for (int u = threadIdx.x; u < nr * d; u += NT) {
      const int r = u / d, c = u - r * d;
      Bt[r * SB + c] = __bfloat16_as_ushort(src[(size_t)r * d + c]);
    }
  } else {
    constexpr int E = VEC / 2;  // features a piece
    const int per = d / E;
    for (int u = threadIdx.x; u < nr * per; u += NT) {
      const int r = u / per, p = u - r * per;
      cp_async<VEC>(Bt + r * SB + p * E, src + (size_t)r * d + p * E);
    }
  }
}

__device__ __forceinline__ void load_tile(unsigned short* Bt,
                                          const __nv_bfloat16* db, int t,
                                          int n, int d, int SB, int vec) {
  if (vec == 16)
    copy_rows<16>(Bt, db, t, n, d, SB);
  else if (vec == 8)
    copy_rows<8>(Bt, db, t, n, d, SB);
  else if (vec == 4)
    copy_rows<4>(Bt, db, t, n, d, SB);
  else
    copy_rows<2>(Bt, db, t, n, d, SB);
}

// Norms and valid flags of tile t's slots into yn / ok: the pre-pass's
// NaN marks an invalid slot (or one past n).
__device__ __forceinline__ void tile_meta(const float* __restrict__ yn_g,
                                          int t, float* yn, int* ok) {
  if (threadIdx.x < BN) {
    const float y = yn_g[t * BN + threadIdx.x];
    const bool v = !isnan(y);
    ok[threadIdx.x] = v;
    yn[threadIdx.x] = v ? y : 0.f;
  }
}

// One CTA: query rows [q0, q0 + BQ) of slab order[blockIdx.x / ceil(m /
// BQ)] against the live tiles of its slab. One instance per selection path, so
// the merge's registers do not crowd the others: two CTAs share an SM
// (128 registers a thread) except on the merge path.
template <int BQ, int SEL>
__global__ void __launch_bounds__(NT, SEL == SEL_MERGE ? 1 : 2)
    b3_scan_kernel(const Args a) {
  using G = Geo<BQ>;
  constexpr bool K1 = SEL == SEL_MIN;
  extern __shared__ __align__(16) char smem[];
  const Layout lay(BQ, G::WARPS_N, a.kp, K1 ? 1 : a.k);
  unsigned short* A = reinterpret_cast<unsigned short*>(smem + lay.A);
  unsigned short* Bt = reinterpret_cast<unsigned short*>(smem + lay.Bt);
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
  float* yn = reinterpret_cast<float*>(smem + lay.yn);
  int* ok = reinterpret_cast<int*>(smem + lay.ok);
  float* red_d = reinterpret_cast<float*>(smem + lay.red);
  int* red_i = reinterpret_cast<int*>(smem + lay.red) + G::WARPS_N * BQ;
  const cell_select::Queues q{
      reinterpret_cast<float*>(smem + lay.kd),
      reinterpret_cast<int*>(smem + lay.ki),
      reinterpret_cast<float*>(smem + lay.cd),
      reinterpret_cast<int*>(smem + lay.ci),
      reinterpret_cast<int*>(smem + lay.cnt),
      reinterpret_cast<unsigned*>(smem + lay.qmask),
      reinterpret_cast<float*>(smem + lay.tm),
      reinterpret_cast<float*>(smem + lay.thr)};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / G::WARPS_N) * G::WM;
  const int wn0 = (warp % G::WARPS_N) * G::WN;
  const int SA = a.kp + 8, SB = a.kp + 8, tile_elems = BN * SB;
  const int k = a.k;
  const bool l2 = a.l2 != 0;
  const int nqb = (a.m + BQ - 1) / BQ;
  const int item = blockIdx.x / nqb, q0 = (blockIdx.x % nqb) * BQ;
  const int b = a.order == nullptr ? item : a.order[item];
  const int rows = min(BQ, a.m - q0);
  const int nq = a.live_rows == nullptr
                     ? rows
                     : max(0, min(rows, a.live_rows[b] - q0));
  const size_t row0 = (size_t)b * a.m + q0;
  float* od = a.out_d + row0 * k;
  int* oi = a.out_i + row0 * k;
  // The rows not scanned: sentinels.
  for (int e = nq * k + tid; e < rows * k; e += NT) {
    od[e] = INFINITY;
    oi[e] = -1;
  }
  if (nq == 0) return;

  const int ntiles = a.capp / BN;
  const uint8_t* live = a.live + (size_t)b * ntiles;
  const float* yn_g = a.yn + (size_t)b * a.capp;
  const __nv_bfloat16* db = a.db + (size_t)b * a.n * a.d;

  // The first live tile lands while the queries are staged.
  int t = cell_select::next_live(live, -1, ntiles);
  if (t < ntiles) load_tile(Bt, db, t, a.n, a.d, SB, a.vec);
  cp_commit();

  // Features [d, kp) of both row buffers: zero, never copied over.
  const int pad = a.kp - a.d;
  for (int e = tid; e < 2 * BN * pad; e += NT)
    Bt[(e / pad) * SB + a.d + e % pad] = 0;
  // The bf16 query operand (zero past nq and d) and the f32 norms of the
  // unrounded rows: warp w takes rows w, w + 8, ..., whose loads are in
  // flight together.
  const float* qb = a.q + row0 * a.d;
  {
    constexpr int RPW = BQ / NW;
    float acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
    for (int c = lane; c < a.kp; c += 32) {
      float v[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * NW;
        v[i] = (r < nq && c < a.d) ? __ldg(qb + (size_t)r * a.d + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        acc[i] = fmaf(v[i], v[i], acc[i]);
        A[(warp + i * NW) * SA + c] = bf16_bits(v[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (lane == 0) qn[warp + i * NW] = acc[i];
    }
  }
  if (!K1) {
    for (int j = tid; j < BQ * k; j += NT) {
      q.kd[j] = INFINITY;
      q.ki[j] = NONE;
    }
    for (int j = tid; j < BQ; j += NT) q.cnt[j] = 0;
    for (int j = tid; j < (BQ + 31) / 32; j += NT) q.qmask[j] = 0;
  }
  float bd[2 * G::MT];
  int bi[2 * G::MT];
#pragma unroll
  for (int i = 0; i < 2 * G::MT; ++i) {
    bd[i] = INFINITY;
    bi[i] = NONE;
  }

  // Tile t sits in Bt[cur]; tn, the next live one, lands in Bt[cur ^ 1].
  int tn = ntiles;
  if (t < ntiles) {
    tile_meta(yn_g, t, yn, ok);
    tn = cell_select::next_live(live, t, ntiles);
    if (tn < ntiles) load_tile(Bt + tile_elems, db, tn, a.n, a.d, SB, a.vec);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  float acc[G::MT][G::NT8][4];
  int cur = 0, n_done = 0;
  bool pending = false;  // candidates wait for a drain
  while (t < ntiles) {
    const int nxt = cur ^ 1;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    mma_range<BQ>(acc, A, SA, Bt + cur * tile_elems, SB, 0, a.kp, wm0, wn0);
    int tnn = ntiles;
    if (tn < ntiles) {
      tile_meta(yn_g, tn, yn + nxt * BN, ok + nxt * BN);
      tnn = cell_select::next_live(live, tn, ntiles);
    }
    // The network drains on the 1st, 2nd, 4th, 8th, ... live tile (and
    // whenever a buffer fills): in between, candidates pile up against
    // the last drained k-th, an upper bound of the row's k-th.
    ++n_done;
    select_tile<BQ, SEL, B3_CAND, true>(
        acc, bd, bi, qn, q, yn + cur * BN, ok + cur * BN, t, nq, k, l2, wm0,
        wn0, n_done == 1, (n_done & (n_done - 1)) == 0, &pending);
    // Every warp is past its product of Bt[cur] (selection for k > 1
    // ends on a barrier): refill it.
    if (K1) __syncthreads();
    if (tnn < ntiles) load_tile(Bt + cur * tile_elems, db, tnn, a.n, a.d, SB,
                                a.vec);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    t = tn;
    tn = tnn;
    cur = nxt;
  }
  cp_wait<0>();
  if (SEL == SEL_NET && pending) {
    cell_select::drain_network<BQ, B3_CAND / BQ>(q, nq, k);
    __syncthreads();
  }
  write_rows<BQ, K1>(bd, bi, red_d, red_i, q.kd, q.ki, nq, k, wm0, od, oi);
}

constexpr int ORDER_T = 1024;  // threads of the order kernel, and its keys

// The work of slab s, capped at ORDER_T - 1: its live tiles times its
// blocks of live rows.
__device__ __forceinline__ int slab_work(const uint8_t* __restrict__ live,
                                         const int* __restrict__ live_rows,
                                         int s, int ntiles, int m, int bq) {
  const uint8_t* f = live + (size_t)s * ntiles;
  int tiles = 0;
  for (int j = 0; j < ntiles; ++j) tiles += f[j];
  const int rows = live_rows == nullptr ? m : min(max(live_rows[s], 0), m);
  return min(tiles * ((rows + bq - 1) / bq), ORDER_T - 1);
}

// One block: order[0, batch) = the slabs by descending work (a counting
// sort), so that the scan's longest items start first and its last wave
// is short. Slabs of equal work come in any order; the result does not
// depend on it.
__global__ void __launch_bounds__(ORDER_T)
    b3_order_kernel(const uint8_t* __restrict__ live,
                    const int* __restrict__ live_rows, int* __restrict__ order,
                    int batch, int ntiles, int m, int bq) {
  __shared__ int start[ORDER_T];
  __shared__ int wsum[ORDER_T / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  start[tid] = 0;
  __syncthreads();
  for (int s = tid; s < batch; s += ORDER_T)
    atomicAdd(&start[slab_work(live, live_rows, s, ntiles, m, bq)], 1);
  __syncthreads();
  // Thread t scans the count of key ORDER_T - 1 - t: the largest first.
  const int key = ORDER_T - 1 - tid, v = start[key];
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  start[key] = (warp > 0 ? wsum[warp - 1] : 0) + x - v;
  __syncthreads();
  for (int s = tid; s < batch; s += ORDER_T)
    order[atomicAdd(&start[slab_work(live, live_rows, s, ntiles, m, bq)],
                    1)] = s;
}

template <int BQ, int SEL>
cudaError_t run_scan(const Args& a, int batch, size_t bytes,
                     cudaStream_t st) {
  auto kern = b3_scan_kernel<BQ, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  const long long grid = (long long)batch * ((a.m + BQ - 1) / BQ);
  kern<<<(unsigned)grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t scan_sel(const Args& a, int batch, size_t bytes,
                     cudaStream_t st) {
  if (a.k == 1) return run_scan<BQ, SEL_MIN>(a, batch, bytes, st);
  if (a.k <= NET_K) return run_scan<BQ, SEL_NET>(a, batch, bytes, st);
  return run_scan<BQ, SEL_MERGE>(a, batch, bytes, st);
}

}  // namespace

extern "C" {

// One B3 call on the tensor-core path: the pre-pass into yn (batch, capp)
// and live (batch, capp / 128), capp = n rounded up to 128; when there are
// more slabs than SMs, their largest-first order into order (batch,); then
// the scan on the plan of ops/fused_knn.py::_b3_plan (bq query rows per
// CTA, smem bytes, which must equal this file's Layout). q (batch, m, d)
// f32, db (batch, n, d) bf16, invalid (batch, n); live_rows (batch,) or
// nullptr for every row. Operands need only their element alignment: the
// copies take 16 bytes when d % 8 == 0 and db starts on 16 bytes, else the
// widest that d and db's alignment allow. Returns the first launch error.
int fused_batch_knn_launch(const float* q, const void* db,
                           const uint8_t* invalid, const int* live_rows,
                           float* yn, uint8_t* live, int* order, float* out_d,
                           int* out_i, int batch, int m, int n, int d, int k,
                           int l2, int bq, int smem, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int capp = (n + BN - 1) / BN * BN;
  const int kp = (d + 15) / 16 * 16;
  if (k < 1 || k > KMAX || k > n || d < 1 || batch > 65535 ||
      !(bq == 16 || bq == 32 || bq == 64) ||
      (long long)batch * ((m + bq - 1) / bq) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
  const Layout lay(bq, warps_n, kp, k);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cell_norms::launch(db, 1, invalid, yn, live, batch, n,
                                      capp, d, l2, st);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t da = reinterpret_cast<uintptr_t>(db);
  const int vec = d % 8 == 0 && (da & 15) == 0  ? 16
                  : d % 4 == 0 && (da & 7) == 0 ? 8
                  : d % 2 == 0 && (da & 3) == 0 ? 4
                                                : 2;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool ordered = batch > n_sm;
  if (ordered) {
    b3_order_kernel<<<1, ORDER_T, 0, st>>>(live, live_rows, order, batch,
                                           capp / BN, m, bq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const Args a{q, static_cast<const __nv_bfloat16*>(db), yn, live, live_rows,
               ordered ? order : nullptr, out_d, out_i, m, n, capp, d, kp, k,
               l2, vec};
  if (bq == 64)
    err = scan_sel<64>(a, batch, lay.total, st);
  else if (bq == 32)
    err = scan_sel<32>(a, batch, lay.total, st);
  else
    err = scan_sel<16>(a, batch, lay.total, st);
  return (int)err;
}

}  // extern "C"
