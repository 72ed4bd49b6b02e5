// Compressed-domain IVF-PQ scan (B4) for Hopper (sm_90a).
//
// Replaces pq_fused_scan / _pq_scan_kernel / _pq_scan_cell_body of
// raft_tpu/ops/pq_scan.py. Cell c scores its qrows residual-scale query
// rows (in the kernel's permuted subspace order) against the packed PQ
// codes of list cell_list[c]; -1 cells write (inf, -1) sentinels. The
// function (ops/pq_scan.py::_pq_fused_scan_plain):
//
//   * code j' of slot c is codesT[list, j', c] (pq_bits 8), or for pq_bits
//     4 the low nibbles of the nbytes raw rows followed by their high
//     nibbles; row r = j' * L + s of the codeword is table[r, code] (lo
//     half below 128, hi above; int8 tables dequantized in f32 as
//     q * scale[r, half], the hi scale only when B > 128);
//   * g = sum_r bf16(q[r]) * bf16(cw[r]) with f32 sums; L2 max(qn + cwn -
//     2g, 0) with f32 norms of the unrounded values, or -g for inner
//     product; the exact top-k by (distance, slot), ties to the lowest
//     slot, -1 for inf slots (the result of both reference epilogues).
//
// What bounds it on the H100: the code bytes are small (1 byte per
// subspace per slot, 64 B a slot at the main path) and the product is 2 *
// rot operations per (query row, slot) at the bf16 tensor-core rate
// (989 TFLOP/s), 0.15 ms at the main path. The work in between, decoding
// codes into codewords and selecting, is what a design has to keep off
// that path. What this one does:
//
//   * one CTA of 256 threads owns BQ query rows of a cell (64, the cell
//     height, or 32 / 16 when the top-k queue needs the room;
//     ops/pq_scan.py::_b4_plan), so each code is decoded once per cell.
//     The CTAs are persistent: each walks (cell, row block) items, so the
//     table is staged once per CTA, not once per cell;
//   * the codeword table is resident in shared memory as bf16, staged
//     from f32 (int8: dequantized first) with round to nearest even, so
//     each staged value equals the plain version's bf16(cw). Layout
//     [code][row of rot] with an odd word stride, so a decode reads
//     tab[code * (ks + 2) + r] without bank conflicts. Where the
//     table does not fit (e.g. rot > 256 at pq_bits 8), the "sliced" plan
//     stages ks rows of it at a time, in step with the product's K range
//     (the same kernel; codes are then read straight from global memory);
//   * the query operand is staged once per item as bf16 (BQ x rot, row
//     stride rot + 8); the f32 query norms come from the unrounded rows;
//   * decode: each 128-slot tile's u8 codes land in shared memory by
//     16-byte cp.async (4-byte-aligned callers take byte loads) one tile
//     ahead, and threads expand them through the table into a slot-major
//     bf16 tile (128 x (rot + 8)), 16 bytes a store. Tiles are double-
//     buffered: tile t+1 is decoded right after tile t's product, so one
//     warp's decode overlaps another's mma and selection. With L even, a
//     code's two rows are one 32-bit table read. Tiles whose slots are
//     all invalid are skipped: the pre-pass flags each tile, and a warp
//     finds the next live one from 32 flags a load (no barrier);
//   * the product: mma.sync m16n8k16 bf16 with f32 accumulators, operands
//     by ldmatrix; 8 warps tile the BQ x 128 block (32 x 32, 32 x 16 or
//     16 x 16 each; 16 x 64, 16 x 32 or 16 x 16 where the selection is
//     kept in registers, so a warp holds whole rows of 16). bf16 products
//     are exact in f32; within a k16 step the tensor core sums in its own
//     order, so results equal the FMA order bit for bit only where the
//     partial sums are exact (integer data);
//   * the pre-pass, a kernel of this library and part of every call,
//     writes each tile's live flag and, for L2, |cw|^2 in f32 (row order,
//     from the unrounded values) of every valid (list, slot) into scratch
//     the wrapper allocates per call; the index keeps nothing, so extend /
//     upsert / compact cannot leave it stale;
//   * selection by k. For 1 < k <= 16 (every IVF-PQ search at the
//     default k = 10) the top-k stays in the registers of the threads
//     that hold the distances (thread_topk.cuh): each thread keeps a
//     sorted queue of one row over its own slots, tests each tile's pairs
//     against its k-th and the row's least published bound, and inserts
//     the few that pass by an unrolled network; no atomic and no barrier
//     per tile. A row's queues merge once per (cell, row block), by
//     shuffles within a warp and by rank across warps. k = 1 keeps a
//     running (min, slot) per row in registers; k > 16 sends the pairs
//     that beat their row's k-th into shared-memory candidate buffers,
//     which one warp per row merges into the row's queue (warp bitonic
//     sort, merge by rank). Those two are mma_tile.cuh's select_tile and
//     cell_select.cuh's drains, shared with B2 (cells_tf32.cu,
//     cells_mma.cu) and B3 (batch_knn.cu).
//
// On the H100 (tools/tune_b4.py at the main path, k = 10; PERF.md) the
// shared-memory queues took 3.03 of 5.93 ms: the insertion rounds ran on
// the 2 warps that own the rows while the other 6 waited, 5 barriers a
// tile. With the queues in registers the scan takes 3.46-3.57 ms (k = 1:
// 2.94-3.05, its path unchanged). The decode (0.82 ms), the per-item
// staging and the first tile's insertions are what is left of the gap
// to the 0.15 ms product; a tile's insertion rounds run as long as the
// busiest lane of the warp needs.
//
// Callers pass finite operands (the entry points reject non-finite
// inputs): an L2 NaN would come out of fmaxf as distance 0.

#include "thread_topk.cuh"

namespace {

using namespace mma_tile;

constexpr int LANES = 128;   // codes per table half

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// The f32 codeword value of table row r for code b (int8: dequantized).
template <typename T>
__device__ __forceinline__ float cw_value(const T* __restrict__ lo,
                                          const T* __restrict__ hi,
                                          const float* __restrict__ scale,
                                          int r, int b) {
  const bool upper = b >= LANES;  // pq_bits 8 only
  float v = upper ? to_f(__ldg(&hi[(size_t)r * LANES + b - LANES]))
                  : to_f(__ldg(&lo[(size_t)r * LANES + b]));
  if (scale != nullptr) v *= __ldg(&scale[r * 2 + (upper ? 1 : 0)]);
  return v;
}

// The selection of a scan instance: k = 1 (a register minimum per row,
// select_tile's SEL_MIN), 1 < k <= 16 (thread_topk.cuh's queues in
// registers) or k > 16 (select_tile's warp merges).
enum Path { P_MIN, P_REGS, P_MERGE };

__host__ __device__ inline Path path_of(int k) {
  return k == 1 ? P_MIN : k <= thread_topk::QMAX ? P_REGS : P_MERGE;
}

// Byte offsets of the shared-memory regions (ops/pq_scan.py::
// _b4_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t A, tab, Bt, cs, kmap, qn, yn, ok, red, rb, mrg, kd, ki, cd, ci,
      cnt, qmask;
  size_t total;
  __host__ __device__ Layout(int bq, int warps_n, int kp, int ks, int pq_bits,
                             int nbytes, int k, bool sliced) {
    size_t at = 0;
    A = take(at, (size_t)bq * (kp + 8) * 2);
    tab = take(at, ((size_t)1 << pq_bits) * (ks + 2) * 2);
    Bt = take(at, (size_t)(sliced ? 1 : 2) * BN * (ks + 8) * 2);
    cs = take(at, sliced ? 0 : (size_t)2 * nbytes * BN);
    kmap = take(at, (size_t)kp * 4);
    qn = take(at, (size_t)bq * 4);
    yn = take(at, 2 * BN * 4);
    ok = take(at, 2 * BN * 4);
    red = rb = mrg = kd = ki = cd = ci = cnt = qmask = 0;
    const Path path = path_of(k);
    if (path == P_MIN) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else if (path == P_REGS) {
      // The rows' published bounds, and k pairs for each of the 16 rows
      // of each of the 8 warps.
      rb = take(at, (size_t)bq * 4);
      mrg = take(at, (size_t)NW * 16 * k * 8);
    } else {
      kd = take(at, (size_t)bq * k * 4);
      ki = take(at, (size_t)bq * k * 4);
      cd = take(at, (size_t)CAND * 4);
      ci = take(at, (size_t)CAND * 4);
      cnt = take(at, (size_t)bq * 4);
      qmask = take(at, 4 * (size_t)((bq + 31) / 32));
    }
    total = at;
  }
};

template <typename T>
struct Args {
  const int* cell_list;
  const float* q;          // (n_cells, qrows, rot)
  const uint8_t* codesT;   // (n_lists, nbytes, capp)
  const T* lo;             // (rot, 128)
  const T* hi;             // (rot, 128), or a 1-row dummy at pq_bits 4
  const float* scale;      // (rot, 2) for int8 tables, else nullptr
  const uint8_t* invalid;  // (n_lists, capp)
  float* cwn;              // (n_lists, capp), L2 only: the pre-pass's
  uint8_t* live;           // (n_lists, capp / 128): the pre-pass's
  float* out_d;            // (n_cells, qrows, k)
  int* out_i;
  int n_cells, qrows, rot, nbytes, capp, L, pq_bits, k, l2, kp, ks, vec;
  int n_lists;
};

// The u8 codes of tile t (nbytes rows x 128 slots) into cs.
__device__ __forceinline__ void load_codes(uint8_t* cs,
                                           const uint8_t* __restrict__ codes,
                                           int t, int nbytes, int capp,
                                           bool vec) {
  const size_t t0 = (size_t)t * BN;
  if (vec) {
    for (int u = threadIdx.x; u < nbytes * 8; u += NT) {
      const int row = u >> 3, part = u & 7;
      cp_async<16>(cs + row * BN + part * 16,
                 codes + (size_t)row * capp + t0 + part * 16);
    }
  } else {
    for (int u = threadIdx.x; u < nbytes * BN; u += NT) {
      const int row = u / BN, c = u % BN;
      cs[row * BN + c] = codes[(size_t)row * capp + t0 + c];
    }
  }
}

// Table rows [k0, k0 + kw) as bf16 into tab[code][r - k0], row stride ks +
// 2: an odd number of 32-bit words, so the lanes of a decode, which read
// one row r under random codes, spread over the banks (a stride of ks
// would put them all on one bank). Rows past rot are never read.
template <typename T>
__device__ __forceinline__ void stage_table(const Args<T>& a,
                                            unsigned short* tab, int k0,
                                            int kw) {
  const int B = 1 << a.pq_bits;
  for (int e = threadIdx.x; e < B * kw; e += NT) {
    const int rr = e % kw, b = e / kw, r = k0 + rr;
    tab[b * (a.ks + 2) + rr] =
        r < a.rot ? bf16_bits(cw_value(a.lo, a.hi, a.scale, r, b)) : 0;
  }
}

// Decode slots [0, 128) of a tile, table rows [k0, k0 + kw) (kw % 16 ==
// 0), into Bt[slot][r - k0] (row stride SB). kmap[r]: the code row in its
// low 16 bits, above it 0 (whole byte), 1 (low nibble) or 2 (high
// nibble); -1 for the zero padding past rot. Codes come from codes[row *
// stride + slot] (shared memory, or global memory on the sliced plan).
template <bool PAIRS>
__device__ __forceinline__ void decode_pass(
    const int* __restrict__ kmap, const unsigned short* __restrict__ tab,
    int ks, int k0, int kw, const uint8_t* __restrict__ codes, int stride,
    unsigned short* Bt, int SB) {
  const int nch = kw >> 3;
  for (int u = threadIdx.x; u < BN * nch; u += NT) {
    const int c = u % BN, ch = u / BN;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t bits[2];
#pragma unroll
      for (int e = 0; e < (PAIRS ? 1 : 2); ++e) {
        const int rr = ch * 8 + 2 * h + e;
        const int m = kmap[k0 + rr];
        bits[e] = 0;
        if (m >= 0) {
          const int raw = codes[(size_t)(m & 0xffff) * stride + c];
          const int sel = m >> 16;
          const int code = sel == 0 ? raw : sel == 1 ? (raw & 15) : (raw >> 4);
          const int at = code * (ks + 2) + rr;
          // With L even, rows rr and rr + 1 are one code's: one word.
          bits[e] = PAIRS ? reinterpret_cast<const uint32_t*>(tab)[at >> 1]
                          : tab[at];
        }
      }
      w[h] = PAIRS ? bits[0] : bits[0] | (bits[1] << 16);
    }
    *reinterpret_cast<uint4*>(Bt + c * SB + ch * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void decode_tile(
    bool pairs, const int* __restrict__ kmap,
    const unsigned short* __restrict__ tab, int ks, int k0, int kw,
    const uint8_t* __restrict__ codes, int stride, unsigned short* Bt,
    int SB) {
  if (pairs)
    decode_pass<true>(kmap, tab, ks, k0, kw, codes, stride, Bt, SB);
  else
    decode_pass<false>(kmap, tab, ks, k0, kw, codes, stride, Bt, SB);
}

// Validity and code norms of tile t's slots into ok / yn (+inf at invalid
// slots, 0 at valid ones for inner product).
__device__ __forceinline__ void tile_meta(const uint8_t* __restrict__ inv,
                                          const float* __restrict__ cwn,
                                          int t, bool l2, int* ok, float* yn) {
  if (threadIdx.x < BN) {
    const int slot = t * BN + threadIdx.x;
    const int v = !inv[slot];
    ok[threadIdx.x] = v;
    yn[threadIdx.x] = !v ? INFINITY : l2 ? cwn[slot] : 0.f;
  }
}

// One CTA walks (cell, row block) items w = blockIdx.x, + gridDim.x, ...
// P_MIN and P_MERGE tile the block as mma_tile.cuh's Geo<BQ> and select by
// its select_tile; P_REGS as thread_topk.cuh's RowGeo<BQ>, selecting in
// registers.
template <int BQ, bool SLICED, int PATH, int Q, typename T>
__global__ void __launch_bounds__(NT, 1) b4_scan_kernel(const Args<T> a) {
  constexpr bool REGS = PATH == P_REGS;
  using GA = Geo<BQ>;
  using GR = thread_topk::RowGeo<BQ>;
  constexpr int MT = REGS ? 1 : GA::MT;
  constexpr int NT8 = REGS ? GR::NT8 : GA::NT8;
  constexpr int WARPS_N = REGS ? GR::WARPS_N : GA::WARPS_N;
  constexpr int WM = REGS ? 16 : GA::WM;
  constexpr int WN = REGS ? GR::WN : GA::WN;
  constexpr int SEL = PATH == P_MIN ? SEL_MIN : SEL_MERGE;
  extern __shared__ __align__(16) char smem[];
  const Layout lay(BQ, GA::WARPS_N, a.kp, a.ks, a.pq_bits, a.nbytes, a.k,
                   SLICED);
  unsigned short* sA = reinterpret_cast<unsigned short*>(smem + lay.A);
  unsigned short* tab = reinterpret_cast<unsigned short*>(smem + lay.tab);
  unsigned short* Bt = reinterpret_cast<unsigned short*>(smem + lay.Bt);
  uint8_t* cs = reinterpret_cast<uint8_t*>(smem + lay.cs);
  int* kmap = reinterpret_cast<int*>(smem + lay.kmap);
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
  float* yn = reinterpret_cast<float*>(smem + lay.yn);
  int* ok = reinterpret_cast<int*>(smem + lay.ok);
  float* kd = reinterpret_cast<float*>(smem + lay.kd);
  int* ki = reinterpret_cast<int*>(smem + lay.ki);
  const cell_select::Queues q{kd,
                              ki,
                              reinterpret_cast<float*>(smem + lay.cd),
                              reinterpret_cast<int*>(smem + lay.ci),
                              reinterpret_cast<int*>(smem + lay.cnt),
                              reinterpret_cast<unsigned*>(smem + lay.qmask),
                              nullptr,
                              nullptr};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  const int SA = a.kp + 8, SB = a.ks + 8;
  const int k = a.k;
  const bool l2 = a.l2 != 0;
  const int ntiles = a.capp / BN;
  const int nqb = (a.qrows + BQ - 1) / BQ;
  const int n_work = a.n_cells * nqb;
  const int tile_elems = BN * SB;
  const bool pairs = a.L % 2 == 0;

  for (int r = tid; r < a.kp; r += NT) {
    int m = -1;
    if (r < a.rot) {
      const int j = r / a.L;
      m = a.pq_bits == 8 ? j
          : j < a.nbytes ? (j | (1 << 16))
                         : ((j - a.nbytes) | (2 << 16));
    }
    kmap[r] = m;
  }
  if (!SLICED) stage_table(a, tab, 0, a.kp);

  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int cell = w / nqb, q0 = (w % nqb) * BQ;
    const int nq = min(BQ, a.qrows - q0);
    const size_t row0 = (size_t)cell * a.qrows + q0;
    float* od = a.out_d + row0 * k;
    int* oi = a.out_i + row0 * k;
    const int list = a.cell_list[cell];
    if (list < 0) {
      for (int e = tid; e < nq * k; e += NT) {
        od[e] = INFINITY;
        oi[e] = -1;
      }
      continue;
    }
    // The bf16 query operand (zero past nq and rot) and the f32 norms of
    // the unrounded rows, a warp per row.
    const float* qb = a.q + row0 * a.rot;
    for (int r = warp; r < BQ; r += NW) {
      float acc = 0.f;
      for (int c = lane; c < a.kp; c += 32) {
        const float v = (r < nq && c < a.rot) ? qb[(size_t)r * a.rot + c] : 0.f;
        acc = fmaf(v, v, acc);
        sA[r * SA + c] = bf16_bits(v);
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) qn[r] = acc;
    }
    if (PATH == P_MERGE) {
      for (int j = tid; j < BQ * k; j += NT) {
        kd[j] = INFINITY;
        ki[j] = NONE;
      }
      for (int j = tid; j < BQ; j += NT) q.cnt[j] = 0;
      for (int j = tid; j < (BQ + 31) / 32; j += NT) q.qmask[j] = 0;
    }
    float* rb = reinterpret_cast<float*>(smem + lay.rb);
    if (REGS)
      for (int j = tid; j < BQ; j += NT) rb[j] = INFINITY;
    float bd[2 * GA::MT];
    int bi[2 * GA::MT];
#pragma unroll
    for (int i = 0; i < 2 * GA::MT; ++i) {
      bd[i] = INFINITY;
      bi[i] = NONE;
    }
    thread_topk::Queue<Q> rq;
    if constexpr (REGS) thread_topk::reset(rq, k);
    const uint8_t* codes = a.codesT + (size_t)list * a.nbytes * a.capp;
    const uint8_t* inv = a.invalid + (size_t)list * a.capp;
    const float* cwn = a.cwn + (size_t)list * a.capp;
    const uint8_t* live = a.live + (size_t)list * ntiles;
    float acc[MT][NT8][4];
    bool first = true;  // the item's first live tile
    if (!SLICED) {
      // Tile t is decoded in Bt[cur]; the codes of tn sit in cs[cur ^ 1].
      const int csz = a.nbytes * BN;
      int t = cell_select::next_live(live, -1, ntiles);
      if (t < ntiles) load_codes(cs, codes, t, a.nbytes, a.capp, a.vec);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      int tn = ntiles;
      if (t < ntiles) {
        decode_tile(pairs, kmap, tab, a.ks, 0, a.kp, cs, BN, Bt, SB);
        tile_meta(inv, cwn, t, l2, ok, yn);
        tn = cell_select::next_live(live, t, ntiles);
        if (tn < ntiles)
          load_codes(cs + csz, codes, tn, a.nbytes, a.capp, a.vec);
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      int cur = 0;
      while (t < ntiles) {
        const int nxt = cur ^ 1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        if constexpr (REGS)
          thread_topk::mma_rows<BQ>(acc[0], sA, SA, Bt + cur * tile_elems, SB,
                                    0, a.kp, wm0, wn0);
        else
          mma_range<BQ>(acc, sA, SA, Bt + cur * tile_elems, SB, 0, a.kp, wm0,
                        wn0);
        int tnn = ntiles;
        if (tn < ntiles) {
          decode_tile(pairs, kmap, tab, a.ks, 0, a.kp, cs + nxt * csz, BN,
                      Bt + nxt * tile_elems, SB);
          tile_meta(inv, cwn, tn, l2, ok + nxt * BN, yn + nxt * BN);
          tnn = cell_select::next_live(live, tn, ntiles);
          if (tnn < ntiles)
            load_codes(cs + cur * csz, codes, tnn, a.nbytes, a.capp, a.vec);
        }
        cp_commit();
        if constexpr (REGS)
          thread_topk::select_regs<BQ>(acc[0], rq, qn, yn + cur * BN, rb, t,
                                       nq, l2, wm0, wn0, first);
        else
          select_tile<BQ, SEL>(acc, bd, bi, qn, q, yn + cur * BN,
                               ok + cur * BN, t, nq, k, l2, wm0, wn0, first);
        first = false;
        cp_wait<0>();
        __syncthreads();
        t = tn;
        tn = tnn;
        cur = nxt;
      }
    } else {
      __syncthreads();
      for (int t = cell_select::next_live(live, -1, ntiles); t < ntiles;
           t = cell_select::next_live(live, t, ntiles)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        for (int k0 = 0; k0 < a.kp; k0 += a.ks) {
          const int kw = min(a.ks, a.kp - k0);
          __syncthreads();
          stage_table(a, tab, k0, kw);
          if (k0 == 0) tile_meta(inv, cwn, t, l2, ok, yn);
          __syncthreads();
          decode_tile(pairs, kmap, tab, a.ks, k0, kw, codes + (size_t)t * BN,
                      a.capp, Bt, SB);
          __syncthreads();
          if constexpr (REGS)
            thread_topk::mma_rows<BQ>(acc[0], sA, SA, Bt, SB, k0, kw, wm0,
                                      wn0);
          else
            mma_range<BQ>(acc, sA, SA, Bt, SB, k0, kw, wm0, wn0);
        }
        if constexpr (REGS)
          thread_topk::select_regs<BQ>(acc[0], rq, qn, yn, rb, t, nq, l2, wm0,
                                       wn0, first);
        else
          select_tile<BQ, SEL>(acc, bd, bi, qn, q, yn, ok, t, nq, k, l2, wm0,
                               wn0, first);
        first = false;
      }
      __syncthreads();
    }

    if constexpr (REGS)
      thread_topk::merge_rows<BQ>(rq, reinterpret_cast<float*>(smem + lay.mrg),
                                  reinterpret_cast<int*>(smem + lay.mrg) +
                                      NW * 16 * k,
                                  nq, k, wm0, wn0, od, oi);
    else
      write_rows<BQ, PATH == P_MIN>(
          bd, bi, reinterpret_cast<float*>(smem + lay.red),
          reinterpret_cast<int*>(smem + lay.red) + GA::WARPS_N * BQ, kd, ki,
          nq, k, wm0, od, oi);
    // The merge's barrier orders the next item's writes after this one's
    // reads of shared memory.
    if constexpr (!REGS) __syncthreads();
  }
}

// The pre-pass: one block per (128-slot tile, list). Each tile's live flag
// (it holds a valid slot), and for L2 |cw|^2 in f32 of every valid slot
// (row order, unrounded values; 0 for invalid slots, which the scan
// masks).
template <typename T>
__global__ void __launch_bounds__(BN) b4_norms_kernel(const Args<T> a) {
  const int list = blockIdx.y, t = blockIdx.x;
  const int slot = t * BN + threadIdx.x;
  const size_t at = (size_t)list * a.capp + slot;
  const bool valid = !a.invalid[at];
  const int any = __syncthreads_or(valid);
  if (threadIdx.x == 0) a.live[(size_t)list * gridDim.x + t] = any != 0;
  if (!a.l2) return;
  if (!valid) {
    a.cwn[at] = 0.f;
    return;
  }
  const uint8_t* codes = a.codesT + (size_t)list * a.nbytes * a.capp + slot;
  const int J = a.rot / a.L;
  float acc = 0.f;
  for (int j = 0; j < J; ++j) {
    int code;
    if (a.pq_bits == 8)
      code = codes[(size_t)j * a.capp];
    else if (j < a.nbytes)
      code = codes[(size_t)j * a.capp] & 15;
    else
      code = codes[(size_t)(j - a.nbytes) * a.capp] >> 4;
    for (int s = 0; s < a.L; ++s) {
      const float v = cw_value(a.lo, a.hi, a.scale, j * a.L + s, code);
      acc = fmaf(v, v, acc);
    }
  }
  a.cwn[at] = acc;
}

template <int BQ, bool SLICED, int PATH, int Q, typename T>
cudaError_t run_scan(const Args<T>& a, size_t bytes, cudaStream_t st) {
  auto kern = b4_scan_kernel<BQ, SLICED, PATH, Q, T>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      bytes);
  if (err != cudaSuccess) return err;
  const long long work =
      (long long)a.n_cells * ((a.qrows + BQ - 1) / BQ);
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(work < slots ? work : slots);
  kern<<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <bool SLICED, int PATH, int Q, typename T>
cudaError_t scan_rows(const Args<T>& a, int bq, size_t bytes,
                      cudaStream_t st) {
  if (bq == 64) return run_scan<64, SLICED, PATH, Q, T>(a, bytes, st);
  if (bq == 32) return run_scan<32, SLICED, PATH, Q, T>(a, bytes, st);
  return run_scan<16, SLICED, PATH, Q, T>(a, bytes, st);
}

template <bool SLICED, typename T>
cudaError_t scan_path(const Args<T>& a, int bq, size_t bytes,
                      cudaStream_t st) {
  switch (path_of(a.k)) {
    case P_MIN:
      return scan_rows<SLICED, P_MIN, 1>(a, bq, bytes, st);
    case P_REGS:
      // The queue's length: k = 10, the common case, wastes no entry.
      if (a.k <= 10) return scan_rows<SLICED, P_REGS, 10>(a, bq, bytes, st);
      return scan_rows<SLICED, P_REGS, thread_topk::QMAX>(a, bq, bytes, st);
    default:
      return scan_rows<SLICED, P_MERGE, 1>(a, bq, bytes, st);
  }
}

template <typename T>
int launch(Args<T> a, int bq, int sliced, int smem, cudaStream_t st) {
  const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
  const Layout lay(bq, warps_n, a.kp, a.ks, a.pq_bits, a.nbytes, a.k,
                   sliced != 0);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  b4_norms_kernel<T><<<dim3(a.capp / BN, (unsigned)a.n_lists), BN, 0, st>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sliced ? scan_path<true>(a, bq, lay.total, st)
               : scan_path<false>(a, bq, lay.total, st);
  return (int)err;
}

}  // namespace

extern "C" {

// One B4 call: the pre-pass into live (n_lists, capp / 128) and, for L2,
// cwn (n_lists, capp), then
// the scan on the plan of ops/pq_scan.py::_b4_plan (bq query rows per CTA,
// resident or sliced table, slice width ks, smem bytes, which must equal
// this file's Layout). scale == nullptr selects f32 tables, else lo / hi
// are int8 with (rot, 2) scales. The 16-byte code copies need codesT on
// 16 bytes; other pointers need only their element alignment. Returns the
// first launch error.
int pq_fused_scan_launch(const int* cell_list, const float* q,
                         const uint8_t* codesT, const void* lo,
                         const void* hi, const float* scale,
                         const uint8_t* invalid, float* cwn, uint8_t* live,
                         float* out_d,
                         int* out_i, int n_cells, int n_lists, int qrows,
                         int rot, int nbytes, int capp, int pq_dim,
                         int pq_bits, int k, int is_ip, int bq, int sliced,
                         int ks, int smem, void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  const int kp = (rot + 15) / 16 * 16;
  if (k < 1 || k > KMAX || k > capp || capp % BN != 0 || pq_dim <= 0 ||
      rot % pq_dim != 0 || (pq_bits != 4 && pq_bits != 8) ||
      nbytes * (pq_bits == 8 ? 1 : 2) != pq_dim ||
      !(bq == 16 || bq == 32 || bq == 64) || ks % 16 != 0 || ks <= 0 ||
      (sliced ? ks >= kp : ks != kp) || n_lists <= 0 || n_lists > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(codesT) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (scale != nullptr) {
    Args<int8_t> a{cell_list, q, codesT, (const int8_t*)lo,
                   (const int8_t*)hi, scale, invalid, cwn, live, out_d, out_i,
                   n_cells, qrows, rot, nbytes, capp, rot / pq_dim, pq_bits,
                   k, !is_ip, kp, ks, vec, n_lists};
    return launch(a, bq, sliced, smem, st);
  }
  Args<float> a{cell_list, q, codesT, (const float*)lo, (const float*)hi,
                nullptr, invalid, cwn, live, out_d, out_i, n_cells, qrows, rot,
                nbytes, capp, rot / pq_dim, pq_bits, k, !is_ip, kp, ks,
                vec, n_lists};
  return launch(a, bq, sliced, smem, st);
}

}  // extern "C"
