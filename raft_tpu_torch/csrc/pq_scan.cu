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
//     16 x 16 each). bf16 products are exact in f32; within a k16 step the
//     tensor core sums in its own order, so results equal the FMA order
//     bit for bit only where the partial sums are exact (integer data);
//   * the pre-pass, a kernel of this library and part of every call,
//     writes each tile's live flag and, for L2, |cw|^2 in f32 (row order,
//     from the unrounded values) of every valid (list, slot) into scratch
//     the wrapper allocates per call; the index keeps nothing, so extend /
//     upsert / compact cannot leave it stale;
//   * selection in registers, after B1's filter: the
//     accumulators become distances in place (NaN marks invalid slots and
//     padding rows, which no test accepts), each pair is tested against
//     its row's k-th (distance, slot), and only the pairs that pass go
//     into per-row candidate buffers (one atomic per thread and row). A
//     cell's first tile meets empty queues; for k <= 16 the k-th smallest
//     of the per-thread row minima bounds the row's k-th from above, so
//     only ~k pairs a row pass there instead of 128. The candidates then
//     enter the sorted queues: for k <= 16 one thread per row, through an
//     unrolled insertion network on the queue held in registers; for
//     k > 16 one warp per row, by a warp bitonic sort and a merge by
//     rank. k = 1 keeps a running (min, slot) per row in registers.
//     The bound, the network and the merge are cell_select.cuh's, which
//     B2 (cells_tf32.cu, cells_mma.cu) shares; the product, the filter and the write-out
//     are mma_tile.cuh's, which B3 (batch_knn.cu) shares.
//
// On the H100 (tools/tune_b4.py, PERF.md) selection still takes about
// half of the k = 10 time: the insertion rounds run on the 2 warps that
// own the rows while the other 6 wait at the barrier. Decoding is the
// next largest part; the product itself is a small one.
//
// Callers pass finite operands (the entry points reject non-finite
// inputs): an L2 NaN would come out of fmaxf as distance 0.

#include "mma_tile.cuh"

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

// Byte offsets of the shared-memory regions (ops/pq_scan.py::
// _b4_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t A, tab, Bt, cs, kmap, qn, yn, ok, red, kd, ki, cd, ci, cnt, qmask,
      tm, thr;
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
    red = kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k == 1) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else {
      kd = take(at, (size_t)bq * k * 4);
      ki = take(at, (size_t)bq * k * 4);
      cd = take(at, (size_t)CAND * 4);
      ci = take(at, (size_t)CAND * 4);
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

// Validity and code norms of tile t's slots into ok / yn.
__device__ __forceinline__ void tile_meta(const uint8_t* __restrict__ inv,
                                          const float* __restrict__ cwn,
                                          int t, bool l2, int* ok, float* yn) {
  if (threadIdx.x < BN) {
    const int slot = t * BN + threadIdx.x;
    const int v = !inv[slot];
    ok[threadIdx.x] = v;
    yn[threadIdx.x] = (l2 && v) ? cwn[slot] : 0.f;
  }
}

// Shared-memory pointers of one CTA.
struct Smem {
  unsigned short *A, *tab, *Bt;
  uint8_t* cs;
  int* kmap;
  float* qn;
  float* yn;
  int* ok;
  float* red_d;
  int* red_i;
  float* tm;  // [BQ][WARPS_N * 4] per-thread row minima (k <= NET_K)
  float* thr;  // [BQ] first-tile bounds
  float* kd;
  int* ki;
  float* cd;
  int* ci;
  int* cnt;
  unsigned* qmask;
};

// One CTA walks (cell, row block) items w = blockIdx.x, + gridDim.x, ...
template <int BQ, bool SLICED, bool K1, typename T>
__global__ void __launch_bounds__(NT, 1) b4_scan_kernel(const Args<T> a) {
  using G = Geo<BQ>;
  constexpr int SEL = K1 ? SEL_MIN : SEL_ANY;
  extern __shared__ __align__(16) char smem[];
  const Layout lay(BQ, G::WARPS_N, a.kp, a.ks, a.pq_bits, a.nbytes, a.k,
                   SLICED);
  Smem s;
  s.A = reinterpret_cast<unsigned short*>(smem + lay.A);
  s.tab = reinterpret_cast<unsigned short*>(smem + lay.tab);
  s.Bt = reinterpret_cast<unsigned short*>(smem + lay.Bt);
  s.cs = reinterpret_cast<uint8_t*>(smem + lay.cs);
  s.kmap = reinterpret_cast<int*>(smem + lay.kmap);
  s.qn = reinterpret_cast<float*>(smem + lay.qn);
  s.yn = reinterpret_cast<float*>(smem + lay.yn);
  s.ok = reinterpret_cast<int*>(smem + lay.ok);
  s.red_d = reinterpret_cast<float*>(smem + lay.red);
  s.red_i = reinterpret_cast<int*>(smem + lay.red) + G::WARPS_N * BQ;
  s.kd = reinterpret_cast<float*>(smem + lay.kd);
  s.ki = reinterpret_cast<int*>(smem + lay.ki);
  s.cd = reinterpret_cast<float*>(smem + lay.cd);
  s.ci = reinterpret_cast<int*>(smem + lay.ci);
  s.cnt = reinterpret_cast<int*>(smem + lay.cnt);
  s.qmask = reinterpret_cast<unsigned*>(smem + lay.qmask);
  s.tm = reinterpret_cast<float*>(smem + lay.tm);
  s.thr = reinterpret_cast<float*>(smem + lay.thr);
  const cell_select::Queues q{s.kd,  s.ki,    s.cd, s.ci,
                              s.cnt, s.qmask, s.tm, s.thr};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / G::WARPS_N) * G::WM;
  const int wn0 = (warp % G::WARPS_N) * G::WN;
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
    s.kmap[r] = m;
  }
  if (!SLICED) stage_table(a, s.tab, 0, a.kp);

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
        s.A[r * SA + c] = bf16_bits(v);
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) s.qn[r] = acc;
    }
    if (!K1) {
      for (int j = tid; j < BQ * k; j += NT) {
        s.kd[j] = INFINITY;
        s.ki[j] = NONE;
      }
      for (int j = tid; j < BQ; j += NT) s.cnt[j] = 0;
      for (int j = tid; j < (BQ + 31) / 32; j += NT) s.qmask[j] = 0;
    }
    float bd[2 * G::MT];
    int bi[2 * G::MT];
#pragma unroll
    for (int i = 0; i < 2 * G::MT; ++i) {
      bd[i] = INFINITY;
      bi[i] = NONE;
    }
    const uint8_t* codes = a.codesT + (size_t)list * a.nbytes * a.capp;
    const uint8_t* inv = a.invalid + (size_t)list * a.capp;
    const float* cwn = a.cwn + (size_t)list * a.capp;
    const uint8_t* live = a.live + (size_t)list * ntiles;
    float acc[G::MT][G::NT8][4];
    bool first = true;  // the item's first live tile

    if (!SLICED) {
      // Tile t is decoded in Bt[cur]; the codes of tn sit in cs[cur ^ 1].
      const int csz = a.nbytes * BN;
      int t = cell_select::next_live(live, -1, ntiles);
      if (t < ntiles) load_codes(s.cs, codes, t, a.nbytes, a.capp, a.vec);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      int tn = ntiles;
      if (t < ntiles) {
        decode_tile(pairs, s.kmap, s.tab, a.ks, 0, a.kp, s.cs, BN, s.Bt, SB);
        tile_meta(inv, cwn, t, l2, s.ok, s.yn);
        tn = cell_select::next_live(live, t, ntiles);
        if (tn < ntiles)
          load_codes(s.cs + csz, codes, tn, a.nbytes, a.capp, a.vec);
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      int cur = 0;
      while (t < ntiles) {
        const int nxt = cur ^ 1;
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        mma_range<BQ>(acc, s.A, SA, s.Bt + cur * tile_elems, SB, 0, a.kp,
                      wm0, wn0);
        int tnn = ntiles;
        if (tn < ntiles) {
          decode_tile(pairs, s.kmap, s.tab, a.ks, 0, a.kp, s.cs + nxt * csz, BN,
                      s.Bt + nxt * tile_elems, SB);
          tile_meta(inv, cwn, tn, l2, s.ok + nxt * BN, s.yn + nxt * BN);
          tnn = cell_select::next_live(live, tn, ntiles);
          if (tnn < ntiles)
            load_codes(s.cs + cur * csz, codes, tnn, a.nbytes, a.capp, a.vec);
        }
        cp_commit();
        select_tile<BQ, SEL>(acc, bd, bi, s.qn, q, s.yn + cur * BN,
                             s.ok + cur * BN, t, nq, k, l2, wm0, wn0, first);
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
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        for (int k0 = 0; k0 < a.kp; k0 += a.ks) {
          const int kw = min(a.ks, a.kp - k0);
          __syncthreads();
          stage_table(a, s.tab, k0, kw);
          if (k0 == 0) tile_meta(inv, cwn, t, l2, s.ok, s.yn);
          __syncthreads();
          decode_tile(pairs, s.kmap, s.tab, a.ks, k0, kw, codes + (size_t)t * BN,
                      a.capp, s.Bt, SB);
          __syncthreads();
          mma_range<BQ>(acc, s.A, SA, s.Bt, SB, k0, kw, wm0, wn0);
        }
        select_tile<BQ, SEL>(acc, bd, bi, s.qn, q, s.yn, s.ok, t, nq, k, l2,
                             wm0, wn0, first);
        first = false;
      }
      __syncthreads();
    }

    write_rows<BQ, K1>(bd, bi, s.red_d, s.red_i, s.kd, s.ki, nq, k, wm0, od,
                       oi);
    __syncthreads();
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

template <int BQ, bool SLICED, bool K1, typename T>
cudaError_t run_scan(const Args<T>& a, size_t bytes, cudaStream_t st) {
  auto kern = b4_scan_kernel<BQ, SLICED, K1, T>;
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

template <bool SLICED, bool K1, typename T>
cudaError_t scan_rows(const Args<T>& a, int bq, size_t bytes,
                      cudaStream_t st) {
  if (bq == 64) return run_scan<64, SLICED, K1, T>(a, bytes, st);
  if (bq == 32) return run_scan<32, SLICED, K1, T>(a, bytes, st);
  return run_scan<16, SLICED, K1, T>(a, bytes, st);
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
  if (sliced)
    err = a.k == 1 ? scan_rows<true, true>(a, bq, lay.total, st)
                   : scan_rows<true, false>(a, bq, lay.total, st);
  else
    err = a.k == 1 ? scan_rows<false, true>(a, bq, lay.total, st)
                   : scan_rows<false, false>(a, bq, lay.total, st);
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
