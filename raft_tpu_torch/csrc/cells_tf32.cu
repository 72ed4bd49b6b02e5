// B2's f32 tier for Hopper (sm_90a): the packed-cells IVF-Flat scan on TF32
// tensor cores (mma.sync) with the 3xTF32 split, reading f32 or bf16 rows.
//
// Replaces raft_tpu/ops/fused_knn.py::fused_cells_knn / _cells_knn_kernel
// (pallas_call at :426) on its f32 tier, which the Pallas kernel computes
// as one f32 MXU product at Precision.HIGHEST. Cell c scores its qrows
// queries against list cell_list[c] of a capacity-padded (L, cap, d)
// store of f32 or bf16 rows, skipping the slots a per-slot `invalid` mask
// sets (padding and tombstones); a -1 cell writes (inf, -1). The function
// (ops/fused_knn.py::_fused_cells_knn_plain without bf16): the f32 gram
// g = sum q * y; max(|q|^2 + |y|^2 - 2g, 0) for L2 with f32 norms of the
// rows, or -g for inner product; the exact top-k by (distance, slot),
// ties to the lowest slot, -1 for slots left at inf. The two bf16 tiers
// run on bf16 tensor cores in cells_mma.cu, which shares this file's
// pre-pass (cell_norms.cuh) and tile (mma_tile.cuh).
//
// The split (B1's, knn_tf32.cu). Each operand x is split into hi =
// tf32(x) (cvt.rna: nearest, ties away) and lo = tf32(x - hi), and the
// gram is the sum of three m16n8k8 TF32 products a step, the small terms
// first: lo(q) hi(y), hi(q) lo(y), hi(q) hi(y). Each 8-feature step's
// three products go into a fresh partial sum that one f32 add (round to
// nearest) takes into the accumulators: the tensor core rounds its f32
// sums toward zero, and a partial chained over a pair's products would
// bias the distances (knn_tf32.cu's header; tests/test_torch_fused_knn_
// tf32.py emulates both). A bf16 row is widened exactly (its 8 significant
// bits fit TF32's 11): its lo is 0, so the step takes two products, with
// the same sums. Integers below 2^11 have lo = 0 and exact products, so
// on integer data the result is the plain version's bit for bit.
//
// What bounds it on the H100: 2 * d operations per (query, valid slot)
// pair, three times, at the dense TF32 tensor-core rate, against the bytes
// of the valid rows (read once), the queries and the results. At the main
// path's cells (6024 cells x 64 rows, ~1470 valid rows a cell, d 128) the
// products take 0.85-0.89 ms (the FP32 pipes' bound is 2.1-2.2 ms); the
// bytes about a quarter of that. mma.sync reaches part of the TF32 peak,
// the split's integer work shares its issue slots, and selection (the
// register filter and the queues) adds to it. What the design does:
//
//   * one CTA of 256 threads per (cell, block of BQ query rows): BQ = 64,
//     the cell height, or 32 / 16 when the queue or the resident query
//     needs the room (ops/fused_knn.py::_b2_tf32_plan), so each list is
//     staged once per cell;
//   * the query block stays resident in f32 (row stride d rounded up to
//     32, plus 8 floats, which keeps the fragment loads free of bank
//     conflicts), zero past the cell's rows and d, loaded once per CTA
//     while the first chunk lands, with f32 norms of its rows; each step
//     splits its fragments in registers, as the rows'. Staging the
//     queries again with every chunk (knn_tf32.cu's way, where a CTA
//     sweeps a million rows) would copy 64 query rows beside each 128 list
//     rows; resident, they fit at every d up to 1024 (16 rows there);
//   * the pre-pass of cell_norms.cuh (f32 norms from the unrounded rows,
//     NaN marking invalid slots, the live 128-slot tiles). The scan walks
//     only the live tiles;
//   * each live tile's rows land in 32-feature chunks by cp.async in a
//     ring of two, one chunk ahead of the one multiplied, in the store's
//     own type: f32 rows 16-byte copies (4-byte ones when d % 4 != 0 or
//     the store is off 16 bytes), bf16 rows 16-, 8-, 4- or 2-byte pieces;
//     zero past cap and d. Warps load their m16n8k8 fragments with 8-byte
//     (f32) or 4-byte (bf16) shared loads, a fragment's two features a
//     load (the k slots of a step take its features in pairs);
//   * the accumulators and selection are mma_tile.cuh's: fold_min at k =
//     1, select_tile above (the register filter, the first-tile bound, and
//     cell_select.cuh's insertion network for k <= 16, drained on the 1st,
//     2nd, 4th, ... live tile, B2's schedule, or warp merges). Two CTAs
//     share an SM at the main path (64 rows, k <= 16, d 128), one on the
//     merge path.
//
// Callers pass finite operands (the entry points reject non-finite
// inputs): an L2 NaN would come out of fmaxf as distance 0.

#include "cell_norms.cuh"
#include "knn_gemm.cuh"  // cp.async with zero fill
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int BK = 32;      // features per staged chunk: four k8 steps
constexpr int STAGES = 2;   // staged chunks in flight
constexpr int SR = BK + 8;  // row stride of a staged chunk, in elements
constexpr int CN = 2048;    // candidate slots per CTA (CN / BQ a row)

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b2_tf32_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t A, ring, qn, yn, ok, red, kd, ki, cd, ci, cnt, qmask, tm, thr;
  size_t total;
  __host__ __device__ Layout(int bq, int kp, bool db16, int k) {
    const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
    size_t at = 0;
    A = take(at, (size_t)bq * (kp + 8) * 4);
    ring = take(at, (size_t)STAGES * BN * SR * (db16 ? 2 : 4));
    qn = take(at, (size_t)bq * 4);
    yn = take(at, (size_t)2 * BN * 4);
    ok = red = kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k == 1) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else {
      ok = take(at, (size_t)2 * BN * 4);
      kd = take(at, (size_t)bq * k * 4);
      ki = take(at, (size_t)bq * k * 4);
      cd = take(at, (size_t)CN * 4);
      ci = take(at, (size_t)CN * 4);
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
  const int* cell_list;  // (n_cells,)
  const float* q;        // (n_cells, qrows, d)
  const void* db;        // (n_lists, cap, d) f32 or bf16
  const float* yn;       // (n_lists, capp): the pre-pass's norms / NaN
  const uint8_t* live;   // (n_lists, capp / 128): the pre-pass's flags
  const int* live_rows;  // (n_cells,): rows scanned per cell, or nullptr
  float* out_d;          // (n_cells, qrows, k)
  int* out_i;
  // kp: d rounded up to BK; vec: bytes a copy of the store's pieces.
  int n_cells, qrows, cap, capp, d, kp, k, l2, vec;
};

// x rounded to TF32, nearest with ties away from zero: its bits, the low
// 13 zero. For a finite x this is cvt.rna.tf32.f32, done with two integer
// operations: half the dropped range added to the magnitude, then the
// dropped bits cleared.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (below 2^-22 of |x|): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d = a * b + c over one m16n8k8 tile: tf32 operands, f32 accumulators.
// a0..a3: (row g, k slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b0,
// b1: (k slot t, n g), (t + 4, g); with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_1688(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

template <int BQ>
using Acc = float[Geo<BQ>::MT][Geo<BQ>::NT8][4];

// acc += the gram of this warp's rows of the resident query block Qs (f32,
// row stride SA, at the chunk's first feature) and its columns of the
// staged chunk Ys (f32 or, with DB16, bf16 rows of stride SR), as three
// TF32 products a fragment, the small terms first (two for bf16 rows,
// whose lo is 0). Each 8-feature step's products go into a fresh partial
// sum, then into acc with an f32 add. The k slots of a step take its
// features in pairs: slot t feature 2t and slot t + 4 feature 2t + 1 (the
// same map for both operands, so the sum is the same), so a fragment's
// two features are one load.
template <int BQ, bool DB16>
__device__ __forceinline__ void mma_chunk(Acc<BQ>& acc, const float* Qs,
                                          int SA, const void* Ys, int wm0,
                                          int wn0) {
  using G = Geo<BQ>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qa = Qs + (wm0 + g) * SA + 2 * t;
  const float* yf = static_cast<const float*>(Ys) + (wn0 + g) * SR + 2 * t;
  const unsigned short* yh =
      static_cast<const unsigned short*>(Ys) + (wn0 + g) * SR + 2 * t;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned ah[G::MT][4], al[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const float2 x02 =
          *reinterpret_cast<const float2*>(qa + mt * 16 * SA + kk);
      const float2 x13 =
          *reinterpret_cast<const float2*>(qa + (mt * 16 + 8) * SA + kk);
      split(x02.x, ah[mt][0], al[mt][0]);
      split(x13.x, ah[mt][1], al[mt][1]);
      split(x02.y, ah[mt][2], al[mt][2]);
      split(x13.y, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
      float p[4];
      if constexpr (DB16) {
        // Two bf16 features, element 2t in the low half: widened, each is
        // its own TF32 value.
        const unsigned w =
            *reinterpret_cast<const unsigned*>(yh + nt * 8 * SR + kk);
        const unsigned bh0 = w << 16, bh1 = w & 0xffff0000u;
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_1688(p, al[mt], bh0, bh1, zero);
          mma_1688(p, ah[mt], bh0, bh1, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      } else {
        const float2 y01 =
            *reinterpret_cast<const float2*>(yf + nt * 8 * SR + kk);
        unsigned bh0, bl0, bh1, bl1;
        split(y01.x, bh0, bl0);
        split(y01.y, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_1688(p, al[mt], bh0, bh1, zero);
          mma_1688(p, ah[mt], bl0, bl1, p);
          mma_1688(p, ah[mt], bh0, bh1, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }
  }
}

// Copy features [c0, c0 + BK) of tile t's rows (slots t * BN + [0, BN)
// below cap) of a list whose rows start at `rows` (row length d, elements
// of T) into s (BN rows of stride SR): pieces of VEC bytes, this thread's
// u = tid, tid + NT, ... (row u / PER); zero past cap and d (d is a
// multiple of a piece's elements). 2-byte pieces by plain loads.
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(T* s, const T* rows, int t,
                                           int cap, int c0, int d) {
  constexpr int E = VEC / (int)sizeof(T), PER = BK / E, P = BN * PER;
  static_assert(P % NT == 0, "whole pieces a thread");
#pragma unroll
  for (int i = 0; i < P / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    const int r = u / PER, c = (u % PER) * E;
    const int slot = t * BN + r;
    const bool in = slot < cap && c0 + c < d;
    const T* src = in ? rows + (size_t)slot * d + c0 + c : rows;
    T* dst = s + r * SR + c;
    if constexpr (VEC == 16)
      knn_gemm::cp_async16(reinterpret_cast<float*>(dst),
                           reinterpret_cast<const float*>(src), in ? 16 : 0);
    else if constexpr (VEC == 8)
      knn_gemm::cp_async8(dst, src, in ? 8 : 0);
    else if constexpr (VEC == 4)
      knn_gemm::cp_async4(reinterpret_cast<float*>(dst),
                          reinterpret_cast<const float*>(src), in ? 4 : 0);
    else
      *reinterpret_cast<unsigned short*>(dst) =
          in ? *reinterpret_cast<const unsigned short*>(src) : 0;
  }
}

// Stage chunk c0 of tile t into ring slot s, in the pieces `vec` says.
template <bool DB16>
__device__ __forceinline__ void stage(void* s, const void* rows, int t,
                                      int cap, int c0, int d, int vec) {
  if constexpr (DB16) {
    unsigned short* sh = static_cast<unsigned short*>(s);
    const unsigned short* rh = static_cast<const unsigned short*>(rows);
    if (vec == 16)
      stage_rows<unsigned short, 16>(sh, rh, t, cap, c0, d);
    else if (vec == 8)
      stage_rows<unsigned short, 8>(sh, rh, t, cap, c0, d);
    else if (vec == 4)
      stage_rows<unsigned short, 4>(sh, rh, t, cap, c0, d);
    else
      stage_rows<unsigned short, 2>(sh, rh, t, cap, c0, d);
  } else {
    float* sf = static_cast<float*>(s);
    const float* rf = static_cast<const float*>(rows);
    if (vec == 16)
      stage_rows<float, 16>(sf, rf, t, cap, c0, d);
    else
      stage_rows<float, 4>(sf, rf, t, cap, c0, d);
  }
}

// One CTA: query rows [q0, q0 + BQ) of cell blockIdx.x / ceil(qrows / BQ)
// against the live tiles of its list, chunk by chunk. With live_rows, rows
// of cell c at or past live_rows[c] are not scanned and report (inf, -1).
// One instance per store type and selection path, so the merge's
// registers do not crowd the others: two CTAs share an SM except on the
// merge path.
template <int BQ, bool DB16, int SEL>
__global__ void __launch_bounds__(NT, SEL == SEL_MERGE ? 1 : 2)
    b2_tf32_kernel(const Args a) {
  using G = Geo<BQ>;
  constexpr bool K1 = SEL == SEL_MIN;
  constexpr int ES = DB16 ? 2 : 4;  // bytes a store element
  extern __shared__ __align__(16) char smem[];
  const int k = K1 ? 1 : a.k;
  const Layout lay(BQ, a.kp, DB16, k);
  float* A = reinterpret_cast<float*>(smem + lay.A);
  char* ring = smem + lay.ring;
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
  float* yn = reinterpret_cast<float*>(smem + lay.yn);
  int* ok = reinterpret_cast<int*>(smem + lay.ok);
  float* red_d = reinterpret_cast<float*>(smem + lay.red);
  int* red_i = reinterpret_cast<int*>(smem + lay.red) + G::WARPS_N * BQ;
  const cell_select::Queues qs{
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
  const int SA = a.kp + 8;
  const bool l2 = a.l2 != 0;
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
  const int ntiles = a.capp / BN, nchunk = a.kp / BK;
  const uint8_t* live = a.live + (size_t)list * ntiles;
  const float* yn_g = a.yn + (size_t)list * a.capp;
  const char* lrows =
      static_cast<const char*>(a.db) + (size_t)list * a.cap * a.d * ES;

  // Step j is chunk c of live tile `tile`; its rows land in ring slot
  // j % STAGES. Every issue commits one copy group, empty or not.
  struct Pos {
    int tile, c, j;
  };
  auto step = [&](Pos& p) {
    ++p.j;
    if (++p.c == nchunk) {
      p.c = 0;
      p.tile = cell_select::next_live(live, p.tile, ntiles);
    }
  };
  auto issue = [&](const Pos& p) {
    if (p.tile < ntiles)
      stage<DB16>(ring + (size_t)(p.j % STAGES) * BN * SR * ES, lrows,
                  p.tile, a.cap, p.c * BK, a.d, a.vec);
    knn_gemm::cp_commit();
  };

  Pos cur{cell_select::next_live(live, -1, ntiles), 0, 0};
  Pos fill = cur;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    issue(fill);
    step(fill);
  }

  // While the first chunk lands: the resident f32 query block (zero past
  // nq and d) and the f32 norms of its rows; warp w takes rows w, w + 8,
  // ..., whose loads are in flight together.
  {
    const float* qb = a.q + row0 * a.d;
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
        A[(warp + i * NW) * SA + c] = v[i];
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
      qs.kd[j] = INFINITY;
      qs.ki[j] = NONE;
    }
    for (int j = tid; j < BQ; j += NT) qs.cnt[j] = 0;
    for (int j = tid; j < (BQ + 31) / 32; j += NT) qs.qmask[j] = 0;
  }
  float bd[2 * G::MT];
  int bi[2 * G::MT];
#pragma unroll
  for (int i = 0; i < 2 * G::MT; ++i) {
    bd[i] = INFINITY;
    bi[i] = NONE;
  }

  Acc<BQ> acc;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  int mb = 0, n_done = 0;  // the tile's metadata buffer, tiles selected
  bool pending = false;    // candidates wait for a drain (k <= NET_K)
  while (cur.tile < ntiles) {
    // This thread's copies of step j have landed; on a tile's first chunk
    // also its slot metadata into buffer mb: for k = 1 fold_min's yo (the
    // norm, 0 for inner product, +inf for an invalid slot), else the norms
    // and valid flags of select_tile.
    knn_gemm::cp_wait<STAGES - 2>();
    if (cur.c == 0 && tid < BN) {
      const float y = yn_g[cur.tile * BN + tid];
      const bool v = !isnan(y);
      if (K1) {
        yn[mb * BN + tid] = v ? (l2 ? y : 0.f) : INFINITY;
      } else {
        ok[mb * BN + tid] = v;
        yn[mb * BN + tid] = v ? y : 0.f;
      }
    }
    // Every thread's copies (and the query block) are visible, and every
    // warp is past step j - 1: refill its slot.
    __syncthreads();
    issue(fill);
    step(fill);
    mma_chunk<BQ, DB16>(acc, A + cur.c * BK, SA,
                        ring + (size_t)(cur.j % STAGES) * BN * SR * ES, wm0,
                        wn0);
    if (cur.c == nchunk - 1) {
      const int t0 = cur.tile * BN;
      if (K1) {
        if (l2)
          fold_min<BQ, BN, true>(acc, bd, bi, qn, yn + mb * BN, t0, wm0, wn0);
        else
          fold_min<BQ, BN, false>(acc, bd, bi, qn, yn + mb * BN, t0, wm0,
                                  wn0);
      } else {
        // The network drains on the 1st, 2nd, 4th, 8th, ... live tile
        // (and whenever a buffer fills): in between, candidates pile up
        // against the last drained k-th, an upper bound of the row's k-th.
        ++n_done;
        select_tile<BQ, SEL, CN, true>(
            acc, bd, bi, qn, qs, yn + mb * BN, ok + mb * BN, cur.tile, nq, k,
            l2, wm0, wn0, n_done == 1, (n_done & (n_done - 1)) == 0,
            &pending);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      mb ^= 1;
    }
    step(cur);
  }
  // The queues' initial state is visible even when no tile was live.
  knn_gemm::cp_wait<0>();
  __syncthreads();
  if (SEL == SEL_NET && pending) {
    cell_select::drain_network<BQ, CN / BQ>(qs, nq, k);
    __syncthreads();
  }
  write_rows<BQ, K1>(bd, bi, red_d, red_i, qs.kd, qs.ki, nq, k, wm0, od, oi);
}

template <int BQ, bool DB16, int SEL>
cudaError_t run_scan(const Args& a, size_t bytes, cudaStream_t st) {
  auto kern = b2_tf32_kernel<BQ, DB16, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  const long long grid = (long long)a.n_cells * ((a.qrows + BQ - 1) / BQ);
  kern<<<(unsigned)grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ, bool DB16>
cudaError_t scan_sel(const Args& a, size_t bytes, cudaStream_t st) {
  if (a.k == 1) return run_scan<BQ, DB16, SEL_MIN>(a, bytes, st);
  if (a.k <= NET_K) return run_scan<BQ, DB16, SEL_NET>(a, bytes, st);
  return run_scan<BQ, DB16, SEL_MERGE>(a, bytes, st);
}

template <bool DB16>
cudaError_t scan(const Args& a, int bq, size_t bytes, cudaStream_t st) {
  if (bq == 64) return scan_sel<64, DB16>(a, bytes, st);
  if (bq == 32) return scan_sel<32, DB16>(a, bytes, st);
  return scan_sel<16, DB16>(a, bytes, st);
}

// Bytes a copy of the store's pieces: the widest that d and the store's
// alignment allow (f32: 16 or 4; bf16: 16, 8, 4 or 2, the last by plain
// loads).
int piece_bytes(bool db16, int d, uintptr_t da) {
  const int es = db16 ? 2 : 4;
  const auto fits = [&](int bytes) {
    return d % (bytes / es) == 0 && da % bytes == 0;
  };
  if (fits(16)) return 16;
  if (db16 && fits(8)) return 8;
  if (fits(4)) return 4;
  return es;
}

}  // namespace

extern "C" {

// One call of B2's f32 tier: the pre-pass into yn (n_lists, capp) and
// live (n_lists, capp / 128), capp = cap rounded up to 128, then the scan
// on the plan of ops/fused_knn.py::_b2_tf32_plan (bq query rows per CTA,
// smem bytes, which must equal this file's Layout). db is f32, or bf16
// with db_is_bf16. live_rows (n_cells,), or nullptr for every row: rows of
// cell c at or past live_rows[c] are not scanned and report (inf, -1)
// (B3's bucket callers fill each bucket from slot 0 upward). Operands need
// only their element alignment. Returns the first launch error.
int fused_cells_tf32_launch(const int* cell_list, const float* q,
                            const void* db, int db_is_bf16,
                            const uint8_t* invalid, const int* live_rows,
                            float* yn, uint8_t* live, float* out_d,
                            int* out_i, int n_cells, int n_lists, int qrows,
                            int cap, int d, int k, int l2, int bq, int smem,
                            void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  const int capp = (cap + BN - 1) / BN * BN;
  const int kp = (d + BK - 1) / BK * BK;
  const bool db16 = db_is_bf16 != 0;
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || n_lists < 1 ||
      n_lists > 65535 || !(bq == 16 || bq == 32 || bq == 64) ||
      (long long)n_cells * ((qrows + bq - 1) / bq) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout lay(bq, kp, db16, k);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cell_norms::launch(
      db, db16 ? cell_norms::KIND_BF16 : cell_norms::KIND_F32, invalid, yn,
      live, n_lists, cap, capp, d, l2, st);
  if (err != cudaSuccess) return (int)err;
  const Args a{cell_list, q, db, yn, live, live_rows, out_d, out_i, n_cells,
               qrows, cap, capp, d, kp, k, l2,
               piece_bytes(db16, d, reinterpret_cast<uintptr_t>(db))};
  err = db16 ? scan<true>(a, bq, lay.total, st)
             : scan<false>(a, bq, lay.total, st);
  return (int)err;
}

}  // extern "C"
