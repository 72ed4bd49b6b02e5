// B1's f32 tier for Hopper (sm_90a): the exact kNN, and with k = 1 the
// k-means assignment, on TF32 tensor cores (mma.sync) with the 3xTF32
// split.
//
// Replaces raft_tpu/ops/fused_knn.py::_fused_knn / _fused_knn_kernel
// (pallas_call at :179) on its f32 tier, which the Pallas kernel computes
// as one f32 MXU product at Precision.HIGHEST. The function (ops/
// fused_knn.py::_fused_knn_plain without bf16): the f32 gram g = sum q * y;
// max(|q|^2 + |y|^2 - 2g, 0) for L2 with f32 norms of the rows, or -g for
// inner product; the top-k by (distance, id), ties to the lowest id, inf
// slots as id -1.
//
// The split, and why it keeps that parity. One TF32 product (11
// significant bits an operand) is far too coarse for an f32 gram. Each
// operand x is split into hi = tf32(x) (cvt.rna: nearest, ties away) and
// lo = tf32(x - hi), and the gram is the sum of three TF32 products, the
// small terms first: lo(q) hi(y), hi(q) lo(y), hi(q) hi(y). hi + lo holds
// x to 2^-22 of |x|, and the dropped lo(q) lo(y) is below 2^-22 of |q y|;
// each product of two 11-bit values is exact in the tensor core. Its f32
// sums are rounded toward zero, though: chained over the 3d / 8 products
// of a pair they put the gram at 2-10x the plain version's error against
// float64 (on an H100) and bias it low. A fresh partial sum for each
// 32-feature chunk brought the largest error to 0.3-0.97x the plain
// version's (tools/tune_b1.py's f64_ratio, Gaussian rows and the main
// path's blobs at d 128 and 1024) but kept a bias of about 2.6 ulps of g:
// the inertia of chip_smoke.py's Lloyd fit (1M x 1000 x 128) came out
// 1.42e-5 above float64's, past its bar of 1e-5. So each 8-feature step's
// three products go into a fresh partial sum that an f32 add (round to
// nearest) takes into the accumulators; the same emulation of the
// rounding that had predicted 1.55e-5 (tests/test_torch_fused_knn_tf32.py)
// puts this at 2.9e-6. Integers below 2^11 have lo = 0 and exact
// products, so on integer data the result is the plain version's bit for
// bit.
//
// What bounds it on the H100: 2 * d operations per (query, row) pair, three
// times, at the dense TF32 tensor-core rate, against the f32 bytes of the
// queries and rows read once. At the brute-force shape (10,000 x 1M x 128)
// that is 15.5 ms (the FP32 FMA pipes' bound is 38.2 ms); a request of a
// few rows against the 1M rows is bound by the 512 MB of rows (0.153 ms).
// mma.sync reaches part of the TF32 peak (wgmma, the rest, is ROADMAP
// B.1a'); the split's integer work shares its issue slots. What the design
// does:
//
//   * where it splits: in registers. Both operands are staged in f32
//     straight from the caller's tensors: 32-feature chunks (four k8
//     steps) of BQ query rows and TBN database rows land by cp.async
//     (16-byte copies when d % 4 == 0 and the operand starts on 16 bytes,
//     else 4-byte ones; zero past m, the slice and d) in a ring of STAGES
//     buffers, one chunk ahead of the one being multiplied. Each warp loads
//     its m16n8k8 fragments with 8-byte shared loads (the k slots of a step
//     take its features in pairs, see mma_chunk; a row stride of BK + 8
//     floats keeps them free of bank conflicts) and splits them with
//     integer operations. A pre-pass writing hi and lo planes of the rows
//     would triple the bytes a few-row request reads and need a workspace
//     that grows with the database; ldmatrix moves 16-bit elements and
//     serves a tf32 fragment only untransposed; splitting the query block
//     once into shared hi / lo planes, as the bf16 tiers round theirs, ran
//     slower (111.6 ms at the brute-force shape, k = 10, where the
//     register split took 89.8-90.6 in the runs before and after);
//   * one CTA of 256 threads owns BQ query rows and sweeps the tiles of
//     TBN database rows of its slice: 64 x 128 (at k > 1 also 32 or 16
//     rows, by the queue's room and m), or at k = 1 128 x 64 / 128 x 32
//     when n is that small, so that a 32-center assignment does not pay
//     for 128 slots. (When a 32-feature chunk's partial sums took a second
//     set of accumulators, the bf16 tiers' 128 x 128 k = 1 tile needed
//     more than the 128 registers of two CTAs an SM, and spilled; with a
//     step's partial it is untried.) Two CTAs share an SM up to k = 16
//     (the shared memory of two fits with 2048 candidate slots; one CTA an
//     SM took 80.6 ms against 65.4 at the brute-force shape, k = 10), one
//     above. 8 warps tile the block as mma_tile.cuh's Geo says, with its accumulator layout (the m16n8k8 tf32 C fragment is
//     the m16n8k16 one);
//   * the norms come from B1's pre-pass (knn_gemm.cuh's b1_norms_kernel:
//     f32 from the unrounded values, one warp a row), once per call;
//   * selection at k = 1 is mma_tile.cuh's fold_min, at k > 1 its
//     select_tile: the register filter, then cell_select.cuh's insertion
//     network for k <= 16, drained on the 1st, 2nd, 4th, ... tile of a
//     slice or when a row's buffer fills (B2's schedule), and warp merges
//     above, drained on every tile;
//   * the grid is (query blocks, database slices): when the query blocks
//     alone cannot fill the card, each slice sweeps whole 128-row tiles
//     and writes its sorted top-k to a workspace that B1's
//     b1_merge_kernel merges by (distance, id). The per-pair arithmetic
//     does not depend on the slice, so the result is the one sweep's.
//
// The queries are staged again for each tile (from L2 after the first); a
// query block resident across the tiles, and wgmma with TMA, are the
// levers left (ROADMAP B.1a').

#include "knn_gemm.cuh"  // cp.async with zero fill, B1's pre-pass and merge
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int BK = 32;      // features per staged chunk: four k8 steps
constexpr int STAGES = 2;   // staged chunks in flight
constexpr int SF = BK + 8;  // f32 row stride of a staged chunk (160 bytes)
constexpr int CN = 2048;    // candidate slots per CTA (CN / BQ a row)
constexpr int PR = BK / 4;  // 16-byte pieces of a staged row

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b1_tf32_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t sq, sy, yn, qn, red, ok, kd, ki, cd, ci, cnt, qmask, tm, thr;
  size_t total;
  __host__ __device__ Layout(int bq, int bn, int k) {
    const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
    size_t at = 0;
    sq = take(at, (size_t)STAGES * bq * SF * 4);
    sy = take(at, (size_t)STAGES * bn * SF * 4);
    yn = take(at, (size_t)2 * bn * 4);
    qn = take(at, (size_t)bq * 4);
    red = ok = kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k == 1) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else {
      ok = take(at, (size_t)2 * bn * 4);
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

template <int BQ, int TBN>
using Acc = float[Geo<BQ, TBN>::MT][Geo<BQ, TBN>::NT8][4];

// acc += the staged chunk's gram of this warp's rows of Qs and columns of
// Ys (both f32, row stride SF), as three TF32 products a fragment, the
// small terms first. Each 8-feature step's three products go into a fresh
// partial sum, which is then added to acc with an f32 add: the tensor
// core rounds its f32 sums toward zero, so a partial that carried a
// pair's sum across steps would lose up to an ulp of that sum at each
// product, always in the same direction. The k slots of a step take its
// features in pairs: slot t feature 2t and slot t + 4 feature 2t + 1 (the
// same map for both operands, so the sum is the same), so a fragment's two
// features are one 8-byte load.
template <int BQ, int TBN>
__device__ __forceinline__ void mma_chunk(Acc<BQ, TBN>& acc, const float* Qs,
                                          const float* Ys, int wm0, int wn0) {
  using G = Geo<BQ, TBN>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qa = Qs + (wm0 + g) * SF + 2 * t;
  const float* yb = Ys + (wn0 + g) * SF + 2 * t;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned ah[G::MT][4], al[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const float2 x02 =
          *reinterpret_cast<const float2*>(qa + mt * 16 * SF + kk);
      const float2 x13 =
          *reinterpret_cast<const float2*>(qa + (mt * 16 + 8) * SF + kk);
      split(x02.x, ah[mt][0], al[mt][0]);
      split(x13.x, ah[mt][1], al[mt][1]);
      split(x02.y, ah[mt][2], al[mt][2]);
      split(x13.y, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
      const float2 y01 =
          *reinterpret_cast<const float2*>(yb + nt * 8 * SF + kk);
      unsigned bh0, bl0, bh1, bl1;
      split(y01.x, bh0, bl0);
      split(y01.y, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        float p[4];
        mma_1688(p, al[mt], bh0, bh1, zero);
        mma_1688(p, ah[mt], bl0, bl1, p);
        mma_1688(p, ah[mt], bh0, bh1, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
      }
    }
  }
}

// Copy features [c0, c0 + BK) of rows r0 + [0, R) of x (row length d) into
// s (R rows of stride SF): 16-byte pieces, this thread's u = tid, tid + NT,
// ... (row u / PR, features 4 * (u % PR) on); zero at rows from `end` on
// and past d. 16-byte copies with `vec`, else 4-byte ones.
template <int R>
__device__ __forceinline__ void stage_rows(float* s, const float* x, int r0,
                                           int end, int c0, int d, bool vec) {
  constexpr int P = R * PR;
#pragma unroll
  for (int i = 0; i < (P + NT - 1) / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    if (P % NT != 0 && u >= P) break;
    const int r = r0 + u / PR, c = c0 + 4 * (u % PR);
    const bool row_ok = r < end;
    const float* g = x + (size_t)(row_ok ? r : 0) * d;
    float* dst = s + (u / PR) * SF + 4 * (u % PR);
    if (vec) {
      const bool in = row_ok && c < d;
      knn_gemm::cp_async16(dst, in ? g + c : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = row_ok && c + e < d;
        knn_gemm::cp_async4(dst + e, in ? g + c + e : x, in ? 4 : 0);
      }
    }
  }
}

struct Args {
  const float* q;   // (m, d) f32
  const float* db;  // (n, d) f32
  const float* qn;  // (m,): the queries' norms (L2)
  const float* yn;  // (n,): the rows' norms (L2)
  float* out_d;     // (slices, m, k)
  int* out_i;
  int m, n, d, k, l2, slice_rows, qvec, dvec;
};

// One CTA: query rows [q0, q0 + BQ) against database slice blockIdx.y,
// rows [r0, r1), in tiles of TBN rows. Writes the slice's top-k, ascending
// by (distance, id), to out + (blockIdx.y * m + query) * k, ids of empty
// or inf slots as -1 (the slice merge reports them so too).
template <int BQ, int TBN, int SEL>
__global__ void __launch_bounds__(NT, SEL == SEL_MERGE ? 1 : 2)
    b1_tf32_kernel(const Args a) {
  using G = Geo<BQ, TBN>;
  constexpr bool K1 = SEL == SEL_MIN;
  extern __shared__ __align__(16) char smem[];
  const int k = K1 ? 1 : a.k;
  const Layout lay(BQ, TBN, k);
  float* sq = reinterpret_cast<float*>(smem + lay.sq);
  float* sy = reinterpret_cast<float*>(smem + lay.sy);
  float* yn = reinterpret_cast<float*>(smem + lay.yn);
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
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

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm0 = (warp / G::WARPS_N) * G::WM;
  const int wn0 = (warp % G::WARPS_N) * G::WN;
  const bool l2 = a.l2 != 0;
  const int q0 = blockIdx.x * BQ, nq = min(BQ, a.m - q0);
  const int r0 = blockIdx.y * a.slice_rows;
  const int r1 = min(a.n, r0 + a.slice_rows);
  const int nchunk = (a.d + BK - 1) / BK;
  const int total = (r1 - r0 + TBN - 1) / TBN * nchunk;

  // Chunk j is tile j / nchunk at features (j % nchunk) * BK; Pos steps
  // through j, tile and chunk without a division. Its query rows and
  // database rows land in ring slot j % STAGES. Every call commits one
  // copy group, empty or not.
  struct Pos {
    int j, tile, c;
  };
  auto step = [&](Pos& p) {
    ++p.j;
    if (++p.c == nchunk) {
      p.c = 0;
      ++p.tile;
    }
  };
  auto issue = [&](const Pos& p) {
    if (p.j < total) {
      const int st = p.j % STAGES, c0 = p.c * BK;
      stage_rows<BQ>(sq + st * BQ * SF, a.q, q0, a.m, c0, a.d, a.qvec);
      stage_rows<TBN>(sy + st * TBN * SF, a.db, r0 + p.tile * TBN, r1, c0,
                      a.d, a.dvec);
    }
    knn_gemm::cp_commit();
  };
  float bd[2 * G::MT];
  int bi[2 * G::MT];
#pragma unroll
  for (int i = 0; i < 2 * G::MT; ++i) {
    bd[i] = INFINITY;
    bi[i] = NONE;
  }
  if (!K1) {
    for (int j = tid; j < BQ * k; j += NT) {
      qs.kd[j] = INFINITY;
      qs.ki[j] = NONE;
    }
    for (int j = tid; j < BQ; j += NT) qs.cnt[j] = 0;
    for (int j = tid; j < (BQ + 31) / 32; j += NT) qs.qmask[j] = 0;
  }
  for (int j = tid; j < BQ; j += NT) qn[j] = l2 && j < nq ? a.qn[q0 + j] : 0.f;

  Pos cur{0, 0, 0}, fill{0, 0, 0};  // the chunk multiplied, the one copied
  bool pending = false;  // candidates wait for a drain (k <= NET_K)
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    issue(fill);
    step(fill);
  }
  Acc<BQ, TBN> acc;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  while (cur.j < total) {
    // This thread's copies of chunk j have landed; on a tile's first chunk
    // also its row norms and valid flags (buffer tile % 2).
    knn_gemm::cp_wait<STAGES - 2>();
    if (cur.c == 0 && tid < TBN) {
      const int id = r0 + cur.tile * TBN + tid;
      const bool v = id < r1;
      const int at = (cur.tile & 1) * TBN + tid;
      if (K1)
        yn[at] = !v ? INFINITY : l2 ? a.yn[id] : 0.f;
      else {
        ok[at] = v;
        yn[at] = (l2 && v) ? a.yn[id] : 0.f;
      }
    }
    // Every thread's copies are visible, and every warp is past chunk
    // j - 1: refill its slot.
    __syncthreads();
    issue(fill);
    step(fill);
    const int st = cur.j % STAGES;
    mma_chunk<BQ, TBN>(acc, sq + st * BQ * SF, sy + st * TBN * SF, wm0, wn0);
    if (cur.c == nchunk - 1) {
      const int mb = (cur.tile & 1) * TBN, t0 = r0 + cur.tile * TBN;
      if constexpr (!K1) {
        // For k <= NET_K the network drains on the 1st, 2nd, 4th, 8th, ...
        // tile (and whenever a buffer fills): in between, candidates pile
        // up against the last drained k-th, an upper bound of the row's.
        const int done = cur.tile + 1;
        select_tile<BQ, SEL, CN, true, TBN>(
            acc, bd, bi, qn, qs, yn + mb, ok + mb, t0 / TBN, nq, k, l2, wm0,
            wn0, done == 1, (done & (done - 1)) == 0, &pending);
      } else if (l2) {
        fold_min<BQ, TBN, true>(acc, bd, bi, qn, yn + mb, t0, wm0, wn0);
      } else {
        fold_min<BQ, TBN, false>(acc, bd, bi, qn, yn + mb, t0, wm0, wn0);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    step(cur);
  }
  knn_gemm::cp_wait<0>();
  if (SEL == SEL_NET && pending) {
    cell_select::drain_network<BQ, CN / BQ>(qs, nq, k);
    __syncthreads();
  }
  float* od = a.out_d + ((size_t)blockIdx.y * a.m + q0) * k;
  int* oi = a.out_i + ((size_t)blockIdx.y * a.m + q0) * k;
  write_rows<BQ, K1>(bd, bi, red_d, red_i, qs.kd, qs.ki, nq, k, wm0, od,
                     oi);
}

template <int BQ, int TBN, int SEL>
cudaError_t run_scan(const Args& a, dim3 grid, size_t bytes,
                     cudaStream_t st) {
  auto kern = b1_tf32_kernel<BQ, TBN, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  kern<<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t scan_sel(const Args& a, dim3 grid, size_t bytes,
                     cudaStream_t st) {
  if (a.k <= NET_K) return run_scan<BQ, BN, SEL_NET>(a, grid, bytes, st);
  return run_scan<BQ, BN, SEL_MERGE>(a, grid, bytes, st);
}

cudaError_t scan(const Args& a, int bq, int bn, dim3 grid, size_t bytes,
                 cudaStream_t st) {
  if (a.k == 1) {
    if (bn == 32) return run_scan<128, 32, SEL_MIN>(a, grid, bytes, st);
    if (bn == 64) return run_scan<128, 64, SEL_MIN>(a, grid, bytes, st);
    return run_scan<64, BN, SEL_MIN>(a, grid, bytes, st);
  }
  if (bq == 64) return scan_sel<64>(a, grid, bytes, st);
  if (bq == 32) return scan_sel<32>(a, grid, bytes, st);
  return scan_sel<16>(a, grid, bytes, st);
}

}  // namespace

extern "C" {

// B1's f32 tier: the norm pre-pass (L2 only) into norms[0, m + n), the
// scan of ceil(m / bq) query blocks x n_slices database slices of
// slice_rows rows (a multiple of 128) in tiles of bn rows, and with
// n_slices > 1 the merge of the slice lists ws_d / ws_i (n_slices, m, k)
// into out_d / out_i (m, k). The plan is ops/fused_knn.py::_b1_tf32_plan's:
// bq x bn = 128 x 32, 128 x 64 or 64 x 128 at k = 1, else bq in {16, 32,
// 64} and bn = 128; smem must equal this file's Layout. q and db need only 4-byte
// alignment: an operand's copies take 16 bytes when d % 4 == 0 and it
// starts on 16 bytes. Returns the first launch error.
int fused_knn_tf32_launch(const float* q, const float* db, float* norms,
                          float* ws_d, int* ws_i, float* out_d, int* out_i,
                          int m, int n, int d, int k, int l2, int bq, int bn,
                          int slice_rows, int n_slices, int smem,
                          void* stream) {
  if (m <= 0) return 0;
  const bool tile_ok =
      k == 1 ? (bq == 128 && (bn == 32 || bn == 64)) || (bq == 64 && bn == BN)
             : bn == BN && (bq == 16 || bq == 32 || bq == 64);
  if (k < 1 || k > KMAX || n < 1 || d < 1 || n_slices < 1 ||
      n_slices > knn_gemm::MAX_SLICES || slice_rows % BN != 0 ||
      (size_t)(n_slices - 1) * slice_rows >= (size_t)n ||
      (size_t)n_slices * slice_rows < (size_t)n || !tile_ok)
    return (int)cudaErrorInvalidValue;
  const Layout lay(bq, bn, k);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool qa = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const bool da = (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  const int qvec = d % 4 == 0 && qa, dvec = d % 4 == 0 && da;
  if (l2) {
    constexpr int NTH = knn_gemm::NORMS_THREADS, RPB = NTH / 32;
    const long long rows = (long long)m + n;
    knn_gemm::b1_norms_kernel<<<(unsigned)((rows + RPB - 1) / RPB), NTH, 0,
                                st>>>(q, db, norms, m, n, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool direct = n_slices == 1;
  const Args a{q, db, l2 ? norms : nullptr, l2 ? norms + m : nullptr,
               direct ? out_d : ws_d, direct ? out_i : ws_i, m, n, d, k, l2,
               slice_rows, qvec, dvec};
  const dim3 grid((m + bq - 1) / bq, n_slices);
  cudaError_t err = scan(a, bq, bn, grid, lay.total, st);
  if (err != cudaSuccess || direct) return (int)err;
  constexpr int W = knn_gemm::MERGE_WARPS;
  knn_gemm::b1_merge_kernel<<<(m + W - 1) / W, W * 32, 0, st>>>(
      ws_d, ws_i, out_d, out_i, m, k, n_slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
