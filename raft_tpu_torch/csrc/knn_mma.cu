// B1's bf16 tiers for Hopper (sm_90a): the exact kNN, and with k = 1 the
// k-means assignment, on bf16 tensor cores (mma.sync).
//
// Replaces raft_tpu/ops/fused_knn.py::_fused_knn / _fused_knn_kernel
// (pallas_call at :179) on its two bf16 tiers, which the Pallas kernel
// computes as bf16 MXU products with f32 accumulation: dot(qh, yc), plus
// dot(ql, yc) with the split query. The function (ops/fused_knn.py::
// _fused_knn_plain with bf16): g = sum bf16(q) * bf16(y), plus sum
// bf16(q - bf16(q)) * bf16(y) with qsplit, f32 sums; max(|q|^2 + |y|^2 -
// 2g, 0) for L2 with f32 norms of the unrounded rows, or -g for inner
// product; the top-k by (distance, id), ties to the lowest id, inf slots
// as id -1. The f32 tier stays on the FMA scan of knn_gemm.cuh
// (fused_knn.cu): TF32 would break its parity with the reference's
// Precision.HIGHEST.
//
// What bounds it on the H100: 2 * d operations per (query, row) pair at
// the bf16 tensor-core rate, twice with qsplit (the lo half is a second
// product), against the f32 bytes of the queries and rows read once. The
// k-means assignments are its main callers: many rows against few centers
// (32 to ~1000). At 1M x 1000 x 128 one product is 0.26 ms at the dense
// bf16 peak; 500k x 32 x 128 is bound by its bytes (0.078 ms, every f32 row
// read once). mma.sync reaches part of that peak (wgmma, the rest, is the
// next lever). What the design does:
//
//   * one CTA of 256 threads owns BQ query rows (128 at k = 1; 64, 32 or
//     16 at k > 1, by the queue's room and m) and sweeps the tiles of TBN
//     database rows of its slice: 128, or 64 / 32 when n is that small,
//     so that a 32-center assignment does not pay for 128 slots;
//   * a pre-pass (b1_mma_rows_kernel, one warp per row) rounds the
//     database rows to bf16 once, into a workspace padded with zeros to
//     whole chunks, with their f32 norms from the unrounded values.
//     The scan then copies bf16 rows straight into its operand tiles and
//     reads half the bytes of f32 rows; every CTA would otherwise round
//     the same centers again;
//   * features come in chunks of BK = 16, one k16 step. Each chunk's f32
//     query rows land by 16-byte cp.async copies (4-byte ones unless d %
//     4 == 0 and q starts on 16 bytes) in a ring of STAGES staging
//     buffers, and its bf16 rows by 16-byte copies in a ring of STAGES row
//     tiles, zero past m, the slice and d, up to three chunks ahead of the
//     one being multiplied. Each thread rounds the query pieces it copied
//     itself (so no barrier separates the copy from the move; cvt.rn.
//     bf16x2, two values an instruction) into double-buffered bf16 tiles:
//     the rounded query in A, with qsplit its lo half bf16(q - bf16(q)) in
//     L. One barrier per chunk. The shared memory does not grow with d,
//     so every d takes this scan;
//   * the product is mma_tile.cuh's: ldmatrix fragments, m16n8k16 bf16
//     with f32 accumulators, 8 warps over the BQ x TBN block; qsplit is a
//     second mma of the lo fragment into the same accumulators;
//   * the query norms are summed from the staged f32 chunks of the first
//     tile (each thread its own four features a chunk, then the four
//     threads of a row in a fixed order), so the queries are read from
//     device memory once;
//   * selection at k = 1 is fold_min: a register (min, id) per row, each
//     thread's running minimum taken with fminf and the id looked up only
//     when a tile beats it (mma_tile.cuh's select_tile, which compares
//     every (distance, id) pair, took about half the scan's time at 1M x
//     1000 x 128 on an H100); at k > 1
//     it is select_tile: the register filter and cell_select.cuh's
//     insertion network (k <= 16) or warp merges, drained on every tile;
//   * the grid is (query blocks, database slices): when the query blocks
//     alone cannot fill the card, each slice sweeps whole 128-row tiles
//     and writes its sorted top-k to a workspace that B1's
//     b1_merge_kernel merges by (distance, id). The per-pair arithmetic
//     does not depend on the slice, so the result is the one sweep's.
//
// The queries are staged again for each tile (from L2 after the first);
// a query block resident across the tiles, and wgmma with TMA, are the
// levers left (ROADMAP B.1).

#include "knn_gemm.cuh"  // cp.async with zero fill, b1_merge_kernel
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int BK = 16;      // features per staged chunk: one k16 step
constexpr int STAGES = 4;   // chunks in flight (staged queries, row tiles)
constexpr int SA = BK + 8;  // bf16 operand row stride (48 bytes)

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b1_mma_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t stg, Bt, A, L, yn, ok, qn, red, kd, ki, cd, ci, cnt, qmask, tm, thr;
  size_t total;
  __host__ __device__ Layout(int bq, int bn, int k, bool qsplit) {
    const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
    size_t at = 0;
    stg = take(at, (size_t)STAGES * bq * BK * 4);
    Bt = take(at, (size_t)STAGES * bn * SA * 2);
    A = take(at, (size_t)2 * bq * SA * 2);
    L = take(at, qsplit ? (size_t)2 * bq * SA * 2 : 0);
    yn = take(at, (size_t)2 * bn * 4);
    qn = take(at, (size_t)bq * 4);
    ok = red = kd = ki = cd = ci = cnt = qmask = tm = thr = 0;
    if (k == 1) {
      red = take(at, (size_t)warps_n * bq * 8);
    } else {
      ok = take(at, (size_t)2 * bn * 4);
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

// The database pre-pass: row r's f32 norm (from the unrounded values, if
// l2) into yn[r], and its bf16 copy into ybf[r][0, kp), zero past d. One
// warp per row.
__global__ void b1_mma_rows_kernel(const float* __restrict__ db,
                                   float* __restrict__ yn,
                                   unsigned short* __restrict__ ybf, int n,
                                   int d, int kp, int l2) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  if (r >= n) return;
  const int lane = threadIdx.x & 31;
  const float* x = db + (size_t)r * d;
  unsigned short* o = ybf + (size_t)r * kp;
  float acc = 0.f;
  for (int c = lane; c < kp; c += 32) {
    const float v = c < d ? __ldg(x + c) : 0.f;
    acc = fmaf(v, v, acc);
    o[c] = bf16_bits(v);
  }
  if (!l2) return;
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o2);
  if (lane == 0) yn[r] = acc;
}

struct Args {
  const float* q;               // (m, d) f32
  const unsigned short* ybf;    // (n, kp) the rows rounded to bf16
  const float* yn;              // (n,): the rows' norms (L2)
  float* out_d;                 // (slices, m, k)
  int* out_i;
  int m, n, d, kp, k, l2, slice_rows, vec;
};

// One CTA: query rows [q0, q0 + BQ) against database slice blockIdx.y,
// rows [r0, r1), in tiles of TBN rows. Writes the slice's top-k, ascending
// by (distance, id), to out + (blockIdx.y * m + query) * k, ids of empty
// or inf slots as -1 (the slice merge reports them so too).
template <int BQ, int TBN, bool QSPLIT, int SEL>
__global__ void __launch_bounds__(NT, SEL == SEL_MIN ? 2 : 1)
    b1_mma_kernel(const Args a) {
  using G = Geo<BQ, TBN>;
  constexpr bool K1 = SEL == SEL_MIN;
  constexpr int QR = BK / 4, YR = BK / 8;    // 16-byte pieces of a row
  constexpr int QP = BQ * QR, YP = TBN * YR;  // f32 query, bf16 row pieces
  constexpr int QPT = (QP + NT - 1) / NT, YPT = (YP + NT - 1) / NT;
  static_assert(BK % 16 == 0, "whole k16 steps");
  static_assert(QP % 32 == 0 && YP % 32 == 0,
                "a warp's pieces are all valid or none");
  extern __shared__ __align__(16) char smem[];
  const int k = K1 ? 1 : a.k;
  const Layout lay(BQ, TBN, k, QSPLIT);
  float* stg = reinterpret_cast<float*>(smem + lay.stg);
  unsigned short* Bt = reinterpret_cast<unsigned short*>(smem + lay.Bt);
  unsigned short* A = reinterpret_cast<unsigned short*>(smem + lay.A);
  unsigned short* L = reinterpret_cast<unsigned short*>(smem + lay.L);
  float* yn = reinterpret_cast<float*>(smem + lay.yn);
  int* ok = reinterpret_cast<int*>(smem + lay.ok);
  float* qn = reinterpret_cast<float*>(smem + lay.qn);
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
  const int nchunk = a.kp / BK;
  const int total = (r1 - r0 + TBN - 1) / TBN * nchunk;

  // Chunk j is tile j / nchunk at features c0 = (j % nchunk) * BK; Pos
  // steps through j, tile and chunk without a division. Its f32 query rows
  // land in staging buffer j % STAGES (query piece u = tid + i * NT: row
  // u / QR, features 4 * (u % QR) on), its bf16 rows straight in row tile
  // j % STAGES (row piece v: row v / YR, features 8 * (v % YR) on); zero
  // past m, r1 and d. Every call commits one copy group, empty or not.
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
      const int t0 = r0 + p.tile * TBN, c0 = p.c * BK;
      float* s = stg + (p.j % STAGES) * BQ * BK;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int u = tid + i * NT;
        if (QP % NT != 0 && u >= QP) break;
        const int r = q0 + u / QR, c = c0 + 4 * (u % QR);
        const bool row_ok = r < a.m;
        const float* g = a.q + (size_t)(row_ok ? r : 0) * a.d;
        if (a.vec) {
          const bool in = row_ok && c < a.d;
          knn_gemm::cp_async16(s + 4 * u, in ? g + c : a.q, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = row_ok && c + e < a.d;
            knn_gemm::cp_async4(s + 4 * u + e, in ? g + c + e : a.q,
                                in ? 4 : 0);
          }
        }
      }
      unsigned short* b = Bt + (p.j % STAGES) * TBN * SA;
#pragma unroll
      for (int i = 0; i < YPT; ++i) {
        const int v = tid + i * NT;
        if (YP % NT != 0 && v >= YP) break;
        const int row = v / YR, r = t0 + row, c = c0 + 8 * (v % YR);
        const bool in = r < r1;
        const unsigned short* g = a.ybf + (size_t)(in ? r : 0) * a.kp + c;
        const unsigned dst = mma_bf16::smem_addr(b + row * SA + 8 * (v % YR));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         dst),
                     "l"(g), "r"(in ? 16 : 0));
      }
    }
    knn_gemm::cp_commit();
  };

  // This thread's share of the query norms: its pieces' squares over the
  // first tile's chunks.
  float qsq[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) qsq[i] = 0.f;

  // Move this thread's query pieces of the landed chunk j into operand
  // buffer j % 2, rounded to bf16 (and the lo half with QSPLIT); on a
  // tile's first chunk also the tile's row norms and valid flags (buffer
  // tile % 2), and after the first tile's last chunk the query norms.
  auto convert = [&](const Pos& p) {
    const float* s = stg + (p.j % STAGES) * BQ * BK;
    const int buf = p.j & 1;
    const bool norms = l2 && p.tile == 0;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int u = tid + i * NT;
      if (QP % NT != 0 && u >= QP) break;
      const int at = (buf * BQ + u / QR) * SA + 4 * (u % QR);
      const float4 v = *reinterpret_cast<const float4*>(s + 4 * u);
      const unsigned h01 = pack_bf16(v.x, v.y), h23 = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(A + at) = make_uint2(h01, h23);
      if (QSPLIT) {
        const unsigned l01 =
            pack_bf16(v.x - __uint_as_float(h01 << 16),
                      v.y - __uint_as_float(h01 & 0xffff0000u));
        const unsigned l23 =
            pack_bf16(v.z - __uint_as_float(h23 << 16),
                      v.w - __uint_as_float(h23 & 0xffff0000u));
        *reinterpret_cast<uint2*>(L + at) = make_uint2(l01, l23);
      }
      if (norms) {
        qsq[i] = fmaf(v.x, v.x, qsq[i]);
        qsq[i] = fmaf(v.y, v.y, qsq[i]);
        qsq[i] = fmaf(v.z, v.z, qsq[i]);
        qsq[i] = fmaf(v.w, v.w, qsq[i]);
      }
    }
    if (p.c == 0 && tid < TBN) {
      const int id = r0 + p.tile * TBN + tid;
      const bool v = id < r1;
      const int at = (p.tile & 1) * TBN + tid;
      if (K1)
        yn[at] = !v ? INFINITY : l2 ? a.yn[id] : 0.f;
      else {
        ok[at] = v;
        yn[at] = (l2 && v) ? a.yn[id] : 0.f;
      }
    }
    if (l2 && p.tile == 0 && p.c == nchunk - 1) {
      // The QR lanes of a row hold its QR partial sums.
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int u = tid + i * NT;
        if (QP % NT != 0 && u >= QP) break;
        float sum = qsq[i];
#pragma unroll
        for (int o = 1; o < QR; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const int row = u / QR;
        if (u % QR == 0) qn[row] = row < nq ? sum : 0.f;
      }
    }
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

  Pos cur{0, 0, 0}, fill{0, 0, 0};  // the chunk multiplied, the one copied
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    issue(fill);
    step(fill);
  }
  knn_gemm::cp_wait<STAGES - 2>();
  convert(cur);
  __syncthreads();
  float acc[G::MT][G::NT8][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  while (cur.j < total) {
    const Pos now = cur;
    const int buf = now.j & 1;
    // The buffers of chunk j - 1, which every warp is past: refill them.
    issue(fill);
    step(fill);
    mma_range<BQ, TBN, QSPLIT>(acc, A + buf * BQ * SA, SA,
                               Bt + (now.j % STAGES) * TBN * SA, SA, 0, BK,
                               wm0, wn0, L + buf * BQ * SA);
    step(cur);
    if (cur.j < total) {
      // This thread's copies of chunk j + 1 have landed (the barrier
      // below shows every thread's row pieces to every warp).
      knn_gemm::cp_wait<STAGES - 2>();
      convert(cur);
    }
    if (now.c == nchunk - 1) {
      const int mb = (now.tile & 1) * TBN, t0 = r0 + now.tile * TBN;
      if (!K1)
        select_tile<BQ, SEL, CAND, false, TBN>(
            acc, bd, bi, qn, qs, yn + mb, ok + mb, t0 / TBN, nq, k, l2, wm0,
            wn0, now.tile == 0);
      else if (l2)
        fold_min<BQ, TBN, true>(acc, bd, bi, qn, yn + mb, t0, wm0, wn0);
      else
        fold_min<BQ, TBN, false>(acc, bd, bi, qn, yn + mb, t0, wm0, wn0);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    __syncthreads();
  }
  knn_gemm::cp_wait<0>();
  float* od = a.out_d + ((size_t)blockIdx.y * a.m + q0) * k;
  int* oi = a.out_i + ((size_t)blockIdx.y * a.m + q0) * k;
  write_rows<BQ, K1>(bd, bi, red_d, red_i, qs.kd, qs.ki, nq, k, wm0, od, oi);
}

template <int BQ, int TBN, bool QSPLIT, int SEL>
cudaError_t run_scan(const Args& a, dim3 grid, size_t bytes,
                     cudaStream_t st) {
  auto kern = b1_mma_kernel<BQ, TBN, QSPLIT, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  kern<<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ, bool QSPLIT>
cudaError_t scan_sel(const Args& a, dim3 grid, size_t bytes,
                     cudaStream_t st) {
  if (a.k <= NET_K) return run_scan<BQ, BN, QSPLIT, SEL_NET>(a, grid, bytes, st);
  return run_scan<BQ, BN, QSPLIT, SEL_MERGE>(a, grid, bytes, st);
}

template <bool QSPLIT>
cudaError_t scan(const Args& a, int bq, int bn, dim3 grid, size_t bytes,
                 cudaStream_t st) {
  if (a.k == 1) {
    if (bn == 32) return run_scan<128, 32, QSPLIT, SEL_MIN>(a, grid, bytes, st);
    if (bn == 64) return run_scan<128, 64, QSPLIT, SEL_MIN>(a, grid, bytes, st);
    return run_scan<128, BN, QSPLIT, SEL_MIN>(a, grid, bytes, st);
  }
  if (bq == 64) return scan_sel<64, QSPLIT>(a, grid, bytes, st);
  if (bq == 32) return scan_sel<32, QSPLIT>(a, grid, bytes, st);
  return scan_sel<16, QSPLIT>(a, grid, bytes, st);
}

}  // namespace

extern "C" {

// B1 on a bf16 tier (qsplit: the split query): the database pre-pass
// (b1_mma_rows_kernel) into ybf (n, kp) with kp = d rounded up to 16, and
// for L2 norms[0, n); the scan of ceil(m / bq) query blocks x n_slices
// database slices of slice_rows rows (a multiple of 128) in tiles of bn
// rows; and with n_slices > 1 the merge of the slice lists ws_d / ws_i
// (n_slices, m, k) into out_d / out_i (m, k). The plan is ops/fused_knn.py
// ::_b1_mma_plan's: bq = 128 and bn in {32, 64, 128} at k = 1, else bq in
// {16, 32, 64} and bn = 128; smem must equal this file's Layout. q and db
// need only 4-byte alignment (the query copies take 16 bytes when d % 4 ==
// 0 and q starts on 16 bytes); ybf must start on 16 bytes. Returns the
// first launch error.
int fused_knn_mma_launch(const float* q, const float* db, float* norms,
                         void* ybf, float* ws_d, int* ws_i, float* out_d,
                         int* out_i, int m, int n, int d, int k, int l2,
                         int qsplit, int bq, int bn, int slice_rows,
                         int n_slices, int smem, void* stream) {
  if (m <= 0) return 0;
  const bool tile_ok =
      k == 1 ? bq == 128 && (bn == 32 || bn == 64 || bn == BN)
             : bn == BN && (bq == 16 || bq == 32 || bq == 64);
  if (k < 1 || k > KMAX || n < 1 || d < 1 || n_slices < 1 ||
      n_slices > knn_gemm::MAX_SLICES || slice_rows % BN != 0 ||
      (size_t)(n_slices - 1) * slice_rows >= (size_t)n ||
      (size_t)n_slices * slice_rows < (size_t)n || !tile_ok ||
      (reinterpret_cast<uintptr_t>(ybf) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Layout lay(bq, bn, k, qsplit != 0);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kp = (d + BK - 1) / BK * BK;
  unsigned short* yb = static_cast<unsigned short*>(ybf);
  b1_mma_rows_kernel<<<(unsigned)((n + 7) / 8), 256, 0, st>>>(
      db, norms, yb, n, d, kp, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool direct = n_slices == 1;
  const int vec =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const Args a{q, yb, norms, direct ? out_d : ws_d, direct ? out_i : ws_i,
               m, n, d, kp, k, l2, slice_rows, vec};
  const dim3 grid((m + bq - 1) / bq, n_slices);
  err = qsplit ? scan<true>(a, bq, bn, grid, lay.total, st)
               : scan<false>(a, bq, bn, grid, lay.total, st);
  if (err != cudaSuccess || direct) return (int)err;
  constexpr int W = knn_gemm::MERGE_WARPS;
  knn_gemm::b1_merge_kernel<<<(m + W - 1) / W, W * 32, 0, st>>>(
      ws_d, ws_i, out_d, out_i, m, k, n_slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
