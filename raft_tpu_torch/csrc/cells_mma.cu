// B2's bf16 tiers for Hopper (sm_90a): the packed-cells IVF-Flat scan on
// bf16 tensor cores (mma.sync), reading bf16, f32 or 8-bit rows itself.
//
// Replaces raft_tpu/ops/fused_knn.py::fused_cells_knn / _cells_knn_kernel
// (pallas_call at :426) on its two bf16 tiers, which the Pallas kernel
// computes as bf16 MXU products with f32 accumulation: dot(qh, yc), plus
// dot(ql, yc) with the split query. Cell c scores its qrows queries
// against list cell_list[c] of a capacity-padded (L, cap, d) store,
// skipping the slots a per-slot `invalid` mask sets; a -1 cell writes
// (inf, -1). The function (ops/fused_knn.py::_fused_cells_knn_plain with
// bf16): g = sum bf16(q) * bf16(y), plus sum bf16(q - bf16(q)) * bf16(y)
// with qsplit, f32 sums; max(|q|^2 + |y|^2 - 2g, 0) for L2 with f32 norms
// of the unrounded rows, or -g for inner product; the exact top-k by
// (distance, slot), ties to the lowest slot, -1 for slots left at inf.
// The f32 tier runs on TF32 tensor cores in cells_tf32.cu, with B1's
// 3xTF32 split (one TF32 product would break its parity with the
// reference's Precision.HIGHEST; three do not).
//
// Who runs it: every u8 / int8 IVF-Flat search (the bf16 + split-query
// tier, which keeps f32 query precision; values -128..255 are exact in
// bf16), bf16 indexes (the bf16 tier), and B3's tiers that its own
// tensor-core scan does not take (batch_knn.cu).
//
// What bounds it on the H100: 2 * d operations per (query, valid slot)
// pair at the bf16 tensor-core rate, twice with qsplit, against the bytes
// of the valid rows (d each for an 8-bit store, a quarter of f32), the
// queries and the results. At the main path's cells (6024 cells x 64
// rows, ~1470 valid rows a cell, d 128) the split tier's products are
// ~0.28 ms at the dense bf16 peak; mma.sync reaches part of that peak, and
// selection (the register filter and the queues) costs as much again.
// What the design does:
//
//   * one CTA of 256 threads per (cell, block of BQ query rows): BQ = 64,
//     the cell height, or 32 / 16 when the queue or the resident query
//     needs the room (ops/fused_knn.py::_b2_mma_plan), so each list is
//     staged once per cell;
//   * the query block stays resident: rounded to bf16 into the A operand
//     once per CTA (its lo half bf16(q - bf16(q)) into a second operand L
//     with qsplit), zero past the cell's rows and d, with f32 norms of the
//     unrounded rows. It fits at every d up to 1024 (16 or 32 rows there);
//   * the pre-pass of cell_norms.cuh (f32 norms from the unrounded rows,
//     NaN marking invalid slots, the live 128-slot tiles), reading the
//     store in its own type. The scan walks only the live tiles;
//   * each live tile is staged in panels of PW features (64, or d rounded
//     up to 16 when smaller), so two 64-row CTAs share an SM at d 128 and
//     the operand tiles do not grow with d. A bf16 store lands by cp.async
//     straight in a double-buffered bf16 operand tile (16-byte copies, or
//     8, 4, 2 when d or the store's alignment does not allow them). An
//     8-bit or f32 store lands by cp.async in its own bytes in a staging
//     buffer, one panel ahead, and each thread widens (8-bit: exactly, by
//     byte permutes and one add a value) or rounds (f32: cvt.rn.bf16x2)
//     the pieces it copied itself into the operand tile, so no barrier
//     separates the copy from the widening. Features past d and rows past
//     cap are zero;
//   * the product is mma_tile.cuh's: ldmatrix fragments, m16n8k16 bf16
//     with f32 accumulators over the BQ x 128 block, qsplit as a second
//     mma of the lo fragment into the same accumulators;
//   * selection: k = 1 keeps a register (min, slot) per row (fold_min);
//     k > 1 is select_tile: the register filter, the first-tile bound,
//     and cell_select.cuh's insertion network for k <= 16 (drained on the
//     1st, 2nd, 4th, 8th, ... live tile, B2's schedule) or warp merges.
//
// Callers pass finite operands (the entry points reject non-finite
// inputs): an L2 NaN would come out of fmaxf as distance 0.

#include "cell_norms.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using cell_norms::KIND_BF16;
using cell_norms::KIND_F32;
using cell_norms::KIND_I8;
using cell_norms::KIND_U8;

// Candidate slots per CTA (CN / BQ a row): as B3's, so that a 64-row CTA
// of the network path at d 128 fits twice in an SM's shared memory.
constexpr int CN = 2048;

__host__ __device__ inline int elem_bytes(int kind) {
  return kind == KIND_F32 ? 4 : kind == KIND_BF16 ? 2 : 1;
}

// Byte offsets of the shared-memory regions (ops/fused_knn.py::
// _b2_mma_smem_bytes counts the same regions in the same order).
struct Layout {
  size_t A, L, Bt, raw, qn, yn, ok, red, kd, ki, cd, ci, cnt, qmask, tm,
      thr;
  size_t total;
  __host__ __device__ Layout(int bq, int kp, int pw, int kind, int k,
                             bool qsplit) {
    const int warps_n = NW / (bq >= 32 ? bq / 32 : 1);
    size_t at = 0;
    A = take(at, (size_t)bq * (kp + 8) * 2);
    L = take(at, qsplit ? (size_t)bq * (kp + 8) * 2 : 0);
    Bt = take(at, (size_t)2 * BN * (pw + 8) * 2);
    raw = take(at, kind == KIND_BF16 ? 0
                                     : (size_t)BN * pw * elem_bytes(kind));
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
  const void* db;        // (n_lists, cap, d) of element type kind
  const float* yn;       // (n_lists, capp): the pre-pass's norms / NaN
  const uint8_t* live;   // (n_lists, capp / 128): the pre-pass's flags
  const int* live_rows;  // (n_cells,): rows scanned per cell, or nullptr
  float* out_d;          // (n_cells, qrows, k)
  int* out_i;
  // kp: d rounded up to 16; pw: features per panel; np: panels per tile;
  // vec: bytes a copy of the store's pieces.
  int n_cells, qrows, cap, capp, d, kp, pw, np, k, l2, kind, vec;
};

// A panel: features [k0, k0 + kw) of the rows of tile t (slots t * 128 +
// [0, 128) below cap) of a list whose rows start at `rows`.
struct Panel {
  const char* rows;
  int t, cap, d, k0, kw;
};

template <int BYTES>
__device__ __forceinline__ void store_zero(void* dst) {
  if constexpr (BYTES == 32) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
  } else if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned*>(dst) = 0u;
  } else {
    *reinterpret_cast<unsigned short*>(dst) = 0;
  }
}

// Piece u of a panel of E elements a piece: row u / per, panel column
// (u % per) * E; `in` when it holds store elements (below cap and d).
struct Piece {
  int r, c;
  bool in;
};

template <int E>
__device__ __forceinline__ Piece piece(const Panel& p, int u, int per) {
  const int r = u / per, c = (u - r * per) * E;
  return {r, c, p.t * BN + r < p.cap && p.k0 + c < p.d};
}

// The element offset of a piece in the list's rows.
__device__ __forceinline__ size_t elem_at(const Panel& p, const Piece& x) {
  return (size_t)(p.t * BN + x.r) * p.d + p.k0 + x.c;
}

// A bf16 store: this thread's pieces of the panel (VEC bytes each) by
// cp.async straight into the operand tile B (row stride SB), or, with VEC
// 2, by plain loads; zeros past cap and d.
template <int VEC>
__device__ __forceinline__ void copy_bf16(unsigned short* B, int SB,
                                          const Panel& p) {
  constexpr int E = VEC / 2;
  const int per = p.kw / E;
  const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(p.rows);
  for (int u = threadIdx.x; u < BN * per; u += NT) {
    const Piece x = piece<E>(p, u, per);
    unsigned short* dst = B + x.r * SB + x.c;
    if (!x.in)
      store_zero<VEC>(dst);
    else if constexpr (VEC == 2)
      *dst = __bfloat16_as_ushort(src[elem_at(p, x)]);
    else
      cp_async<VEC>(dst, src + elem_at(p, x));
  }
}

// An f32 or 8-bit store (ES bytes an element): this thread's pieces of the
// panel by cp.async into raw, piece u at raw + u * VEC, so that each
// thread's pieces stay its own whatever the panel's width. Pieces past cap
// and d are not copied (the widening writes their zeros).
template <int VEC, int ES>
__device__ __forceinline__ void copy_raw(char* raw, const Panel& p) {
  constexpr int E = VEC / ES;
  const int per = p.kw / E;
  for (int u = threadIdx.x; u < BN * per; u += NT) {
    const Piece x = piece<E>(p, u, per);
    if (x.in) cp_async<VEC>(raw + u * VEC, p.rows + elem_at(p, x) * ES);
  }
}

// Four bytes (element 0 lowest) as two words of bf16 pairs, exactly:
// byte b becomes the float 2^23 + b (its bits 0x4B0000bb) less 2^23; int8
// flips the sign bit first (b + 128) and takes 2^23 + 128 off. Those
// floats' low 16 bits are zero, so their high halves are the bf16 values.
__device__ __forceinline__ uint2 widen4(unsigned w, bool sgn) {
  const unsigned x = sgn ? w ^ 0x80808080u : w;
  const float off = sgn ? 8388736.f : 8388608.f;
  unsigned f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)) - off);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// An 8-bit store: this thread's pieces of the panel (VEC bytes each) from
// raw into the operand tile as exact bf16 values, zeros past cap and d;
// with VEC 1, straight from device memory (no copy was issued).
template <int VEC>
__device__ __forceinline__ void widen_8bit(unsigned short* B, int SB,
                                           const char* raw, const Panel& p,
                                           bool sgn) {
  const int per = p.kw / VEC;
  for (int u = threadIdx.x; u < BN * per; u += NT) {
    const Piece x = piece<VEC>(p, u, per);
    unsigned short* dst = B + x.r * SB + x.c;
    if (!x.in) {
      store_zero<2 * VEC>(dst);
    } else if constexpr (VEC == 1) {
      const uint8_t b =
          reinterpret_cast<const uint8_t*>(p.rows)[elem_at(p, x)];
      *dst = bf16_bits(sgn ? (float)(int8_t)b : (float)b);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(dst) =
          widen4(*reinterpret_cast<const unsigned*>(raw + u * 4), sgn);
    } else {
      const uint4 w = *reinterpret_cast<const uint4*>(raw + u * 16);
      const uint2 a = widen4(w.x, sgn), b = widen4(w.y, sgn);
      const uint2 c = widen4(w.z, sgn), e = widen4(w.w, sgn);
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(a.x, a.y, b.x, b.y);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(c.x, c.y, e.x, e.y);
    }
  }
}

// An f32 store: this thread's pieces of the panel (VEC bytes each) from
// raw into the operand tile, rounded to the nearest bf16; zeros past cap
// and d.
template <int VEC>
__device__ __forceinline__ void widen_f32(unsigned short* B, int SB,
                                          const char* raw, const Panel& p) {
  constexpr int E = VEC / 4;
  const int per = p.kw / E;
  for (int u = threadIdx.x; u < BN * per; u += NT) {
    const Piece x = piece<E>(p, u, per);
    unsigned short* dst = B + x.r * SB + x.c;
    if (!x.in) {
      store_zero<2 * E>(dst);
    } else if constexpr (VEC == 16) {
      const float4 v = *reinterpret_cast<const float4*>(raw + u * 16);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    } else {
      *dst = bf16_bits(*reinterpret_cast<const float*>(raw + u * 4));
    }
  }
}

// Keeps the compiler from moving shared-memory accesses across it: the
// widening reads raw only after the wait for its copies, and the refill's
// copies are issued only after those reads.
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

// Stage a panel: a bf16 store straight into the operand tile B, the other
// kinds into raw (nothing for 1-byte pieces, which the widening loads).
__device__ __forceinline__ void stage_panel(unsigned short* B, int SB,
                                            char* raw, const Panel& p,
                                            int kind, int vec) {
  if (kind == KIND_BF16) {
    if (vec == 16)
      copy_bf16<16>(B, SB, p);
    else if (vec == 8)
      copy_bf16<8>(B, SB, p);
    else if (vec == 4)
      copy_bf16<4>(B, SB, p);
    else
      copy_bf16<2>(B, SB, p);
  } else if (kind == KIND_F32) {
    if (vec == 16)
      copy_raw<16, 4>(raw, p);
    else
      copy_raw<4, 4>(raw, p);
  } else if (vec == 16) {
    copy_raw<16, 1>(raw, p);
  } else if (vec == 4) {
    copy_raw<4, 1>(raw, p);
  }
}

// Move this thread's staged pieces of a panel (f32 or 8-bit store) from
// raw into the operand tile B.
__device__ __forceinline__ void widen_panel(unsigned short* B, int SB,
                                            const char* raw, const Panel& p,
                                            int kind, int vec) {
  if (kind == KIND_F32) {
    if (vec == 16)
      widen_f32<16>(B, SB, raw, p);
    else
      widen_f32<4>(B, SB, raw, p);
  } else {
    const bool sgn = kind == KIND_I8;
    if (vec == 16)
      widen_8bit<16>(B, SB, raw, p, sgn);
    else if (vec == 4)
      widen_8bit<4>(B, SB, raw, p, sgn);
    else
      widen_8bit<1>(B, SB, raw, p, sgn);
  }
}

// One CTA: query rows [q0, q0 + BQ) of cell blockIdx.x / ceil(qrows / BQ)
// against the live tiles of its list, panel by panel. With live_rows,
// rows of cell c at or past live_rows[c] are not scanned and report (inf,
// -1). One instance per selection path, so the merge's registers do not
// crowd the others: two CTAs share an SM except on the merge path.
template <int BQ, bool QSPLIT, int SEL>
__global__ void __launch_bounds__(NT, SEL == SEL_MERGE ? 1 : 2)
    b2_mma_kernel(const Args a) {
  using G = Geo<BQ>;
  constexpr bool K1 = SEL == SEL_MIN;
  extern __shared__ __align__(16) char smem[];
  const int k = K1 ? 1 : a.k;
  const Layout lay(BQ, a.kp, a.pw, a.kind, k, QSPLIT);
  unsigned short* A = reinterpret_cast<unsigned short*>(smem + lay.A);
  unsigned short* L = reinterpret_cast<unsigned short*>(smem + lay.L);
  unsigned short* Bt = reinterpret_cast<unsigned short*>(smem + lay.Bt);
  char* raw = smem + lay.raw;
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
  const int SA = a.kp + 8, SB = a.pw + 8, tile_elems = BN * SB;
  const bool l2 = a.l2 != 0, direct = a.kind == KIND_BF16;
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
  const int ntiles = a.capp / BN;
  const uint8_t* live = a.live + (size_t)list * ntiles;
  const float* yn_g = a.yn + (size_t)list * a.capp;
  const char* lrows = static_cast<const char*>(a.db) +
                      (size_t)list * a.cap * a.d * elem_bytes(a.kind);

  // Step j is panel p of live tile `tile`; `fill` runs two steps ahead of
  // the one multiplied. A bf16 store lands in operand tile j % 2, another
  // in raw one step ahead and is widened into tile j % 2 by the threads
  // that copied it. Every issue commits one copy group, empty or not.
  struct Pos {
    int tile, p, j;
  };
  auto step = [&](Pos& s) {
    ++s.j;
    if (++s.p == a.np) {
      s.p = 0;
      s.tile = cell_select::next_live(live, s.tile, ntiles);
    }
  };
  auto panel = [&](const Pos& s) {
    const int k0 = s.p * a.pw;
    return Panel{lrows, s.tile, a.cap, a.d, k0, min(a.pw, a.kp - k0)};
  };
  auto issue = [&](const Pos& s) {
    if (s.tile < ntiles)
      stage_panel(Bt + (s.j & 1) * tile_elems, SB, raw, panel(s), a.kind,
                  a.vec);
    cp_commit();
  };
  // Tile t's slot metadata into buffer b: for k = 1 fold_min's yo (the
  // norm, 0 for inner product, +inf for an invalid slot), else the norms
  // and valid flags of select_tile.
  auto meta = [&](int t, int b) {
    if (tid < BN) {
      const float y = yn_g[t * BN + tid];
      const bool v = !isnan(y);
      if (K1) {
        yn[b * BN + tid] = v ? (l2 ? y : 0.f) : INFINITY;
      } else {
        ok[b * BN + tid] = v;
        yn[b * BN + tid] = v ? y : 0.f;
      }
    }
  };

  Pos cur{cell_select::next_live(live, -1, ntiles), 0, 0};
  Pos fill = cur;
  issue(fill);
  step(fill);

  // While the first panel lands: the bf16 query operand (zero past nq and
  // d), its lo half with qsplit, and the f32 norms of the unrounded rows;
  // warp w takes rows w, w + 8, ..., whose loads are in flight together.
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
        const int at_ = (warp + i * NW) * SA + c;
        acc[i] = fmaf(v[i], v[i], acc[i]);
        const unsigned short h = bf16_bits(v[i]);
        A[at_] = h;
        if (QSPLIT)
          L[at_] = bf16_bits(v[i] - __uint_as_float((unsigned)h << 16));
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

  // Step 0 into operand tile 0, step 1 on its way.
  Pos nx = fill;
  if (direct) {
    issue(fill);
    step(fill);
    cp_wait<1>();
  } else {
    cp_wait<0>();
    fence();
    if (cur.tile < ntiles)
      widen_panel(Bt, SB, raw, panel(cur), a.kind, a.vec);
    fence();
    issue(fill);
    step(fill);
  }
  if (cur.tile < ntiles) meta(cur.tile, 0);
  __syncthreads();

  float acc[G::MT][G::NT8][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  int mb = 0, n_done = 0;  // the tile's metadata buffer, tiles selected
  bool pending = false;    // candidates wait for a drain
  while (cur.tile < ntiles) {
    const int b = cur.j & 1;
    const bool last = cur.p == a.np - 1;
    mma_range<BQ, BN, QSPLIT>(acc, A, SA, Bt + b * tile_elems, SB,
                              cur.p * a.pw, min(a.pw, a.kp - cur.p * a.pw),
                              wm0, wn0, L);
    if (!direct && nx.tile < ntiles) {
      // Step j + 1 has landed (this thread's pieces): widen it into the
      // other operand tile, which every warp is past, and refill raw.
      cp_wait<0>();
      fence();
      widen_panel(Bt + (b ^ 1) * tile_elems, SB, raw, panel(nx), a.kind,
                  a.vec);
      fence();
      issue(fill);
    }
    if (nx.tile < ntiles && nx.p == 0) meta(nx.tile, mb ^ 1);
    bool synced = false;  // the selection ended on a barrier
    if (last) {
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
        synced = true;
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      mb ^= 1;
    }
    if (direct) {
      // Every warp is past operand tile b: refill it with step j + 2.
      if (!synced) __syncthreads();
      issue(fill);
      cp_wait<1>();
      __syncthreads();
    } else if (!synced) {
      __syncthreads();
    }
    cur = nx;
    nx = fill;
    if (fill.tile < ntiles) step(fill);
  }
  cp_wait<0>();
  if (SEL == SEL_NET && pending) {
    cell_select::drain_network<BQ, CN / BQ>(qs, nq, k);
    __syncthreads();
  }
  write_rows<BQ, K1>(bd, bi, red_d, red_i, qs.kd, qs.ki, nq, k, wm0, od, oi);
}

template <int BQ, bool QSPLIT, int SEL>
cudaError_t run_scan(const Args& a, size_t bytes, cudaStream_t st) {
  auto kern = b2_mma_kernel<BQ, QSPLIT, SEL>;
  cudaError_t err = knn::allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  const long long grid = (long long)a.n_cells * ((a.qrows + BQ - 1) / BQ);
  kern<<<(unsigned)grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int BQ, bool QSPLIT>
cudaError_t scan_sel(const Args& a, size_t bytes, cudaStream_t st) {
  if (a.k == 1) return run_scan<BQ, QSPLIT, SEL_MIN>(a, bytes, st);
  if (a.k <= NET_K) return run_scan<BQ, QSPLIT, SEL_NET>(a, bytes, st);
  return run_scan<BQ, QSPLIT, SEL_MERGE>(a, bytes, st);
}

template <bool QSPLIT>
cudaError_t scan(const Args& a, int bq, size_t bytes, cudaStream_t st) {
  if (bq == 64) return scan_sel<64, QSPLIT>(a, bytes, st);
  if (bq == 32) return scan_sel<32, QSPLIT>(a, bytes, st);
  return scan_sel<16, QSPLIT>(a, bytes, st);
}

// Bytes a copy of the store's pieces: the widest that d and the store's
// alignment allow (f32: 16 or 4; bf16: 16, 8, 4 or 2; 8-bit: 16, 4 or 1,
// the last by plain loads).
int piece_bytes(int kind, int d, uintptr_t da) {
  const int es = elem_bytes(kind);
  const auto fits = [&](int bytes) {
    return d % (bytes / es) == 0 && da % bytes == 0;
  };
  if (fits(16)) return 16;
  if (kind == KIND_BF16 && fits(8)) return 8;
  if (kind != KIND_F32 && fits(4)) return 4;
  return kind == KIND_F32 ? 4 : es;
}

}  // namespace

extern "C" {

// One call of B2's bf16 tiers (qsplit: the split query): the pre-pass into
// yn (n_lists, capp) and live (n_lists, capp / 128), capp = cap rounded up
// to 128, then the scan on the plan of ops/fused_knn.py::_b2_mma_plan (bq
// query rows per CTA, pw features per panel, smem bytes, which must equal
// this file's Layout). db's elements are f32, bf16, u8 or i8 (kind 0-3).
// live_rows (n_cells,), or nullptr for every row: rows of cell c at or past
// live_rows[c] are not scanned and report (inf, -1). Operands need only
// their element alignment. Returns the first launch error.
int fused_cells_mma_launch(const int* cell_list, const float* q,
                           const void* db, int kind, const uint8_t* invalid,
                           const int* live_rows, float* yn, uint8_t* live,
                           float* out_d, int* out_i, int n_cells, int n_lists,
                           int qrows, int cap, int d, int k, int l2,
                           int qsplit, int bq, int pw, int smem,
                           void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  const int capp = (cap + BN - 1) / BN * BN;
  const int kp = (d + 15) / 16 * 16;
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || n_lists < 1 ||
      n_lists > 65535 || kind < KIND_F32 || kind > KIND_I8 ||
      !(bq == 16 || bq == 32 || bq == 64) || pw < 16 || pw % 16 != 0 ||
      pw > kp || (long long)n_cells * ((qrows + bq - 1) / bq) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout lay(bq, kp, pw, kind, k, qsplit != 0);
  if ((size_t)smem != lay.total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cell_norms::launch(db, kind, invalid, yn, live, n_lists,
                                      cap, capp, d, l2, st);
  if (err != cudaSuccess) return (int)err;
  const Args a{cell_list, q, db, yn, live, live_rows, out_d, out_i, n_cells,
               qrows, cap, capp, d, kp, pw, (kp + pw - 1) / pw, k, l2, kind,
               piece_bytes(kind, d, reinterpret_cast<uintptr_t>(db))};
  err = qsplit ? scan<true>(a, bq, lay.total, st)
               : scan<false>(a, bq, lay.total, st);
  return (int)err;
}

}  // extern "C"
