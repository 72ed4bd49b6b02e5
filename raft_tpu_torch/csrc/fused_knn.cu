// Fused exact kNN (B1) and batched kNN (B3) for Hopper (sm_90a).
//
// Replaces two Pallas kernels of raft_tpu/ops/fused_knn.py:
//   * B1 replaces _fused_knn / _fused_knn_kernel: exact kNN of m queries
//     against an (n, d) database; with k=1 it is also the k-means
//     assignment (distance/fused_l2_nn.py). Its scan, norm pre-pass and
//     slice merge live in knn_gemm.cuh (a 128 x 128 register-tiled FP32
//     tile with a register filter and a split-database merge; the header
//     says what bounds it and what the design does about it);
//   * fused_batch_knn_kernel (B3) replaces _fused_batch_knn /
//     _batch_knn_kernel: batch element b scores its m queries against its
//     own (n, d) slab with mask invalid[b]; the reference's db tiling (bd)
//     and running merge become the tile loop inside one CTA.
//
// The third kernel of that file, B2 (fused_cells_knn, the packed-cells
// IVF-Flat scan), is cells_knn.cu, on B1's tile.
//
// Both compute what the Pallas kernels compute: a gram tile in f32 (or on
// operands rounded to bf16, optionally with the hi/lo split query), the
// clamped expanded-L2 or the negated inner product, and a top-k ordered
// by (distance, id) so ties go to the lowest id.
//
// B3 runs the tile loop of knn_tile.cuh. What bounds it on the H100: the
// work's own bound is arithmetic (2*d flops per (query, row) pair at the
// FP32 non-tensor-core rate, or the bf16 tensor-core rate on the bf16
// tiers), or at the decode scan its bytes. Its 32-query CTAs re-read each
// slab once per 32 queries, and the bf16 tiers use the same FMA path on
// rounded operands (exact products, f32 sums): they do not reach the
// tensor cores yet. The top-k queue lives in shared memory, 8 bytes x 32
// queries x k, so k is capped at 256 (the reference's warpsort cap); the
// B3 wrapper raises past it on the card.

#include "knn_gemm.cuh"
#include "knn_tile.cuh"

namespace {

using namespace knn;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stages database rows of an (n, d) row-major store.
template <typename DbT>
struct RowLoader {
  const DbT* __restrict__ db;
  int n, d;
  __device__ void operator()(float* ds, int t0, int c0) const {
    for (int e = threadIdx.x; e < BN * BK; e += NT) {
      int r = e / BK, c = e % BK;
      float v = 0.f;
      if (t0 + r < n && c0 + c < d)
        v = to_f(db[(size_t)(t0 + r) * d + c0 + c]);
      ds[c * DS + r] = v;
    }
  }
};

template <typename DbT>
__global__ void __launch_bounds__(NT)
fused_batch_knn_kernel(const float* __restrict__ q, const DbT* __restrict__ db,
                       const uint8_t* __restrict__ invalid,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int m, int n, int d, int k, int l2, int bf16,
                       int qsplit) {
  extern __shared__ __align__(16) char smem[];
  Smem s = carve(smem, k);
  int b = blockIdx.x;
  int q0 = blockIdx.y * BQ;
  int nq = min(BQ, m - q0);
  size_t row0 = (size_t)b * m + q0;
  scan_tiles(s, q + row0 * d, nq, n, d, invalid + (size_t)b * n, k, l2, bf16,
             qsplit, RowLoader<DbT>{db + (size_t)b * n * d, n, d});
  write_queues(s, nq, k, out_d + row0 * k, out_i + row0 * k);
}

struct B1Args {
  const float* q;
  const float* db;
  const float* qn;
  const float* yn;
  float* out_d;
  int* out_i;
  int m, n, d, k, l2, slice_rows, direct, vec;
};

template <int BQ, bool BF16, bool QSPLIT, bool K1>
cudaError_t b1_launch(const B1Args& a, dim3 grid, size_t bytes,
                      cudaStream_t st) {
  auto kern = knn_gemm::b1_scan_kernel<BQ, BF16, QSPLIT, K1>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused opt-in must not fail later launches
    return err;
  }
  kern<<<grid, knn_gemm::NT, bytes, st>>>(a.q, a.db, a.qn, a.yn, a.out_d,
                                          a.out_i, a.m, a.n, a.d, a.k, a.l2,
                                          a.slice_rows, a.direct, a.vec);
  return cudaGetLastError();
}

template <bool BF16, bool QSPLIT>
cudaError_t b1_scan(const B1Args& a, int bq, dim3 grid, size_t bytes,
                    cudaStream_t st) {
  if (a.k == 1) return b1_launch<128, BF16, QSPLIT, true>(a, grid, bytes, st);
  if (bq == 128)
    return b1_launch<128, BF16, QSPLIT, false>(a, grid, bytes, st);
  if (bq == 64) return b1_launch<64, BF16, QSPLIT, false>(a, grid, bytes, st);
  return b1_launch<32, BF16, QSPLIT, false>(a, grid, bytes, st);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success).

// B1: the norm pre-pass (L2 only) into norms[0, m + n), the scan of
// ceil(m / bq) query blocks x n_slices database slices of slice_rows rows
// (a multiple of 128), and with n_slices > 1 the merge of the slice lists
// ws_d / ws_i (n_slices, m, k) into out_d / out_i (m, k). The plan is
// ops/fused_knn.py::_b1_plan's. q and db need only 4-byte alignment: the
// 16-byte copies run when d % 4 == 0 and both start on 16 bytes. Returns
// the first launch error.
int fused_knn_launch(const float* q, const float* db, float* norms,
                     float* ws_d, int* ws_i, float* out_d, int* out_i, int m,
                     int n, int d, int k, int l2, int bf16, int qsplit,
                     int bq, int slice_rows, int n_slices, void* stream) {
  if (m <= 0) return 0;
  qsplit = qsplit && bf16;
  if (k < 1 || k > KMAX || n < 1 || d < 1 || n_slices < 1 ||
      n_slices > knn_gemm::MAX_SLICES || slice_rows % knn_gemm::BN != 0 ||
      (size_t)(n_slices - 1) * slice_rows >= (size_t)n ||
      (size_t)n_slices * slice_rows < (size_t)n ||
      !(bq == 32 || bq == 64 || bq == 128) || (k == 1 && bq != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec =
      d % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(db)) & 15) == 0;
  if (l2) {
    long long rows = (long long)m + n;
    knn_gemm::b1_norms_kernel<<<(unsigned)((rows + 255) / 256), 256, 0,
                                st>>>(q, db, norms, m, n, d, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bool direct = n_slices == 1;
  B1Args a{q, db, norms, l2 ? norms + m : nullptr, direct ? out_d : ws_d,
           direct ? out_i : ws_i, m, n, d, k, l2, slice_rows, (int)direct,
           vec};
  dim3 grid((m + bq - 1) / bq, n_slices);
  size_t bytes = knn_gemm::smem_bytes(bq, k, qsplit);
  cudaError_t err;
  if (!bf16)
    err = b1_scan<false, false>(a, bq, grid, bytes, st);
  else if (!qsplit)
    err = b1_scan<true, false>(a, bq, grid, bytes, st);
  else
    err = b1_scan<true, true>(a, bq, grid, bytes, st);
  if (err != cudaSuccess || direct) return (int)err;
  constexpr int W = knn_gemm::MERGE_WARPS;
  knn_gemm::b1_merge_kernel<<<(m + W - 1) / W, W * 32, 0, st>>>(
      ws_d, ws_i, out_d, out_i, m, k, n_slices);
  return (int)cudaGetLastError();
}

int fused_batch_knn_launch(const float* q, const void* db, int db_is_bf16,
                           const uint8_t* invalid, float* out_d, int* out_i,
                           int batch, int m, int n, int d, int k, int l2,
                           int bf16, int qsplit, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  if (k < 1 || k > KMAX || k > n) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_bytes(k);
  dim3 grid(batch, (m + BQ - 1) / BQ);
  cudaError_t err;
  if (db_is_bf16) {
    auto kern = fused_batch_knn_kernel<__nv_bfloat16>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        q, (const __nv_bfloat16*)db, invalid, out_d, out_i, m, n, d, k, l2,
        bf16, qsplit);
  } else {
    auto kern = fused_batch_knn_kernel<float>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        q, (const float*)db, invalid, out_d, out_i, m, n, d, k, l2, bf16,
        qsplit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
