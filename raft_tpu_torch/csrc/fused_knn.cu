// Fused exact kNN (B1) for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/fused_knn.py::_fused_knn / _fused_knn_kernel: exact
// kNN of m queries against an (n, d) database; with k=1 it is also the
// k-means assignment (distance/fused_l2_nn.py). It computes what the
// Pallas kernel computes: a gram tile in f32 (or on operands rounded to
// bf16, optionally with the hi/lo split query), the clamped expanded-L2 or
// the negated inner product, and a top-k ordered by (distance, id) so ties
// go to the lowest id. Its scan, norm pre-pass and slice merge live in
// knn_gemm.cuh (a 128 x 128 register-tiled FP32 tile with a register
// filter and a split-database merge; the header says what bounds it and
// what the design does about it); this file holds its entry point.
//
// The other two kernels of that file are their own libraries: B2
// (fused_cells_knn, the packed-cells IVF-Flat scan) is cells_knn.cu, on
// B1's tile, and B3 (fused_batch_knn, the batched independent kNN) is
// batch_knn.cu, on the bf16 tensor-core tile it shares with B4.

#include "knn_gemm.cuh"

namespace {

using namespace knn;

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

}  // extern "C"
