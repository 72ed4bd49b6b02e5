// Fused exact kNN, packed-cells IVF-Flat scan and batched kNN for Hopper
// (sm_90a).
//
// Replaces three Pallas kernels of raft_tpu/ops/fused_knn.py:
//   * fused_knn_kernel (B1) replaces _fused_knn / _fused_knn_kernel: exact
//     kNN of m queries against an (n, d) database; with k=1 it is also the
//     k-means assignment (distance/fused_l2_nn.py);
//   * fused_cells_knn_kernel (B2) replaces fused_cells_knn /
//     _cells_knn_kernel: cell c scores its qrows queries against the list
//     cell_list[c] of a capacity-padded (L, cap, d) store, with a per-slot
//     invalid mask; cell_list[c] == -1 writes sentinels;
//   * fused_batch_knn_kernel (B3) replaces _fused_batch_knn /
//     _batch_knn_kernel: batch element b scores its m queries against its
//     own (n, d) slab with mask invalid[b]. It is B2 with the identity cell
//     map; the reference's db tiling (bd) and running merge become the
//     tile loop inside one CTA.
//
// All three compute what the Pallas kernels compute (see knn_tile.cuh): a
// gram tile in f32 (or on operands rounded to bf16, optionally with the
// hi/lo split query), the clamped expanded-L2 or the negated inner product,
// and a top-k ordered by (distance, id) so ties go to the lowest id.
//
// What bounds them on the H100: the work's own bound is arithmetic (2*d
// flops per (query, row) pair at the FP32 non-tensor-core rate, or the bf16
// tensor-core rate on the bf16 tiers; the inputs are read once). This
// design does not reach it: every 32-query CTA re-reads its whole database
// (or slab), so at the brute-force shape (10k queries x 1M x 128) about 313
// CTAs stream 512 MB each, ~160 GB in all, which is 2*32 flops per 4 bytes
// = 16 flop/B, under the card's ~20 flop/B ridge. Unless L2 catches the
// reuse, B1 is bound by that memory traffic. The lever is more queries per
// CTA or a db-tile-major schedule whose tiles stay in L2 across query
// blocks. The f32 path must not use TF32 tensor cores (about 3 decimal
// digits; it breaks parity with the reference's Precision.HIGHEST), so the
// product is a plain register-tiled FMA product, and the bf16 tiers use
// the same FMA path on rounded operands (exact products, f32 sums): they
// do not reach the tensor cores yet.
//
// The top-k queue lives in shared memory, 8 bytes x 32 queries x k, so k is
// capped at 256 (the reference's warpsort cap); the B3 wrapper raises past
// it on the card.

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

__global__ void __launch_bounds__(NT)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 float* __restrict__ out_d, int* __restrict__ out_i, int m,
                 int n, int d, int k, int l2, int bf16, int qsplit) {
  extern __shared__ __align__(16) char smem[];
  Smem s = carve(smem, k);
  int q0 = blockIdx.x * BQ;
  int nq = min(BQ, m - q0);
  scan_tiles(s, q + (size_t)q0 * d, nq, n, d, nullptr, k, l2, bf16, qsplit,
             RowLoader<float>{db, n, d});
  write_queues(s, nq, k, out_d + (size_t)q0 * k, out_i + (size_t)q0 * k);
}

template <typename DbT>
__global__ void __launch_bounds__(NT)
fused_cells_knn_kernel(const int* __restrict__ cell_list,
                       const float* __restrict__ q, const DbT* __restrict__ db,
                       const uint8_t* __restrict__ invalid,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int qrows, int cap, int d, int k, int l2, int bf16,
                       int qsplit) {
  extern __shared__ __align__(16) char smem[];
  Smem s = carve(smem, k);
  int cell = blockIdx.x;
  int q0 = blockIdx.y * BQ;
  int nq = min(BQ, qrows - q0);
  size_t row0 = (size_t)cell * qrows + q0;
  int list = cell_list[cell];
  if (list < 0) {
    write_sentinels(nq, k, out_d + row0 * k, out_i + row0 * k);
    return;
  }
  scan_tiles(s, q + row0 * d, nq, cap, d, invalid + (size_t)list * cap, k,
             l2, bf16, qsplit,
             RowLoader<DbT>{db + (size_t)list * cap * d, cap, d});
  write_queues(s, nq, k, out_d + row0 * k, out_i + row0 * k);
}

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

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success).

int fused_knn_launch(const float* q, const float* db, float* out_d,
                     int* out_i, int m, int n, int d, int k, int l2, int bf16,
                     int qsplit, void* stream) {
  if (m <= 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_bytes(k);
  cudaError_t err = allow_smem(fused_knn_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + BQ - 1) / BQ);
  fused_knn_kernel<<<grid, NT, bytes, (cudaStream_t)stream>>>(
      q, db, out_d, out_i, m, n, d, k, l2, bf16, qsplit);
  return (int)cudaGetLastError();
}

int fused_cells_knn_launch(const int* cell_list, const float* q,
                           const void* db, int db_is_bf16,
                           const uint8_t* invalid, float* out_d, int* out_i,
                           int n_cells, int qrows, int cap, int d, int k,
                           int l2, int bf16, int qsplit, void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_bytes(k);
  dim3 grid(n_cells, (qrows + BQ - 1) / BQ);
  cudaError_t err;
  if (db_is_bf16) {
    auto kern = fused_cells_knn_kernel<__nv_bfloat16>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        cell_list, q, (const __nv_bfloat16*)db, invalid, out_d, out_i, qrows,
        cap, d, k, l2, bf16, qsplit);
  } else {
    auto kern = fused_cells_knn_kernel<float>;
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(
        cell_list, q, (const float*)db, invalid, out_d, out_i, qrows, cap, d,
        k, l2, bf16, qsplit);
  }
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
