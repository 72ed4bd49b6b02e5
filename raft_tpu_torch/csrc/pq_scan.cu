// Compressed-domain IVF-PQ scan (B4) for Hopper (sm_90a).
//
// Replaces pq_fused_scan / _pq_scan_kernel / _pq_scan_cell_body of
// raft_tpu/ops/pq_scan.py. Cell c scores its qrows residual-scale query
// rows (already in the kernel's permuted subspace order) against the packed
// PQ codes of list cell_list[c]; -1 cells write (inf, -1) sentinels. Per
// 128-code tile and 32-row chunk of rot_dim, the codewords are decoded
// straight from the transposed u8 codes:
//
//   * code j' of slot c is codesT[list, j', c] (pq_bits 8), or for pq_bits
//     4 the low nibbles of the nbytes raw rows followed by their high
//     nibbles: j' < nbytes ? raw[j'] & 0xF : raw[j' - nbytes] >> 4;
//   * row r = j' * L + s of the codeword is table[r, code], from the lo half
//     when code < 128 and the hi half otherwise; int8 tables are
//     dequantized as q * scale[r, half] (the hi scale only when B > 128),
//     in f32, as the reference dequantizes its resident tables.
//
// Scoring and selection are the shared tile loop (knn_tile.cuh) on its bf16
// tier: g = sum_r bf16(q[r]) * bf16(cw[r]) with f32 sums (exact products),
// |q|^2 and |cw|^2 in f32 from the unrounded values, then L2
// max(qn + cwn - 2g, 0) or -g for inner product, and an exact top-k by
// (distance, slot) with ties to the lowest slot. That is the result of both
// of the reference's epilogues (the legacy grouped k-pass and the fused
// extract/audit/fallback), which are bit-identical by design; this kernel
// copies neither structure. Tiles of 128 slots that are all invalid are
// skipped, so lists of ~1000 rows in a 4096-slot capacity cost ~8 tiles.
//
// What bounds it on the H100: the bytes are small (1 byte per subspace per
// code, read once per 32-query CTA), and the work is 2 * rot_dim operations
// per (query, code) pair, which the bf16 tensor cores could do at 989
// TFLOP/s. This first design runs the product on FP32 FMA units instead
// (exact bf16 products, f32 sums, like the B1-B3 bf16 tiers) and decodes
// each codeword with a gather from the table through L1 (the f32 table is
// rot_dim x 256 x 4 B = 128 KB at rot_dim 128, too large to stage in shared
// memory beside the tiles at larger rot_dim), so it is bound by the FMA
// rate and the decode gathers, far from the tensor-core bound. The lever
// is an mma/wgmma product on the decoded bf16 chunk and a shared-memory
// table (bf16 or int8).

#include "knn_tile.cuh"

namespace {

using namespace knn;

constexpr int LANES = 128;  // codes per half table row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// Decodes the codewords of slots [t0, t0 + BN), rows [c0, c0 + BK) of one
// list. codes: (nbytes, capp) u8 of the list; lo/hi: (rot, 128) tables.
template <typename T>
struct CodeLoader {
  const uint8_t* __restrict__ codes;
  const T* __restrict__ lo;
  const T* __restrict__ hi;
  const float* __restrict__ scale;  // (rot, 2) or nullptr for f32 tables
  int capp, rot, L, nbytes, pq_bits;

  __device__ float table(int r, int code) const {
    bool upper = pq_bits == 8 && code >= LANES;
    float v = upper ? to_f(__ldg(&hi[(size_t)r * LANES + code - LANES]))
                    : to_f(__ldg(&lo[(size_t)r * LANES + min(code, LANES - 1)]));
    if (scale != nullptr) v *= __ldg(&scale[r * 2 + (upper ? 1 : 0)]);
    return v;
  }

  __device__ void operator()(float* ds, int t0, int c0) const {
    for (int e = threadIdx.x; e < BN * BK; e += NT) {
      int c = e % BN, rr = e / BN;  // neighbouring threads, neighbouring slots
      int r = c0 + rr, slot = t0 + c;
      float v = 0.f;
      if (r < rot && slot < capp) {
        int j = r / L;
        int code;
        if (pq_bits == 8) {
          code = codes[(size_t)j * capp + slot];
        } else if (j < nbytes) {
          code = codes[(size_t)j * capp + slot] & 0xF;
        } else {
          code = codes[(size_t)(j - nbytes) * capp + slot] >> 4;
        }
        v = table(r, code);
      }
      ds[rr * DS + c] = v;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
pq_fused_scan_kernel(const int* __restrict__ cell_list,
                     const float* __restrict__ q,
                     const uint8_t* __restrict__ codesT,
                     const T* __restrict__ lo, const T* __restrict__ hi,
                     const float* __restrict__ scale,
                     const uint8_t* __restrict__ invalid,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int qrows, int rot, int nbytes, int capp, int L,
                     int pq_bits, int k, int is_ip) {
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
  CodeLoader<T> load{codesT + (size_t)list * nbytes * capp, lo, hi, scale,
                     capp, rot, L, nbytes, pq_bits};
  scan_tiles(s, q + row0 * rot, nq, capp, rot, invalid + (size_t)list * capp,
             k, !is_ip, true, false, load);
  write_queues(s, nq, k, out_d + row0 * k, out_i + row0 * k);
}

template <typename T>
int launch(const int* cell_list, const float* q, const uint8_t* codesT,
           const void* lo, const void* hi, const float* scale,
           const uint8_t* invalid, float* out_d, int* out_i, int n_cells,
           int qrows, int rot, int nbytes, int capp, int L, int pq_bits,
           int k, int is_ip, cudaStream_t stream) {
  size_t bytes = smem_bytes(k);
  auto kern = pq_fused_scan_kernel<T>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_cells, (qrows + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(
      cell_list, q, codesT, (const T*)lo, (const T*)hi, scale, invalid, out_d,
      out_i, qrows, rot, nbytes, capp, L, pq_bits, k, is_ip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scale == nullptr selects f32 tables; otherwise lo/hi are int8 with the
// (rot, 2) per-row scales. Returns cudaGetLastError() after the launch.
int pq_fused_scan_launch(const int* cell_list, const float* q,
                         const uint8_t* codesT, const void* lo,
                         const void* hi, const float* scale,
                         const uint8_t* invalid, float* out_d, int* out_i,
                         int n_cells, int qrows, int rot, int nbytes,
                         int capp, int pq_dim, int pq_bits, int k, int is_ip,
                         void* stream) {
  if (n_cells <= 0 || qrows <= 0) return 0;
  if (k < 1 || k > KMAX || k > capp || pq_dim <= 0 || rot % pq_dim != 0
      || (pq_bits != 4 && pq_bits != 8))
    return (int)cudaErrorInvalidValue;
  int L = rot / pq_dim;
  cudaStream_t st = (cudaStream_t)stream;
  if (scale != nullptr)
    return launch<int8_t>(cell_list, q, codesT, lo, hi, scale, invalid, out_d,
                          out_i, n_cells, qrows, rot, nbytes, capp, L,
                          pq_bits, k, is_ip, st);
  return launch<float>(cell_list, q, codesT, lo, hi, scale, invalid, out_d,
                       out_i, n_cells, qrows, rot, nbytes, capp, L, pq_bits,
                       k, is_ip, st);
}

}  // extern "C"
