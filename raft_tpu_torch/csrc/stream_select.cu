// Streaming min-k extract (B5) for Hopper (sm_90a).
//
// Replaces _stream_select_min / _mextract_kernel / extract_m_rows of
// raft_tpu/matrix/select_k.py: the work-compression pass of the large-len
// select. Row r of the f32 keys (batch, n) is cut into sub-chunks of 512
// positions (positions >= n count as +inf, so the row is read as if padded
// to a multiple of 8192). Each sub-chunk yields its 8 smallest (value,
// position) pairs, ascending, into columns [8s, 8s + 8) of the row's
// candidate block (batch, n_pad / 64). Pass t of a sub-chunk computes,
// exactly as extract_m_rows does with jnp.min and ==:
//
//   cur = min of the sub-chunk; sel = lowest position holding cur;
//   the entry at sel becomes +inf; emit (cur, sel).
//
// Two consequences are kept bit for bit. A starved sub-chunk (fewer than 8
// finite entries) ends with every entry +inf, so its tail passes emit
// (inf, first position of the sub-chunk). A sub-chunk holding a NaN has a
// NaN minimum that equals nothing, so every pass emits (NaN, INT32_MAX):
// the kernel tests for NaN explicitly (fminf would skip it). Only compares
// run, no arithmetic, so the candidates equal the plain version's exactly.
//
// Design: one warp per (row, sub-chunk). Lane l holds positions l + 32 j,
// j < 16, read coalesced (128 bytes per load instruction, 16 in flight).
// A pass takes each lane's (value, position) minimum over its 16 registers,
// then a 5-step xor-shuffle arg-min ordered by (value, position); the owner
// lane knocks the winner out, and lane t keeps pass t's pair. Lanes 0-7
// write the 8 pairs (64 bytes). Eight warps share a CTA; nothing is staged
// in shared memory and nothing carries between CTAs.
//
// What bounds it on the H100: bytes. It reads each key once and writes
// 8 bytes per 64 positions: at batch 64 x len 131072 that is 33.6 MB +
// 1.0 MB, about 10 us at 3.35 TB/s. The compare work (about 600 warp
// instructions per sub-chunk) is of the same order, and at that size the
// launch and the rank step that follows (a stable sort of n / 64
// candidates per row) take longer than the pass itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 512;               // positions per sub-chunk
constexpr int M = 8;                   // extracts per sub-chunk
constexpr int PER_LANE = SUB / 32;     // registers per lane
constexpr int WARPS = 8;               // warps per CTA
constexpr int I32MAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__global__ void __launch_bounds__(WARPS * 32)
stream_extract_kernel(const float* __restrict__ keys,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int batch, int n, int nc) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)batch * nc) return;  // whole warps leave together
  const int row = (int)(w / nc);
  const int base = (int)(w % nc) * SUB;
  const float* src = keys + (size_t)row * n;

  float x[PER_LANE];
  bool nan = false;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    int p = base + j * 32 + lane;
    float v = p < n ? __ldg(src + p) : pos_inf();
    nan |= v != v;
    x[j] = v;
  }
  float* ov = out_v + (size_t)row * nc * M + (size_t)(base / SUB) * M;
  int* oi = out_i + (size_t)row * nc * M + (size_t)(base / SUB) * M;
  if (__any_sync(FULL, nan)) {
    // NaN is never knocked out: every pass gives (NaN, INT32_MAX).
    if (lane < M) {
      ov[lane] = quiet_nan();
      oi[lane] = I32MAX;
    }
    return;
  }

  float keep_v = pos_inf();
  int keep_p = base;
#pragma unroll 1
  for (int t = 0; t < M; ++t) {
    // Lane minimum; strict < keeps the lowest position among equal values.
    float bv = x[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j) {
      if (x[j] < bv) {
        bv = x[j];
        bj = j;
      }
    }
    int bp = base + bj * 32 + lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_xor_sync(FULL, bv, off);
      int p2 = __shfl_xor_sync(FULL, bp, off);
      if (v2 < bv || (v2 == bv && p2 < bp)) {
        bv = v2;
        bp = p2;
      }
    }
    if (lane == t) {
      keep_v = bv;
      keep_p = bp;
    }
    int rel = bp - base;
    if ((rel & 31) == lane) {
      int jj = rel >> 5;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (j == jj) x[j] = pos_inf();
      }
    }
  }
  if (lane < M) {
    ov[lane] = keep_v;
    oi[lane] = keep_p;
  }
}

}  // namespace

extern "C" {

// keys: (batch, n) f32, contiguous. out_v / out_i: (batch, nc * 8) with
// nc = ceil(n / 8192) * 16 sub-chunks per row. Returns cudaGetLastError()
// after the launch.
int stream_extract_launch(const float* keys, float* out_v, int* out_i,
                          int batch, int n, int nc, void* stream) {
  if (batch <= 0) return 0;
  if (n <= 0 || nc <= 0 || (long long)nc * SUB < n)
    return (int)cudaErrorInvalidValue;
  long long warps = (long long)batch * nc;
  long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stream_extract_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(keys, out_v, out_i, batch,
                                                  n, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
