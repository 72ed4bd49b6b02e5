// Streaming min-k extract (B5) for Hopper (sm_90a).
//
// Replaces _stream_select_min / _mextract_kernel / extract_m_rows of
// raft_tpu/matrix/select_k.py: the work-compression pass of the large-len
// select. Row r of the f32 keys (batch, n) is cut into sub-chunks of 512
// positions (positions >= n count as +inf, so the row is read as if padded
// to a multiple of 8192). Each sub-chunk yields its 8 smallest (value,
// position) pairs into columns [8s, 8s + 8) of the row's candidate block
// (batch, n_pad / 64), ascending by (value compared as a float, position):
// -0 and +0 count as equal there, and the value written is the key's own
// bits at the written position. Pass t of extract_m_rows computes
//
//   cur = min of the sub-chunk; sel = lowest position holding cur;
//   the entry at sel becomes +inf; emit (cur, sel).
//
// Two consequences are kept bit for bit. A starved sub-chunk (fewer than 8
// keys below +inf) ends with every entry +inf, so its tail passes emit
// (inf, first position of the sub-chunk). A sub-chunk holding a NaN has a
// NaN minimum that equals nothing, so every pass emits (NaN, INT32_MAX).
// Only compares run, no arithmetic, so the candidates equal the plain
// version's exactly.
//
// What bounds it on the H100: bytes. It reads each key once and writes 8
// bytes per 64 positions: 1.09 GB at batch 1024 x len 262144, 0.33 ms at
// 3.35 TB/s. Eight arg-min passes over 16 registers a lane issue about
// 1,000 warp instructions per 512 keys, which alone took longer than that.
//
// Design: one warp per (row, sub-chunk), 16 keys a lane, then a filter
// whose work follows the survivors instead of eight full passes:
//
// 1. Loads: four 16-byte loads a lane (lane l holds positions
//    128 q + 4 l + r) when every row starts on 16 bytes (n % 4 == 0 and
//    an aligned pointer), else sixteen coalesced 4-byte loads (32 j + l).
//    Either way a lane's offsets grow with its register index.
// 2. NaN: one vote per sub-chunk; a NaN writes the (NaN, INT32_MAX)
//    signature and stops.
// 3. Threshold: each lane's minimum, a bitonic sort of the 32 lane minima,
//    tau = the 8th smallest. At least 8 keys are <= tau (one in each of
//    those lanes).
// 4. Survivors: each lane counts its keys <= tau, a warp prefix sum places
//    them. With at most 32 (about 9 on Gaussian keys, see PERF.md), they
//    go to a 32-slot shared-memory list; each survivor counts the list
//    entries below it in (value, position) order, and the ones of rank < 8
//    write themselves. tau is finite there, so no +inf is written.
// 5. Otherwise (mass ties at tau, -inf-heavy or starved sub-chunks) the
//    warp runs the exact eight passes: a lane arg-min, a 5-step
//    xor-shuffle arg-min on (value, position), the owner knocks the winner
//    out.

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

// Offset in the sub-chunk of register j of a lane.
template <bool VEC>
__device__ __forceinline__ int offset(int j, int lane) {
  return VEC ? 128 * (j >> 2) + 4 * lane + (j & 3) : 32 * j + lane;
}

template <bool VEC>
__device__ __forceinline__ void load(const float* __restrict__ src, int base,
                                     int n, int lane, float (&x)[PER_LANE]) {
  if (VEC) {
    // n % 4 == 0, so a float4 is wholly inside the row or wholly past it.
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      int p = base + offset<true>(4 * q, lane);
      float4 v = p < n ? __ldg(reinterpret_cast<const float4*>(src + p))
                       : make_float4(pos_inf(), pos_inf(), pos_inf(),
                                     pos_inf());
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      int p = base + offset<false>(j, lane);
      x[j] = p < n ? __ldg(src + p) : pos_inf();
    }
  }
}

// The 8 extracts of one sub-chunk (keys x, positions base + offset) into
// ov / oi; slot is the warp's 32-entry survivor list.
template <bool VEC>
__device__ __forceinline__ void extract(float (&x)[PER_LANE], int lane,
                                        int base, float* __restrict__ ov,
                                        int* __restrict__ oi,
                                        int2* __restrict__ slot) {
  bool nan = false;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) nan |= x[j] != x[j];
  if (__any_sync(FULL, nan)) {
    // NaN is never knocked out: every pass gives (NaN, INT32_MAX).
    if (lane < M) {
      ov[lane] = quiet_nan();
      oi[lane] = I32MAX;
    }
    return;
  }

  // tau: the 8th smallest lane minimum, by a bitonic sort of the minima.
  float t = x[0];
#pragma unroll
  for (int j = 1; j < PER_LANE; ++j) t = fminf(t, x[j]);
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) {
      float o = __shfl_xor_sync(FULL, t, s);
      t = (((lane & s) == 0) == ((lane & k) == 0)) ? fminf(t, o)
                                                   : fmaxf(t, o);
    }
  }
  const float tau = __shfl_sync(FULL, t, M - 1);

  int c = 0;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) c += x[j] <= tau;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  const int total = __shfl_sync(FULL, incl, 31);

  if (total <= 32) {
    int o = incl - c;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (x[j] <= tau) {
        slot[o] = make_int2(__float_as_int(x[j]), base + offset<VEC>(j, lane));
        ++o;
      }
    }
    __syncwarp();
    if (lane < total) {
      const int2 me = slot[lane];
      const float mv = __int_as_float(me.x);
      int rank = 0;
      for (int i = 0; i < total; ++i) {
        const int2 e = slot[i];
        const float ev = __int_as_float(e.x);
        rank += (ev < mv) | ((ev == mv) & (e.y < me.y));
      }
      if (rank < M) {
        ov[rank] = mv;
        oi[rank] = me.y;
      }
    }
    return;
  }

  float keep_v = pos_inf();
  int keep_p = base;
#pragma unroll 1
  for (int p = 0; p < M; ++p) {
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
    int bp = base + offset<VEC>(bj, lane);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_xor_sync(FULL, bv, off);
      int p2 = __shfl_xor_sync(FULL, bp, off);
      if (v2 < bv || (v2 == bv && p2 < bp)) {
        bv = v2;
        bp = p2;
      }
    }
    if (lane == p) {
      keep_v = bv;
      keep_p = bp;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (base + offset<VEC>(j, lane) == bp) x[j] = pos_inf();
    }
  }
  if (lane < M) {
    ov[lane] = keep_v;
    oi[lane] = keep_p;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
stream_extract_kernel(const float* __restrict__ keys,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int batch, int n, int nc) {
  __shared__ int2 slots[WARPS][32];    // survivors: (value bits, position)
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * WARPS + wid;
  if (w >= (long long)batch * nc) return;  // whole warps leave together
  const int base = (int)(w % nc) * SUB;
  float x[PER_LANE];
  load<VEC>(keys + (size_t)(w / nc) * n, base, n, lane, x);
  extract<VEC>(x, lane, base, out_v + (size_t)w * M, out_i + (size_t)w * M,
               slots[wid]);
}

}  // namespace

extern "C" {

// keys: (batch, n) f32, contiguous. out_v / out_i: (batch, nc * 8) with
// nc = ceil(n / 8192) * 16 sub-chunks per row. vec != 0 takes the 16-byte
// loads, which need n % 4 == 0 and keys on 16 bytes (refused otherwise).
// Returns cudaGetLastError() after the launch.
int stream_extract_launch(const float* keys, float* out_v, int* out_i,
                          int batch, int n, int nc, int vec, void* stream) {
  if (batch <= 0) return 0;
  if (n <= 0 || nc <= 0 || (long long)nc * SUB < n)
    return (int)cudaErrorInvalidValue;
  if (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(keys) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  long long warps = (long long)batch * nc;
  long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    stream_extract_kernel<true><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        keys, out_v, out_i, batch, n, nc);
  else
    stream_extract_kernel<false><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        keys, out_v, out_i, batch, n, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
