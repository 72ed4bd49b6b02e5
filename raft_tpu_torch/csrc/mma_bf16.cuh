// bf16 tensor-core fragments for Hopper (sm_90a): ldmatrix and the
// m16n8k16 mma with f32 accumulators, as B4 (pq_scan.cu) uses them.
//
// Operand layouts, per warp:
//   * A (16 x 16, row-major in shared memory): ldmatrix_x4 with lane l
//     pointing at row l % 16, column 8 * (l / 16) gives a0..a3 in the
//     order mma wants (rows 0-7 / 8-15 of k 0-7, then of k 8-15);
//   * B (16 x 8, "col": stored n-major, k contiguous): ldmatrix_x4 with
//     lane l pointing at n = 8 * (l / 16) + l % 8, k = 8 * ((l / 8) % 2)
//     gives (b0, b1) of the n-tile at n 0-7, then of the n-tile at n 8-15;
//   * C: c0, c1 at row l / 4, columns 2 (l % 4) + {0, 1}; c2, c3 at row
//     l / 4 + 8, the same columns.
// Each row address must be 16-byte aligned. A row stride whose byte count
// is an odd multiple of 16 keeps the eight rows of a matrix on distinct
// bank groups.

#pragma once

#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8 x 8 b16 matrices; lane l gives a row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b over one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_bf16
