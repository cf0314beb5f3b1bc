// Pieces shared by the PSI matmuls' tensor-core kernels (csrc/psi_matmul.cu
// and csrc/psi_rows.cu): the block's warps and its largest cluster, the
// MMA and its operands' conversions, and the epilogue's store.  Kernel 1's
// two bf16 routes give the same bits because they share these and sum in
// one order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 8;            // warps per block, one channel tile
constexpr int kMaxSplit = 8;            // K splits: a portable cluster
constexpr int kStepK = 16;              // K rows per codes step (one k-step)

// The epilogue's store of one output: the f32 sum times its scale, rounded
// to bf16 into `out`, or as it is into `out32` when the caller asked for an
// f32 output (a row-parallel partial sum, added over ranks before its one
// cast).  Rounding is round-to-nearest-even either way, so the f32 output
// cast to bf16 is the bf16 output bit for bit.
__device__ __forceinline__ void store_out(__nv_bfloat16* out, float* out32,
                                          size_t i, float y) {
  if (out32 != nullptr)
    out32[i] = y;
  else
    out[i] = __float2bfloat16(y);
}

// bf16x2 a - b (exact here: small integers)
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte c of code words p and q (two K rows of one channel) as a bf16 pair
// {code of p, code of q}.  r holds the two bytes in the low byte of each
// 16-bit lane; M = 0x43 | (c & 0x7f) is bf16 128 + (c & 127) and S = 0x43 |
// (c & 0x80) is 128 or 256 by the sign bit, so M - S is the code, exactly.
__device__ __forceinline__ uint32_t code_pair(uint32_t p, uint32_t q, int c) {
  const uint32_t r = __byte_perm(p, q, (4u + c) * 0x1100u | c * 0x11u);
  return bf16x2_sub((r & 0x007F007Fu) | 0x43004300u,
                    (r & 0x00800080u) | 0x43004300u);
}

}  // namespace
