// Pieces shared by the PSI matmuls' tensor-core kernels (csrc/psi_matmul.cu
// and csrc/psi_rows.cu): the block's warps and its largest cluster, the
// MMA and its operands' conversions (codes, and bit-planes' words, their
// transpose and their weights), and the epilogue's store.  Each kernel's
// two bf16 routes give the same bits because they share these, put the
// same K rows in the same k slots and sum in one order.
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

// One step of an 8 x 8 bit transpose (Hacker's Delight, transpose8),
// done in four byte lanes at once: bits j + S of `lo` (j in the lower half
// of each 2S-bit field, the bits MASK selects) trade places with bits j of
// `hi`.  A shift and a lop3 for each word.
template <int S, uint32_t MASK>
__device__ __forceinline__ void transpose_step(uint32_t& lo, uint32_t& hi) {
  const uint32_t l = (lo & ~(MASK << S)) | ((hi << S) & (MASK << S));
  hi = (hi & ~MASK) | ((lo >> S) & MASK);
  lo = l;
}

// The 32-bit word at p: columns n .. n+3 of a plane row (0 past the edges;
// bytewise where rows are not word aligned).
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p,
                                              bool row_ok, int n, int N) {
  if (!row_ok || n >= N) return 0u;
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N) v |= (uint32_t)__ldg(p + c) << (8 * c);
    return v;
  }
}

// The bit-plane decode of kernel 2 (csrc/psi_matmul.cu, design (2)), in
// three steps for lane (g, t) of a 64-K group: P[b] and Q[b] are plane b's
// words at plane rows ra = 8*grp + t and rb = ra + 4, channels n .. n+3.
// (a) tile_words: A tile a's words (a = 0: channels n, n+1; a = 1: n+2,
//     n+3), byte lanes [ch @ ra, ch+1 @ ra, ch @ rb, ch+1 @ rb]; planes
//     past BITS are 0.
template <int BITS>
__device__ __forceinline__ void tile_words(const uint32_t (&P)[BITS],
                                           const uint32_t (&Q)[BITS], int a,
                                           uint32_t (&W)[8]) {
  const uint32_t sel = a ? 0x7632u : 0x5410u;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    W[b] = b < BITS ? __byte_perm(P[b % BITS], Q[b % BITS], sel) : 0u;
}

// (b) per byte lane, an 8 x 8 bit transpose (plane b, bit j) -> (j, b):
//     afterwards W[j] holds in each byte lane the offset-binary weight of
//     K row 8*(ra or rb) + j.
__device__ __forceinline__ void transpose_words(uint32_t (&W)[8]) {
  transpose_step<4, 0x0F0F0F0Fu>(W[0], W[4]);
  transpose_step<4, 0x0F0F0F0Fu>(W[1], W[5]);
  transpose_step<4, 0x0F0F0F0Fu>(W[2], W[6]);
  transpose_step<4, 0x0F0F0F0Fu>(W[3], W[7]);
  transpose_step<2, 0x33333333u>(W[0], W[2]);
  transpose_step<2, 0x33333333u>(W[1], W[3]);
  transpose_step<2, 0x33333333u>(W[4], W[6]);
  transpose_step<2, 0x33333333u>(W[5], W[7]);
  transpose_step<1, 0x55555555u>(W[0], W[1]);
  transpose_step<1, 0x55555555u>(W[2], W[3]);
  transpose_step<1, 0x55555555u>(W[4], W[5]);
  transpose_step<1, 0x55555555u>(W[6], W[7]);
}

// (c) the signed weights of word v = W[2q + h] as two A fragment
//     registers of MMA k-step q: rows g (bytes 0, 2: channel ch) and g+8
//     (bytes 1, 3: ch+1), each the bf16 pair {K row 8ra + 2q + h, 8rb +
//     2q + h} (k slots 2t, 2t+1 for h = 0, 2t+8, 2t+9 for h = 1).  0x43vv
//     is bf16 128 + v (v < 128); one subtract of 128 + 2^(BITS-1) leaves
//     the weight, exactly.
template <int BITS>
__device__ __forceinline__ void tile_weights(uint32_t v, uint32_t& row_g,
                                             uint32_t& row_g8) {
  constexpr uint32_t kBias = (0x4300u | (1u << (BITS - 1))) * 0x10001u;
  constexpr uint32_t kExp = 0x43434343u;
  row_g = bf16x2_sub(__byte_perm(v, kExp, 0x4240), kBias);
  row_g8 = bf16x2_sub(__byte_perm(v, kExp, 0x4341), kBias);
}

// The B fragment of MMA k-step q for one token: wa, wb are word q of x's
// 16 bytes at K rows 8ra .. 8ra+7 and 8rb .. 8rb+7; b0 holds K rows 8ra +
// 2q, 8rb + 2q (k slots 2t, 2t+1), b1 rows 8ra + 2q + 1, 8rb + 2q + 1
// (2t+8, 2t+9): the k slots of tile_weights.
__device__ __forceinline__ void x_pair(uint32_t wa, uint32_t wb,
                                       uint32_t& b0, uint32_t& b1) {
  b0 = __byte_perm(wa, wb, 0x5410);
  b1 = __byte_perm(wa, wb, 0x7632);
}

}  // namespace
