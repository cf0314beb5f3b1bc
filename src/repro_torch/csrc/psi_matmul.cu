// PSI matmul kernels for Hopper (sm_90a): y[M,N] = (x[M,K] @ W[K,N]) * scale[N]
// with W held in PSI serving format and expanded in registers.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   psi_matmul_codes  <- repro/kernels/psi_matmul.py::psi_matmul_int8
//                        (psi_matmul.py:153, body _int8_kernel; int8 codes
//                        (K, N), -128..127)
//   psi_matmul_packed <- repro/kernels/psi_matmul.py::psi_matmul_packed
//                        (psi_matmul.py:197, body _packed_kernel; uint8
//                        bit-planes (bits, K/8, N), bit j of planes[b][i][n]
//                        is bit b of the offset-binary weight 8i+j, bits 2..7)
//
// Bound on the H100: on the serving path M is the decode batch (1-16), so the
// work is a GEMV over the weight: every code byte (psi8 reads 1 byte a
// weight) or bits/8 plane bytes per weight is read once from HBM and used M
// times.  The bound is the weight bytes over the memory rate (wq at psi8,
// 16.8 MB -> 5.0 us at 3.35 TB/s; a whole qwen3-8b decode step 2.27 ms at
// psi8, 1.42 ms at psi5, whose planes are 5/8 of that).  At 3.35 TB/s an SM
// must take in ~14.5 bytes a clock, so the work per byte has to stay well
// inside the integer pipe's 64 lanes a clock, and the reads must keep
// enough whole lines in flight.  Prefill (M = prompt tokens) is the only
// place the arithmetic (2*M*K*N) could matter.
//
// Three kernels live here; x's dtype picks the route.
//
// (1) psi_gemm_kernel, CUDA cores: x f32 (the reduced configurations; a TF32
// product would miss their 1e-5 tolerance), for codes and planes alike.
//   * One 256-thread block per (32-column N tile, BM-row M tile).  Lanes read
//     4 adjacent columns per load (char4 / one 32-bit word per plane), so the
//     8 threads of one K row fetch one 32-byte sector and a warp four rows.
//     When N % 4 != 0 (or W is not 4-byte aligned) the rows are not word
//     aligned, so a second instantiation (VEC = false, BM = 8 only) reads
//     the same 4 columns byte by byte instead, masking the columns past N.
//   * The TPU's sequential K grid axis becomes a loop inside the block: the
//     32 K-lanes of the block stride over K, each accumulating BM x 4 f32
//     partial sums in registers; one shared-memory pass reduces the K-lanes,
//     applies scale[n] once and stores f32.
//   * x is staged in shared memory as f32, 512 K values per pass; BM (1, 4
//     or 8) follows M.
//
// (2) psi_gemm_mma_kernel, tensor cores: planes with bf16 x (kernel 2 on the
// serving path).  Rebuilding each weight bit by bit on CUDA cores (~3*bits
// integer ops per weight, then an FMA per token) set the pace of design (1)
// at about 9 % of the byte bound, so this route is built around the
// decode's instruction count:
//   * out^T = W^T x^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate): 16
//     output channels on the MMA's M side, 8 tokens on its N side, so a
//     decode step of 1-8 tokens fills one N tile; larger M loops over up to
//     NT token tiles per block (prefill).  PSI weights and codes are
//     integers with |w| <= 128, exact in bf16, so every product is exact
//     and only the order of the f32 sum differs from the plain version.
//   * A word-parallel bit-plane decode.  The MMA sums over k, so the k slots
//     of a fragment may stand for any K as long as A and B agree.  They are
//     chosen so that lane (g, t) of a warp owns plane bytes, not bits: per
//     64-K group it loads, per plane, the 32-bit words P = planes[b][i0+t]
//     [n0+4g .. +3] and Q = planes[b][i0+4+t][same columns] straight from
//     device memory (8 lanes of one row read one 32-byte sector; the next
//     group's words are in flight while this one decodes), so its four
//     channels 4g..4g+3 are the rows g, g+8 of two 16-row A tiles.  One prmt
//     pairs P and Q per A tile, giving words of four byte lanes (two
//     channels x K rows 8(i0+t)+j and 8(i0+4+t)+j); an 8 x 8 bit transpose
//     of the BITS plane words (three delta-swap stages, a shift and a lop3
//     per word per swap, on all four byte lanes at once) leaves word j
//     holding the four offset-binary weights of bit j.  Two prmt turn the
//     byte lanes into bf16 pairs 0x43vv (= 128+v, v < 128) and one bf16x2
//     subtract of 128 + 2^(bits-1) leaves the signed weight: about 2.5
//     integer ops per weight at psi5, against ~3*bits + 2 in design (1).  x
//     is read as two 16-byte loads per token and group and paired in the
//     same K order by prmt.
//   * Enough blocks at every shape: a block is 8 warps on one 32-channel
//     tile; the warps take the block's 64-K groups in turn and sum through
//     shared memory in warp order.  Where N/32 tiles cannot give one block
//     per SM, K is split across the blocks of a cluster (at most 8 splits
//     of `chunk` groups, chosen on the host from K and N only:
//     kernels/psi_matmul.py::split_plan), which add their sums in split
//     order through distributed shared memory.  No atomics and no second
//     pass: a row's output depends only on its own x row and W, bit for
//     bit, whatever M or the other rows are.
//   * What bounds it now: the integer pipe (64 lanes per clock per SM, so
//     ~2.5 integer ops a weight at psi5 take about as long as streaming its
//     5/8 byte), and at the small shapes the start-up of a launch; PERF.md
//     has the measured times.
//   * Edges are masked, never padded: columns past N load 0 and are never
//     stored; plane rows past K/8 load 0 (decoding to -2^(bits-1)) against x
//     loaded as 0, so they add exact zeros; tokens past M load x = 0 and are
//     never stored.  Unaligned rows (N % 4 != 0 or planes not 4-byte
//     aligned) take a byte-load instantiation (VEC = false).
//
// (3) psi_gemm_codes_kernel, tensor cores: int8 codes with bf16 x (kernel 1
// on the serving path, psi8).  Design (1) turned each code into a float and
// did an FMA per token on CUDA cores, in one block per 32 columns (32
// blocks at N = 1024 on 132 SMs), at 4-52 % of the byte bound.  At 1 byte a
// weight the decode is cheap and the reads set the pace, so this route is
// built around them:
//   * The same out^T = W^T x^T on mma.sync.m16n8k16, cluster split-K and
//     fixed summation order as (2), so rows stay batch invariant.
//   * Wide rows.  Design (2)'s loads take a 32-byte piece of each of four
//     rows; at 1 byte a weight that held a copy of (2) for codes well below
//     the memory rate even at lm_head.  Here a block covers 128 channels
//     (a whole 128-byte line of each code row) where N/128 tiles alone give
//     two blocks per SM (lm_head), else 64, and lane (g, t) loads 16 (8)
//     bytes, channels 16g (8g) .. of the K rows 16s + 4t .. +3 of each 16-K
//     step s: 8 lanes read one row's piece of the tile.  The k slots 2t,
//     2t+1 of the MMA stand for rows 16s + 4t, +1 and the slots 2t+8, 2t+9
//     for +2, +3, so x is one 8-byte load per token and step that is the B
//     fragment as it is, and the lane's channels are the rows g, g+8 of 8
//     (4) A tiles.
//   * int8 to bf16 in 1.5 integer ops a weight: for two K rows p, q of a
//     channel, one prmt puts byte c of each into the low byte of a 16-bit
//     lane; two lop3 make M = 0x43 | (c & 0x7f) (bf16 128 + (c & 127)) and
//     S = 0x43 | (c & 0x80) (128 or 256 by the sign bit); one bf16x2
//     subtract M - S leaves the code exactly.  (0x43vv alone is 128 + v
//     only for v < 128: bit 7 of an int8 would land in bf16's exponent.)
//   * The 8 warps of a block take the steps of its split in turn, two steps
//     in flight per warp in two register sets; their sums are added in a
//     fixed tree through shared memory.  Token tiles (NT = 1 for M <= 8, 2
//     above; more in separate blocks) are neighbours in the grid, so a
//     prefill's tiles share the codes through L2.  The plan (tile, split)
//     is kernels/psi_matmul.py::codes_split_plan, from K and N only.
//   * What bounds it now: the reads, short of the memory rate at the
//     qwen3-8b shapes, and a launch's start-up and cluster reduction at the
//     small shapes.  More steps in flight, a cp.async ring, a TMA pipeline
//     with a producer warp and other grid orders did not help (PERF.md).
//   * Edges are masked, never padded: columns past N load 0 and are never
//     stored; code rows past K load 0 against x loaded as 0 (a 0 code
//     times stale x could be NaN); tokens past M load x = 0 and are never
//     stored.  Rows not 16- (8-) byte aligned (N % 16 (8) != 0 or codes
//     misaligned) take a byte-load instantiation (VEC = false); x rows not
//     8-byte aligned (K % 4 != 0 or a misaligned x) are read one element at
//     a time (XVEC = false).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                 // columns per block
constexpr int kColGroups = kBN / 4;     // 8 lanes of 4 columns
constexpr int kKLanes = kThreads / kColGroups;   // 32 lanes over K
constexpr int kKC = 512;                // K values of x staged per pass

// BITS == 8: W is int8 codes (K, N), one unit = one K row.
// BITS < 8:  W is uint8 planes (BITS, K/8, N), one unit = 8 K rows.
template <int BITS, int BM, bool VEC>
__global__ void __launch_bounds__(kThreads)
psi_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int K, int N) {
  constexpr int UK = BITS == 8 ? 1 : 8;          // K rows per unit
  constexpr int kSmem = (BM * kKC > kKLanes * BM * kBN) ? BM * kKC
                                                        : kKLanes * BM * kBN;
  __shared__ float smem[kSmem];
  float* xs = smem;                              // [BM][kKC]

  const int t = threadIdx.x;
  const int cg = t % kColGroups;
  const int kl = t / kColGroups;
  const int n0 = blockIdx.x * kBN + cg * 4;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = n0 < N;                    // columns past N masked
  const int units = K / UK;                      // K % 8 == 0 when packed

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    for (int idx = t; idx < BM * kKC; idx += kThreads) {
      const int m = idx / kKC, kk = idx % kKC;
      const int row = m0 + m, k = k0 + kk;
      xs[idx] = (row < M && k < K) ? x[(size_t)row * K + k] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int u0 = k0 / UK;
    const int u1 = min(units, (k0 + kKC) / UK);
#pragma unroll 4
    for (int u = u0 + kl; u < u1; u += kKLanes) {
      const int kk = (u - u0) * UK;              // chunk-relative K offset
      if constexpr (BITS == 8) {
        const uint8_t* row = w + (size_t)u * N + n0;
        float wv[4];
        if constexpr (VEC) {
          const char4 c4 = *reinterpret_cast<const char4*>(row);
          wv[0] = c4.x; wv[1] = c4.y; wv[2] = c4.z; wv[3] = c4.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wv[c] = n0 + c < N ? (float)(int8_t)row[c] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = xs[m * kKC + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      } else {
        const size_t plane_stride = (size_t)units * N;
        uint32_t p[BITS];
#pragma unroll
        for (int b = 0; b < BITS; ++b) {
          const uint8_t* row = w + b * plane_stride + (size_t)u * N + n0;
          if constexpr (VEC) {
            p[b] = *reinterpret_cast<const uint32_t*>(row);
          } else {
            // columns past N stay 0 and decode to -2^(BITS-1) in their own
            // accumulators, which the epilogue never stores
            p[b] = 0;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n0 + c < N) p[b] |= (uint32_t)row[c] << (8 * c);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float wv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int v = 0;
#pragma unroll
            for (int b = 0; b < BITS; ++b)
              v |= (int)((p[b] >> (c * 8 + j)) & 1u) << b;
            wv[c] = (float)(v - (1 << (BITS - 1)));
          }
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const float xv = xs[m * kKC + kk + j];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
          }
        }
      }
    }
  }

  // reduce the K-lanes: red[kl][m][col]
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(kl * BM + m) * kBN + cg * 4 + c] = acc[m][c];
  __syncthreads();
  for (int idx = t; idx < BM * kBN; idx += kThreads) {
    const int m = idx / kBN, col = idx % kBN;
    const int row = m0 + m, n = blockIdx.x * kBN + col;
    if (row >= M || n >= N) continue;
    float s = 0.f;
    for (int l = 0; l < kKLanes; ++l) s += red[(l * BM + m) * kBN + col];
    out[(size_t)row * N + n] = s * scale[n];
  }
}

// ---------------------------------------------------------------------------
// (2) Tensor-core route of kernel 2 (bf16 x).
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 8;            // warps per block, one channel tile
constexpr int kMmaBN = 32;              // channels per block (two A tiles)
constexpr int kGroupRows = 8;           // plane rows per group (64 K)
constexpr int kMaxSplit = 8;            // K splits: a portable cluster

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

// x[tok][8*row .. 8*row+7] as 16 bytes (0 past M or past K/8 rows)
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x,
                                         int tok, int M, int row, int rows,
                                         int K) {
  if (tok >= M || row >= rows) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(x + (size_t)tok * K + 8 * row));
}

// Grid (ceil(N/32), n_split, ceil(M/(8*NT))), 8 warps, launched as clusters
// of (1, n_split, 1): split s takes the 64-K groups [s*chunk, min(groups,
// (s+1)*chunk)) and warp w groups w, w+8, ... of them.  Each block sums its
// warps in shared memory; the blocks of a cluster then add the splits, in
// split order, through distributed shared memory, and store bf16.  Up to two
// token tiles, registers are held to three blocks per SM; four tiles' 32
// accumulators need more.
template <int BITS, int NT, bool VEC>
__global__ void __launch_bounds__(kMmaWarps * 32, NT == 4 ? 1 : 3)
psi_gemm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ planes,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int chunk) {
  __shared__ float red[kMmaWarps][NT * 8 * kMmaBN];   // [warp][tok][ch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = K >> 3;                          // plane rows
  const int groups = (rows + kGroupRows - 1) / kGroupRows;
  const int gs = blockIdx.y * chunk;
  const int ge = min(groups, gs + chunk);
  const int nb = blockIdx.x * kMmaBN;
  const int n = nb + 4 * g;                         // this lane's 4 channels
  const int m0 = blockIdx.z * 8 * NT;
  const size_t pstride = (size_t)rows * N;
  // bf16 pairs (128 + 2^(BITS-1)) and the 0x43 exponent byte of 128 + v
  constexpr uint32_t kBias = (0x4300u | (1u << (BITS - 1))) * 0x10001u;
  constexpr uint32_t kExp = 0x43434343u;

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][nt][c] = 0.f;

  // plane 0, row t, this lane's columns; a group is 8 rows further on
  const uint8_t* pw = planes + (size_t)t * N + n;
  const size_t q_off = (size_t)4 * N;
  // P: row 8*grp + t of every plane, Q: row 8*grp + 4 + t
  auto load_group = [&](int grp, uint32_t(&P)[BITS], uint32_t(&Q)[BITS]) {
    const uint8_t* p = pw + (size_t)grp * 8 * N;
    const bool pa = grp * 8 + t < rows, pb = grp * 8 + 4 + t < rows;
#pragma unroll
    for (int b = 0; b < BITS; ++b, p += pstride) {
      P[b] = load_word<VEC>(p, pa, n, N);
      Q[b] = load_word<VEC>(p + q_off, pb, n, N);
    }
  };
  uint32_t P[BITS], Q[BITS];
  int grp = gs + warp;
  if (grp < ge) load_group(grp, P, Q);
  for (; grp < ge; grp += kMmaWarps) {
    const int ra = grp * 8 + t, rb = ra + 4;
    // the two A tiles' words, byte lanes [ch 4g|4g+2 @ ra, ch 4g+1|4g+3 @
    // ra, the same @ rb]; planes past BITS are 0
    uint32_t W[2][8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t p = P[b % BITS], q = Q[b % BITS];
      W[0][b] = b < BITS ? __byte_perm(p, q, 0x5410) : 0u;
      W[1][b] = b < BITS ? __byte_perm(p, q, 0x7632) : 0u;
    }
    if (grp + kMmaWarps < ge) load_group(grp + kMmaWarps, P, Q);  // prefetch
    uint4 xa[NT], xb[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int tok = m0 + nt * 8 + g;
      xa[nt] = load_x8(x, tok, M, ra, rows, K);
      xb[nt] = load_x8(x, tok, M, rb, rows, K);
    }
    // per byte lane, an 8 x 8 bit transpose (plane b, bit j) -> (j, b):
    // afterwards W[a][j] holds in each byte lane the offset-binary weight of
    // K row 8*(ra or rb) + j
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      transpose_step<4, 0x0F0F0F0Fu>(W[a][0], W[a][4]);
      transpose_step<4, 0x0F0F0F0Fu>(W[a][1], W[a][5]);
      transpose_step<4, 0x0F0F0F0Fu>(W[a][2], W[a][6]);
      transpose_step<4, 0x0F0F0F0Fu>(W[a][3], W[a][7]);
      transpose_step<2, 0x33333333u>(W[a][0], W[a][2]);
      transpose_step<2, 0x33333333u>(W[a][1], W[a][3]);
      transpose_step<2, 0x33333333u>(W[a][4], W[a][6]);
      transpose_step<2, 0x33333333u>(W[a][5], W[a][7]);
      transpose_step<1, 0x55555555u>(W[a][0], W[a][1]);
      transpose_step<1, 0x55555555u>(W[a][2], W[a][3]);
      transpose_step<1, 0x55555555u>(W[a][4], W[a][5]);
      transpose_step<1, 0x55555555u>(W[a][6], W[a][7]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {                   // MMA k-step: bits 2q, 2q+1
      uint32_t afrag[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows g (bytes 0, 2) and g+8 (bytes 1, 3) as bf16 pairs
          const uint32_t v = W[a][2 * q + h];
          afrag[a][2 * h] = bf16x2_sub(__byte_perm(v, kExp, 0x4240),
                                       kBias);
          afrag[a][2 * h + 1] = bf16x2_sub(__byte_perm(v, kExp, 0x4341),
                                           kBias);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t wa = q == 0 ? xa[nt].x : q == 1 ? xa[nt].y
                          : q == 2 ? xa[nt].z : xa[nt].w;
        const uint32_t wb = q == 0 ? xb[nt].x : q == 1 ? xb[nt].y
                          : q == 2 ? xb[nt].z : xb[nt].w;
        // K rows 8ra+2q, 8rb+2q and 8ra+2q+1, 8rb+2q+1
        const uint32_t b0 = __byte_perm(wa, wb, 0x5410);
        const uint32_t b1 = __byte_perm(wa, wb, 0x7632);
        mma_bf16(acc[0][nt], afrag[0], b0, b1);
        mma_bf16(acc[1][nt], afrag[1], b0, b1);
      }
    }
  }

  // C fragment: acc[a][nt] = {(row g, tok 2t), (row g, tok 2t+1),
  // (row g+8, tok 2t), (row g+8, tok 2t+1)}; A tile a row g is channel
  // 4g + 2a, row g+8 channel 4g + 2a + 1
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* r = red[warp] + (nt * 8 + 2 * t) * kMmaBN + 4 * g + 2 * a;
      r[0] = acc[a][nt][0];
      r[kMmaBN] = acc[a][nt][1];
      r[1] = acc[a][nt][2];
      r[kMmaBN + 1] = acc[a][nt][3];
    }
  __syncthreads();
  // the block's sum over its warps, in warp order, into red[0]
  for (int idx = threadIdx.x; idx < NT * 8 * kMmaBN;
       idx += kMmaWarps * 32) {
    float s = red[0][idx];
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) s += red[w][idx];
    red[0][idx] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // the splits' sums, in split order: the cluster's blocks share the
  // outputs of the tile between them
  const int n_split = (int)cluster.num_blocks();
  for (int idx = cluster.block_rank() * kMmaWarps * 32 + threadIdx.x;
       idx < NT * 8 * kMmaBN; idx += n_split * kMmaWarps * 32) {
    const int ch = idx % kMmaBN, row = m0 + idx / kMmaBN;
    const int col = nb + ch;
    if (row >= M || col >= N) continue;
    float s = 0.f;
    for (int r = 0; r < n_split; ++r)
      s += cluster.map_shared_rank(&red[0][0], r)[idx];
    out[(size_t)row * N + col] = __float2bfloat16(s * scale[col]);
  }
  cluster.sync();              // keep red alive until the cluster has read it
}

template <int BITS, int NT, bool VEC>
int launch_mma_t(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, int chunk, int n_split,
                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kMmaBN - 1) / kMmaBN, n_split,
                     (M + 8 * NT - 1) / (8 * NT));
  cfg.blockDim = dim3(kMmaWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, psi_gemm_mma_kernel<BITS, NT, VEC>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      K, N, chunk);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int BITS, bool VEC>
int launch_mma_v(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, int chunk, int n_split,
                 cudaStream_t s) {
  if (M <= 8)
    return launch_mma_t<BITS, 1, VEC>(x, w, scale, out, M, K, N, chunk,
                                      n_split, s);
  if (M <= 16)
    return launch_mma_t<BITS, 2, VEC>(x, w, scale, out, M, K, N, chunk,
                                      n_split, s);
  return launch_mma_t<BITS, 4, VEC>(x, w, scale, out, M, K, N, chunk,
                                    n_split, s);
}

// The tensor-core route: x bf16 (16-byte aligned), planes (BITS, K/8, N).
template <int BITS>
int launch_mma(const void* x, const void* w, const void* scale, void* out,
               int M, int K, int N, int chunk, cudaStream_t stream) {
  const int groups = (K / 8 + kGroupRows - 1) / kGroupRows;
  if (chunk < 1 || chunk > groups || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_split = (groups + chunk - 1) / chunk;
  if (n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
  if (N % 4 || reinterpret_cast<uintptr_t>(w) % 4)
    return launch_mma_v<BITS, false>(x, w, scale, out, M, K, N, chunk,
                                     n_split, stream);
  return launch_mma_v<BITS, true>(x, w, scale, out, M, K, N, chunk, n_split,
                                  stream);
}

// ---------------------------------------------------------------------------
// (3) Tensor-core route of kernel 1 (int8 codes, bf16 x).
// ---------------------------------------------------------------------------
constexpr int kStepK = 16;              // K rows per step (one MMA k-step)

// Byte c of code words p and q (two K rows of one channel) as a bf16 pair
// {code of p, code of q}.  r holds the two bytes in the low byte of each
// 16-bit lane; M = 0x43 | (c & 0x7f) is bf16 128 + (c & 127) and S = 0x43 |
// (c & 0x80) is 128 or 256 by the sign bit, so M - S is the code, exactly.
__device__ __forceinline__ uint32_t code_pair(uint32_t p, uint32_t q, int c) {
  const uint32_t r = __byte_perm(p, q, (4u + c) * 0x1100u | c * 0x11u);
  return bf16x2_sub((r & 0x007F007Fu) | 0x43004300u,
                    (r & 0x00800080u) | 0x43004300u);
}

// Columns n .. n+4*NW-1 (NW = 2 or 4) of one code row as NW words (0 past
// the edges; bytewise where rows are not 4*NW-byte aligned).  The codes are
// read once: no L1 allocation, and L2 fetches 256 bytes at a time (the
// neighbouring blocks' columns), which measured a few per cent faster.
template <int NW, bool VEC>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ p,
                                         bool row_ok, int n, int N,
                                         uint32_t (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = 0u;
  if (!row_ok || n >= N) return;
  if constexpr (VEC && NW == 4) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  } else if constexpr (VEC && NW == 2) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  } else {
#pragma unroll
    for (int c = 0; c < 4 * NW; ++c)
      if (n + c < N) w[c / 4] |= (uint32_t)__ldg(p + c) << (8 * (c % 4));
  }
}

// x[tok][k .. k+3] as 8 bytes, 0 past M and past K: one 8-byte load where
// x rows are 8-byte aligned (XVEC; then K % 4 == 0), else element by element.
template <bool XVEC>
__device__ __forceinline__ uint2 load_x4(const __nv_bfloat16* __restrict__ x,
                                         int tok, int M, int k, int K) {
  if (tok >= M || k >= K) return make_uint2(0u, 0u);
  const __nv_bfloat16* p = x + (size_t)tok * K + k;
  if constexpr (XVEC) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = k + i < K ? __ldg(h + i) : 0u;
    return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
  }
}

// Grid (ceil(M/(8*NT)), n_split, ceil(N/(32*NW))), 8 warps, launched as
// clusters of (1, n_split, 1); the token tiles of a channel tile are
// neighbours in the grid, so a prefill's tiles read the codes while the
// first has them in L2.  Lane (g, t) owns channels n = nb+4*NW*g .. +4*NW-1
// (8 lanes read the tile's piece of a code row) and, of each 16-K step, the
// K rows k = 16s + 4t .. +3: rows k, k+1 are the k slots 2t, 2t+1 of the
// MMA and rows k+2, k+3 the slots 2t+8, 2t+9, so x is one 8-byte load per
// token that is the B fragment as it is.  Its channels are the rows g, g+8
// of 2*NW A tiles (tile a: channels n + 2a, n + 2a + 1).  Split s takes the
// steps [s*chunk, min(steps, (s+1)*chunk)) and warp w steps w, w+8, ... of
// them, two at a time in flight: the codes and x of a step land in one of
// two register sets while the other decodes.  The warps' sums are added in
// a fixed tree through shared memory, then the splits' in split order
// through distributed shared memory.
template <int NT, int NW, bool VEC, bool XVEC>
__global__ void __launch_bounds__(kMmaWarps * 32, NT == 1 ? 3 : 2)
psi_gemm_codes_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      int chunk) {
  constexpr int kTN = 32 * NW;                      // channels per block
  constexpr int kTiles = 2 * NW;                    // A tiles per warp
  constexpr int R = kTiles * NT * 4;                // accumulators per lane
  __shared__ float red[kMmaWarps / 2][R][32];       // [warp][acc][lane]
  __shared__ float sum[NT * 8][kTN];                // [tok][ch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (K + kStepK - 1) / kStepK;
  const int ss = blockIdx.y * chunk;
  const int se = min(steps, ss + chunk);
  const int nb = blockIdx.z * kTN;
  const int n = nb + 4 * NW * g;                    // this lane's channels
  const int m0 = blockIdx.x * 8 * NT;

  float acc[kTiles][NT][4];
#pragma unroll
  for (int a = 0; a < kTiles; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][nt][c] = 0.f;

  // K rows 16s + 4t + i (i = 0..3) at this lane's columns
  const uint8_t* cw = codes + (size_t)(4 * t) * N + n;
  // step s's code rows k .. k+3 (k = 16s + 4t) and x[tok][k .. k+3]
  auto load_step = [&](int s, uint32_t(&C)[4][NW], uint2(&xv)[NT]) {
    if (s >= se) return;
    const uint8_t* p = cw + (size_t)s * kStepK * N;
    const int k = s * kStepK + 4 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_row<NW, VEC>(p + (size_t)i * N, k + i < K, n, N, C[i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      xv[nt] = load_x4<XVEC>(x, m0 + nt * 8 + g, M, k, K);
  };
  // one step's codes (rows k .. k+3) into the MMAs
  auto mma_step = [&](const uint32_t(&C)[4][NW], const uint2(&xv)[NT]) {
#pragma unroll
    for (int a = 0; a < kTiles; ++a) {
      // tile a: channel n + 2a (byte c of word a/2) on row g, the next
      // channel on row g+8
      const int wi = a / 2, c = 2 * (a % 2);
      const uint32_t p0 = C[0][wi], p1 = C[1][wi];
      const uint32_t p2 = C[2][wi], p3 = C[3][wi];
      const uint32_t afrag[4] = {code_pair(p0, p1, c),
                                 code_pair(p0, p1, c + 1),
                                 code_pair(p2, p3, c),
                                 code_pair(p2, p3, c + 1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[a][nt], afrag, xv[nt].x, xv[nt].y);
    }
  };

  // kSets steps in flight: while one register set decodes, the others'
  // loads are out, and each set is refilled as soon as it has been used
  // (the loop over d is unrolled, so the sets stay in registers)
  constexpr int kSets = 2;
  uint32_t cs[kSets][4][NW];
  uint2 xs[kSets][NT];
  int s = ss + warp;
#pragma unroll
  for (int d = 0; d < kSets; ++d) load_step(s + d * kMmaWarps, cs[d], xs[d]);
  for (; s < se; s += kSets * kMmaWarps) {
#pragma unroll
    for (int d = 0; d < kSets; ++d) {
      if (s + d * kMmaWarps < se) {
        mma_step(cs[d], xs[d]);
        load_step(s + (kSets + d) * kMmaWarps, cs[d], xs[d]);
      }
    }
  }

  // the warps' sums, in a fixed tree (warp w += warp w + h for h = 4, 2,
  // 1), so the buffer holds half the warps' accumulators, not all of them
#pragma unroll
  for (int h = kMmaWarps / 2; h >= 1; h /= 2) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int a = 0; a < kTiles; ++a)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[warp - h][(a * NT + nt) * 4 + c][lane] = acc[a][nt][c];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int a = 0; a < kTiles; ++a)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][nt][c] += red[warp][(a * NT + nt) * 4 + c][lane];
    }
    __syncthreads();
  }
  // C fragment: acc[a][nt] = {(row g, tok 2t), (row g, tok 2t+1),
  // (row g+8, tok 2t), (row g+8, tok 2t+1)}; row g of tile a is channel
  // 4*NW*g + 2a, row g+8 channel 4*NW*g + 2a + 1
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < kTiles; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* r = &sum[nt * 8 + 2 * t][4 * NW * g + 2 * a];
        r[0] = acc[a][nt][0];
        r[kTN] = acc[a][nt][1];
        r[1] = acc[a][nt][2];
        r[kTN + 1] = acc[a][nt][3];
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // the splits' sums, in split order: the cluster's blocks share the
  // outputs of the tile between them
  const int n_split = (int)cluster.num_blocks();
  for (int idx = cluster.block_rank() * kMmaWarps * 32 + threadIdx.x;
       idx < NT * 8 * kTN; idx += n_split * kMmaWarps * 32) {
    const int ch = idx % kTN, row = m0 + idx / kTN;
    const int col = nb + ch;
    if (row >= M || col >= N) continue;
    float v = 0.f;
    for (int r = 0; r < n_split; ++r)
      v += cluster.map_shared_rank(&sum[0][0], r)[idx];
    out[(size_t)row * N + col] = __float2bfloat16(v * scale[col]);
  }
  cluster.sync();              // keep sum alive until the cluster has read it
}

template <int NT, int NW, bool VEC, bool XVEC>
int launch_codes_t(const void* x, const void* w, const void* scale,
                   void* out, int M, int K, int N, int chunk, int n_split,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + 8 * NT - 1) / (8 * NT), n_split,
                     (N + 32 * NW - 1) / (32 * NW));
  cfg.blockDim = dim3(kMmaWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, psi_gemm_codes_kernel<NT, NW, VEC, XVEC>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      K, N, chunk);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int NW, bool XVEC>
int launch_codes_v(const void* x, const void* w, const void* scale,
                   void* out, int M, int K, int N, int chunk, int n_split,
                   cudaStream_t s) {
  const bool vec =
      N % (4 * NW) == 0 && reinterpret_cast<uintptr_t>(w) % (4 * NW) == 0;
  if (M <= 8)
    return vec ? launch_codes_t<1, NW, true, XVEC>(x, w, scale, out, M, K, N,
                                                   chunk, n_split, s)
               : launch_codes_t<1, NW, false, XVEC>(x, w, scale, out, M, K,
                                                    N, chunk, n_split, s);
  return vec ? launch_codes_t<2, NW, true, XVEC>(x, w, scale, out, M, K, N,
                                                 chunk, n_split, s)
             : launch_codes_t<2, NW, false, XVEC>(x, w, scale, out, M, K, N,
                                                  chunk, n_split, s);
}

// The codes' tensor-core route: x bf16, codes (K, N) int8, any K and N;
// channel tiles of `tile` (64 or 128) columns, K in `chunk`-step splits (16
// K rows a step).
int launch_codes(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, int tile, int chunk,
                 cudaStream_t stream) {
  const int steps = (K + kStepK - 1) / kStepK;
  if (chunk < 1 || chunk > steps || (tile != 64 && tile != 128))
    return (int)cudaErrorInvalidValue;
  const int n_split = (steps + chunk - 1) / chunk;
  if (n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  using Fn = int (*)(const void*, const void*, const void*, void*, int, int,
                     int, int, int, cudaStream_t);
  const Fn fn = tile == 128 ? (xvec ? launch_codes_v<4, true>
                                    : launch_codes_v<4, false>)
                            : (xvec ? launch_codes_v<2, true>
                                    : launch_codes_v<2, false>);
  return fn(x, w, scale, out, M, K, N, chunk, n_split, stream);
}

template <int BITS>
int launch_t(const void* x, const void* w, const void* scale, void* out,
             int M, int K, int N, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int gx = (N + kBN - 1) / kBN;
  const float* xp = static_cast<const float*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (N % 4 || reinterpret_cast<uintptr_t>(w) % 4) {
    psi_gemm_kernel<BITS, 8, false>
        <<<dim3(gx, (M + 7) / 8), block, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else if (M == 1) {
    psi_gemm_kernel<BITS, 1, true><<<dim3(gx, M), block, 0, stream>>>(
        xp, wp, sp, op, M, K, N);
  } else if (M <= 4) {
    psi_gemm_kernel<BITS, 4, true><<<dim3(gx, 1), block, 0, stream>>>(
        xp, wp, sp, op, M, K, N);
  } else {
    psi_gemm_kernel<BITS, 8, true>
        <<<dim3(gx, (M + 7) / 8), block, 0, stream>>>(xp, wp, sp, op, M, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 (f32 x): the CUDA-core kernel; tile and chunk are unused.  dtype
// 1 (bf16 x): the tensor-core kernel on `tile`-channel tiles, K split into
// at most 8 chunks of `chunk` 16-K steps (kernels/psi_matmul.py::
// codes_split_plan).  Returns the
// launch's cudaError_t.
extern "C" int psi_matmul_codes(const void* x, const void* codes,
                                const void* scale, void* out, int M, int K,
                                int N, int dtype, int tile, int chunk,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<8>(x, codes, scale, out, M, K, N, s);
  if (dtype == 1)
    return launch_codes(x, codes, scale, out, M, K, N, tile, chunk, s);
  return (int)cudaErrorInvalidValue;
}

// bits 2..7.  dtype 0 (f32 x): the CUDA-core kernel; chunk is unused.
// dtype 1 (bf16 x, 16-byte aligned): the tensor-core kernel, K split into
// at most 8 chunks of `chunk` 64-K groups (kernels/psi_matmul.py::
// split_plan).
extern "C" int psi_matmul_packed(const void* x, const void* planes,
                                 const void* scale, void* out, int M, int K,
                                 int N, int bits, int dtype, int chunk,
                                 void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || bits < 2 || bits > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using Fn = int (*)(const void*, const void*, const void*, void*, int,
                       int, int, int, cudaStream_t);
    constexpr Fn kRoute[] = {launch_mma<2>, launch_mma<3>, launch_mma<4>,
                             launch_mma<5>, launch_mma<6>, launch_mma<7>};
    return kRoute[bits - 2](x, planes, scale, out, M, K, N, chunk, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 2: return launch_t<2>(x, planes, scale, out, M, K, N, s);
    case 3: return launch_t<3>(x, planes, scale, out, M, K, N, s);
    case 4: return launch_t<4>(x, planes, scale, out, M, K, N, s);
    case 5: return launch_t<5>(x, planes, scale, out, M, K, N, s);
    case 6: return launch_t<6>(x, planes, scale, out, M, K, N, s);
    default: return launch_t<7>(x, planes, scale, out, M, K, N, s);
  }
}
