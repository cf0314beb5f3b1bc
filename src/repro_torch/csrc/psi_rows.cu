// The PSI matmuls' routes for prefill rows on Hopper (sm_90a): y[M,N] =
// (x[M,K] @ W[K,N]) * scale[N], x bf16, f32 sums, M above the host's
// threshold T.  Kernel 1 (int8 codes, psi8; design (4)) replaces, with
// csrc/psi_matmul.cu's design (3), the Pallas kernel
// repro/kernels/psi_matmul.py::psi_matmul_int8 (psi_matmul.py:153, body
// _int8_kernel) at M above kernels/psi_matmul.py::CODES_ROWS_MIN_M.
// Kernel 2 (uint8 bit-planes, bits 2-7; design (5)) replaces, with design
// (2), repro/kernels/psi_matmul.py::psi_matmul_packed (psi_matmul.py:197,
// body _packed_kernel) at M above PACKED_ROWS_MIN_M on weights of more
// than PACKED_ROWS_MIN_N channels (kernels/psi_matmul.py::
// packed_launch_plan).
//
// Design (4), psi_gemm_codes_rows_kernel, tensor cores: kernel 1 at
// prefill rows (bf16 x, M above the host's threshold T).  Design (3)
// reaches many rows by launching more of its blocks: at M = 288 each
// 64-channel tile's codes are decoded again in 18 blocks of 16 tokens,
// each decode (1.5 integer ops a weight) feeding 2 MMAs of 8 tokens, and
// 18 blocks re-read the tile through L2; it ran at 2-7 % of the operation
// bound.  This route keeps what fixes a row's bits and changes where the
// work runs:
//   * Kept from (3), so that every row is (3)'s bit for bit whichever
//     route M picks: the split plan (codes_split_plan, from K and N only);
//     mma.sync.m16n8k16 with the same k slots and the same channel and
//     token positions in its tiles; each split's chains (warp w sums steps
//     w, w+8, ... of the split from 0); the tree ((w0 + w4) + (w2 + w6)) +
//     ((w1 + w5) + (w3 + w7)); the splits added in split order into 0,
//     then scale and one rounding.  wgmma would need its own sums checked
//     against these bit for bit.
//   * Changed: a block owns 32 tokens (NT = 4 token tiles of 8) of a
//     channel tile and decodes each code step once for all of them (2*NW*4
//     MMAs a decode, against 2*NW*2); it runs the tile's splits one after
//     another, or, where such blocks would leave SMs idle (narrow N, few
//     rows: kernels/psi_matmul.py::codes_rows_cluster), one split a block
//     of a cluster that adds them in split order through distributed
//     shared memory.  The block copies each round of 8 or 16 steps (x rows
//     as whole lines, code rows) into shared memory with cp.async while
//     the last round is multiplied; at a split's end all eight warps store
//     their sums at once and each thread adds its outputs' eight chains in
//     the tree's order (two barriers, where (3)'s halving tree takes six),
//     keeping v in registers.
//   * What bounds it: not the tensor cores, nor mainly the copies (tools/
//     psi_rows_probe.py times mma.sync with this decode alone, and the
//     route with its copies left out).  The eight chains hold a tile's
//     accumulators eight times over, so a block owns 4096 outputs at most
//     with one block (8 warps) an SM: the rounds' barriers, the trees
//     (7 of 8 chains' sums cross shared memory once a split, which short
//     splits such as whisper's 8-16 steps pay for little work) and a whole
//     K a block (wave tails) set the pace.  PERF.md has the measured
//     times.
//   * Edges masked, never padded: x and code pieces past M, K or N are
//     filled with zeros, never stored.  Code rows that the 16-byte copies
//     cannot take (N % 16 != 0, as whisper's 51865-wide head, or
//     misaligned codes: VEC = false) are read as aligned 16-byte words and
//     shifted into place; x rows (K % 8 != 0 or misaligned x: XVEC =
//     false) element by element.
//
// Design (5), psi_gemm_packed_rows_kernel, tensor cores: kernel 2 at
// prefill rows.  Design (2) reaches many rows by launching more of its
// blocks: at M = 288 each 32-channel tile's planes are read and
// bit-transposed again in 9 blocks of 32 tokens, each decode (~2.5
// integer ops a weight at psi5) feeding 2 A tiles x 4 token tiles of MMAs,
// so the integer pipe, not the tensor cores, set the pace (granite-34b's
// 288-row prefill spent 138 of 170 ms in it, ~14 % of the operation
// bound).  This route keeps what fixes a row's bits and changes where the
// work runs:
//   * Kept from (2), so that every row is (2)'s bit for bit whichever route
//     is picked: the split plan (split_plan, from K and N only);
//     mma.sync.m16n8k16 with the same k slots (lane t's plane rows ra =
//     8*grp + t and rb = ra + 4, MMA q holding K rows 8ra+2q, 8rb+2q,
//     8ra+2q+1, 8rb+2q+1) and the same decode (csrc/psi_common.cuh); each
//     split's eight chains (chain w: groups gs+w, gs+w+8, ... from 0, q =
//     0..3 in each); the block's sum in warp order (s = c0, s += c1, ...,
//     c7, an empty chain adding +0); the splits added in split order into
//     0, then scale and one rounding.
//   * Changed: a block is 4 warps on 128 channels x 64 tokens, and a warp
//     owns 32 channels (design (2)'s lane layout) for all 64 tokens: it
//     decodes each group of its channels once and feeds the A fragments,
//     from its registers, to 8 token tiles (64 MMAs a decode; (2) feeds 8
//     to 32).  The block walks a split's chains one after another
//     (PackedWalk), not eight warps at once: a chain's f32 operations
//     depend only on its own sequence of MMAs, so only the current chain's
//     sums (64 a thread) live in registers; at a chain's end each thread
//     adds them into its s in shared memory (its own slots, no barrier).
//     x goes through shared memory (cp.async, three stages, pieces
//     swizzled so that the fragment reads hit every bank once), shared by
//     the four warps; a warp's plane words are loaded a group ahead into
//     its registers.  A tile's splits run one a block of a cluster (of
//     one block where the plan has one split), added in split order
//     through distributed shared memory.
//   * What bounds it: see PERF.md (PR 31).
//   * Edges masked, never padded: plane rows past K/8 load 0 (decoding to
//     -2^(bits-1)) against x copied as 0, so they add exact zeros; columns
//     past N load 0 and tokens past M copy x = 0, never stored.  Planes
//     not word aligned (N % 4 != 0 or a misaligned pointer: VEC = false)
//     are read byte by byte (load_word); x is 16-byte aligned (the
//     wrapper clones it otherwise) and K % 8 == 0, so its pieces are.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "psi_common.cuh"

namespace cg = cooperative_groups;

namespace {

// 16-byte cp.async from global p to shared s: `bytes` of them (16 or 0,
// 0 reading nothing, so p need only be a valid address), zeros after.
__device__ __forceinline__ void cp_async16(void* s, const void* p,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;"
               :: "r"(d), "l"(p), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The n (1..16) bytes at p, zeros after them, for rows that 16-byte copies
// cannot take: the aligned 16-byte word holding p and, where the bytes run
// on, the next one (no read past the 16-byte word of p's last byte), then
// funnel shifts; p's word is chosen by selects, so nothing is indexed at
// run time (which would put the words in local memory).
__device__ __forceinline__ uint4 load16_unaligned(const uint8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* w = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int off = a & 15, sh = 8 * (off & 3), q = off >> 2;
  const uint4 lo = __ldg(w);
  const uint4 hi = off + n > 16 ? __ldg(w + 1) : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // words q + i and q + i + 1 of v, q in 0..3
    const uint32_t a0 = q == 0 ? v[i] : q == 1 ? v[i + 1]
                      : q == 2 ? v[i + 2] : v[i + 3];
    const uint32_t a1 = q == 0 ? v[i + 1] : q == 1 ? v[i + 2]
                      : q == 2 ? v[i + 3] : v[i + 4];
    const uint32_t b = __funnelshift_r(a0, a1, sh);
    const int keep = n - 4 * i;                     // bytes of word i kept
    r[i] = keep >= 4 ? b : keep <= 0 ? 0u : b & ((1u << (8 * keep)) - 1u);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Shared byte offsets in a round's stage (x [8*NT tokens][16*RS K] bf16,
// then codes [16*RS K rows][32*NW channels], RS steps a round), swizzled
// by 16-byte chunks so that a warp's fragment reads hit every bank once: x
// row r's chunk c sits at c ^ 2(r & 3); code row q (lane t = (q >> 2) & 3
// reads it) is row q ^ (t & 1) with chunk c ^ 2(t >> 1) at 64-byte rows,
// or chunk c ^ 2t at 128.
template <int RS>
__device__ __forceinline__ int x_at(int r, int c) {
  return r * (32 * RS) + ((c ^ ((r & 3) << 1)) << 4);
}
template <int NW>
__device__ __forceinline__ int codes_at(int q, int c) {
  const int t = (q >> 2) & 3;
  if constexpr (NW == 2)
    return (q ^ (t & 1)) * 64 + ((c ^ ((t >> 1) << 1)) << 4);
  else
    return q * 128 + ((c ^ (t << 1)) << 4);
}

// Token tiles of 8 a block: 32 tokens.  (The chains' accumulators of 64
// tokens x a 128-channel tile would not fit the registers; at 64-channel
// tiles a 64-token layout was slower at qwen3-8b's wq and 288 rows on the
// H100, PERF.md.)
constexpr int kRowsNT = 4;

// The prefill route's shape by NW (channels / 32): RS steps a round (a
// block barrier each), ST stages in flight.  32 tokens x 32*NW channels of
// 16 or 8 float4 sums a lane: at 16 (NW 4, one block an SM) 16-step
// rounds, two stages; at 8 (NW 2, two blocks an SM) 8-step rounds, three
// stages.
template <int NW>
struct RowsShape {
  static constexpr int NT = kRowsNT;
  static constexpr bool kBig = NW == 4;
  static constexpr int RS = kBig ? 16 : 8;
  static constexpr int ST = kBig ? 2 : 3;
  static constexpr int R4 = 2 * NW * NT;                  // float4 sums a lane
  static constexpr int kXBytes = 8 * NT * 32 * RS;
  static constexpr int kStage = kXBytes + 16 * RS * 32 * NW;
  static constexpr int kSmem = kMmaWarps * R4 * 32 * 16 + ST * kStage;
};

// Grid (ceil(M/(8*NT)), CL ? n_split : 1, ceil(N/(32*NW))), 8 warps: one
// block owns 8*NT tokens x 32*NW channels over the whole of K, or (CL) over
// split blockIdx.y, the tile's splits a cluster of (1, n_split, 1).  Lane
// (g, t), its channels, K rows and A tiles are those of
// psi_gemm_codes_kernel, and so is each warp's chain: for split s (steps
// [s*chunk, min(steps, (s+1)*chunk))) warp w sums steps w, w+8, ... of it
// from 0 through mma.sync.  A block runs its splits one after another, in
// rounds of RS steps (warp w takes the round's steps w, w+8); it copies a
// round's x rows and code rows into a stage of shared memory in whole
// 16-byte pieces (cp.async: x rows as whole lines), the next round's while
// one is multiplied.  At a split's end every warp stores its sums, and
// each thread adds the eight warps' sums of its outputs in design (3)'s
// tree, ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)), then into its v
// (0 at first) in split order (CL: the cluster's blocks then add their
// v, in split order, into 0); the epilogue multiplies by scale[col] and
// rounds once.  Every add is the decode route's add on the same operands,
// so a row's outputs are its outputs there, bit for bit.  Rows the copies
// cannot take (VEC: N % 16 == 0 and 16-byte aligned codes; XVEC: K % 8 ==
// 0 and 16-byte aligned x) are read by the threads themselves into the
// stage.  Shared memory: the warps' sums [8][2*NW*NT][32] float4 (lane
// major) and the stages.
template <int NW, bool VEC, bool XVEC, bool CL>
__global__ void __launch_bounds__(kMmaWarps * 32, NW == 4 ? 1 : 2)
psi_gemm_codes_rows_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint8_t* __restrict__ codes,
                           const float* __restrict__ scale,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ out32, int M, int K, int N,
                           int chunk) {
  using Sh = RowsShape<NW>;
  constexpr int NT = kRowsNT;
  constexpr int RS = Sh::RS, ST = Sh::ST, R4 = Sh::R4;
  constexpr int kTN = 32 * NW;                      // channels per block
  constexpr int kTiles = 2 * NW;                    // A tiles per warp
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kXChunks = 8 * NT * 2 * RS;         // 16-byte pieces
  constexpr int kCChunks = 16 * RS * (kTN / 16);
  constexpr int kOut = R4 * 32 / kThreads;          // float4 sums a thread
  extern __shared__ float4 rows_smem[];
  float4* red = rows_smem;                          // [8][R4][32]
  char* stages = reinterpret_cast<char*>(red + kMmaWarps * R4 * 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (K + kStepK - 1) / kStepK;
  const int nb = blockIdx.z * kTN;
  const int m0 = blockIdx.x * 8 * NT;
  // CL: this block's split only (a cluster holds the tile's splits), else
  // all of them
  const int s_begin = CL ? blockIdx.y * chunk : 0;
  const int s_end = CL ? min(steps, s_begin + chunk) : steps;

  // the round from step s0 (K rows 16*s0 ..) into stage q, then one
  // commit group (an empty one when s0 < 0: no round left)
  auto issue = [&](int s0, int q) {
    char* st = stages + q * Sh::kStage;
    if (s0 >= 0) {
      const int k0 = s0 * kStepK;
#pragma unroll(XVEC ? kXChunks / kThreads : 1)
      for (int j = 0; j < kXChunks / kThreads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int r = i / (2 * RS), c = i % (2 * RS);
        const int tok = m0 + r, k = k0 + 8 * c;
        char* d = st + x_at<RS>(r, c);
        if constexpr (XVEC) {
          const bool ok = tok < M && k < K;
          cp_async16(d, ok ? x + (size_t)tok * K + k : x, ok ? 16 : 0);
        } else {
          const unsigned short* h =
              reinterpret_cast<const unsigned short*>(x) + (size_t)tok * K;
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k2 = k + 2 * e;
            const uint32_t lo = tok < M && k2 < K ? __ldg(h + k2) : 0u;
            const uint32_t hi = tok < M && k2 + 1 < K ? __ldg(h + k2 + 1)
                                                      : 0u;
            v[e] = lo | (hi << 16);
          }
          *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      const uint8_t* crow = codes + (size_t)k0 * N + nb;
#pragma unroll(VEC ? kCChunks / kThreads : 1)
      for (int j = 0; j < kCChunks / kThreads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int q2 = i / (kTN / 16), c = i % (kTN / 16);
        const int col = nb + 16 * c;
        const bool row_ok = k0 + q2 < K;
        const uint8_t* src = crow + (size_t)q2 * N + 16 * c;
        char* d = st + Sh::kXBytes + codes_at<NW>(q2, c);
        if constexpr (VEC) {
          const bool ok = row_ok && col < N;
          cp_async16(d, ok ? src : codes, ok ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(d) =
              row_ok && col < N ? load16_unaligned(src, min(16, N - col))
                                : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };
  // the producer's cursor over the rounds, split after split: ps is the
  // first step of the next round to load (-1 past the last), pe its split's
  // end
  int ps = s_begin, pe = min(steps, s_begin + chunk);
  auto next_round = [&]() {
    if (ps < 0) return;
    ps += RS;
    if (ps >= pe) {
      ps = pe < s_end ? pe : -1;
      pe = min(steps, pe + chunk);
    }
  };
#pragma unroll
  for (int q = 0; q < ST - 1; ++q) {
    issue(ps, q);
    next_round();
  }

  float4 v[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[kTiles][NT][4];
  int cur = 0;                                      // the stage to read
  for (int ss = s_begin; ss < s_end; ss += chunk) {
    const int se = min(steps, ss + chunk);
#pragma unroll
    for (int a = 0; a < kTiles; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][nt][c] = 0.f;
    for (int s0 = ss; s0 < se; s0 += RS) {
      cp_async_wait<ST - 2>();                      // this thread's copies
      __syncthreads();            // everyone's; and the last stage is free
      issue(ps, cur == 0 ? ST - 1 : cur - 1);
      next_round();
      const char* st = stages + cur * Sh::kStage;
      cur = cur + 1 == ST ? 0 : cur + 1;
#pragma unroll
      for (int rs = warp; rs < RS; rs += kMmaWarps) {
        if (s0 + rs >= se) break;                   // the split's last round
        // step s0 + rs: its K rows 16*rs + 4t + i of the round
        uint32_t C[4][NW];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const char* p = st + Sh::kXBytes +
                          codes_at<NW>(kStepK * rs + 4 * t + i,
                                       (4 * NW * g) >> 4) +
                          ((4 * NW * g) & 15);
          if constexpr (NW == 2) {
            const uint2 w2 = *reinterpret_cast<const uint2*>(p);
            C[i][0] = w2.x; C[i][1] = w2.y;
          } else {
            const uint4 w4 = *reinterpret_cast<const uint4*>(p);
            C[i][0] = w4.x; C[i][1] = w4.y; C[i][2] = w4.z; C[i][3] = w4.w;
          }
        }
        uint2 xv[NT];
        const int cx = 2 * rs + (t >> 1);           // x[tok][32 rs + 8t..]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          xv[nt] = *reinterpret_cast<const uint2*>(
              st + x_at<RS>(nt * 8 + g, cx) + 8 * (t & 1));
#pragma unroll
        for (int a = 0; a < kTiles; ++a) {
          // tile a: channel n + 2a (byte c of word a/2) on row g, the next
          // channel on row g+8
          const int wi = a / 2, c = 2 * (a % 2);
          const uint32_t afrag[4] = {code_pair(C[0][wi], C[1][wi], c),
                                     code_pair(C[0][wi], C[1][wi], c + 1),
                                     code_pair(C[2][wi], C[3][wi], c),
                                     code_pair(C[2][wi], C[3][wi], c + 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[a][nt], afrag, xv[nt].x, xv[nt].y);
        }
      }
    }
    // the split's sum of each output, in design (3)'s tree, then v +=
#pragma unroll
    for (int a = 0; a < kTiles; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        red[(warp * R4 + a * NT + nt) * 32 + lane] =
            make_float4(acc[a][nt][0], acc[a][nt][1], acc[a][nt][2],
                        acc[a][nt][3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int i = threadIdx.x + j * kThreads;
      float4 w[kMmaWarps];
#pragma unroll
      for (int u = 0; u < kMmaWarps; ++u) w[u] = red[u * R4 * 32 + i];
      const auto tree = [&](float w0, float w1, float w2, float w3, float w4,
                            float w5, float w6, float w7) {
        return ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7));
      };
      v[j].x += tree(w[0].x, w[1].x, w[2].x, w[3].x, w[4].x, w[5].x, w[6].x,
                     w[7].x);
      v[j].y += tree(w[0].y, w[1].y, w[2].y, w[3].y, w[4].y, w[5].y, w[6].y,
                     w[7].y);
      v[j].z += tree(w[0].z, w[1].z, w[2].z, w[3].z, w[4].z, w[5].z, w[6].z,
                     w[7].z);
      v[j].w += tree(w[0].w, w[1].w, w[2].w, w[3].w, w[4].w, w[5].w, w[6].w,
                     w[7].w);
    }
  }
  cp_async_wait<0>();
  // C fragment of sum [a * NT + nt][lane (g, t)]: {(row g, tok 2t), (row g,
  // tok 2t+1), (row g+8, tok 2t), (row g+8, tok 2t+1)}; row g of tile a is
  // channel 4*NW*g + 2a, row g+8 the next channel
  auto store4 = [&](int i, float4 y4) {
    const int l = i % 32, q = i / 32;
    const int a = q / NT, nt = q % NT;
    const int col = nb + 4 * NW * (l >> 2) + 2 * a;
    const int row = m0 + nt * 8 + 2 * (l & 3);
    const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row + (c & 1), cc = col + (c >> 1);
      if (r < M && cc < N)
        store_out(out, out32, (size_t)r * N + cc, y[c] * scale[cc]);
    }
  };
  if constexpr (!CL) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) store4(threadIdx.x + j * kThreads, v[j]);
  } else {
    // v holds this split's sum: the cluster's blocks add the splits' sums
    // in split order into 0, as design (3) does, each block a share of the
    // tile's outputs
    __syncthreads();                                // red is read: reuse it
#pragma unroll
    for (int j = 0; j < kOut; ++j) red[threadIdx.x + j * kThreads] = v[j];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int n_split = (int)cluster.num_blocks();
    for (int i = cluster.block_rank() * kThreads + threadIdx.x; i < R4 * 32;
         i += n_split * kThreads) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < n_split; ++r) {
        const float4 p = cluster.map_shared_rank(red, r)[i];
        y.x += p.x;
        y.y += p.y;
        y.z += p.z;
        y.w += p.w;
      }
      store4(i, y);
    }
    cluster.sync();            // keep red alive until the cluster has read it
  }
}

template <int NW, bool VEC, bool XVEC, bool CL>
int launch_codes_rows_t(const void* x, const void* w, const void* scale,
                        void* out, bool f32_out, int M, int K, int N,
                        int chunk, int n_split, cudaStream_t stream) {
  constexpr int kSmem = RowsShape<NW>::kSmem;
  const auto kern = psi_gemm_codes_rows_kernel<NW, VEC, XVEC, CL>;
  // on every launch: the attribute holds for the current device only (a
  // host call, allowed while a graph captures)
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  constexpr int kTok = 8 * kRowsNT;
  cfg.gridDim = dim3((M + kTok - 1) / kTok, CL ? n_split : 1,
                     (N + 32 * NW - 1) / (32 * NW));
  cfg.blockDim = dim3(kMmaWarps * 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr1[1];
  attr1[0].id = cudaLaunchAttributeClusterDimension;
  attr1[0].val.clusterDim.x = 1;
  attr1[0].val.clusterDim.y = CL ? n_split : 1;
  attr1[0].val.clusterDim.z = 1;
  cfg.attrs = attr1;
  cfg.numAttrs = CL ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      f32_out ? nullptr : static_cast<__nv_bfloat16*>(out),
      f32_out ? static_cast<float*>(out) : nullptr, M, K, N, chunk);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int NW, bool XVEC, bool CL>
int launch_codes_rows_v(const void* x, const void* w, const void* scale,
                        void* out, bool f32_out, int M, int K, int N,
                        int chunk, int n_split, cudaStream_t s) {
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_codes_rows_t<NW, true, XVEC, CL>(
                   x, w, scale, out, f32_out, M, K, N, chunk, n_split, s)
             : launch_codes_rows_t<NW, false, XVEC, CL>(
                   x, w, scale, out, f32_out, M, K, N, chunk, n_split, s);
}

template <int NW, bool CL>
int launch_codes_rows(const void* x, const void* w, const void* scale,
                      void* out, bool f32_out, int M, int K, int N, int chunk,
                      int n_split, cudaStream_t s) {
  return K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
             ? launch_codes_rows_v<NW, true, CL>(
                   x, w, scale, out, f32_out, M, K, N, chunk, n_split, s)
             : launch_codes_rows_v<NW, false, CL>(
                   x, w, scale, out, f32_out, M, K, N, chunk, n_split, s);
}

// ---------------------------------------------------------------------------
// (5) Kernel 2's route for prefill rows (bit-planes, bf16 x).
// ---------------------------------------------------------------------------
constexpr int kPackedWarps = 4;         // warps a block, 32 channels each
constexpr int kPackedThreads = kPackedWarps * 32;
constexpr int kPackedTok = 64;          // tokens a block: 8 token tiles
constexpr int kPackedTN = 32 * kPackedWarps;   // channels a block
constexpr int kPackedGroupRows = 8;     // plane rows a group (64 K)
constexpr int kPackedSums = 16;         // float4 sums a thread (64 outputs)
constexpr int kPackedStages = 3;        // groups of x in flight
// shared memory (bytes): the running sums s, [kPackedSums][128] float4 (a
// thread's own slots), and kPackedStages stages of x, [64 tokens][8
// pieces of 16 bytes]: 56 KB.  Two blocks an SM, so that a thread may hold
// ~200 registers (64 sums, 32 A fragment words, the next group's plane
// words) without spilling (held to three blocks an SM, it spilled).
constexpr int kPackedSumBytes = kPackedSums * kPackedThreads * 16;
constexpr int kPackedXBytes = kPackedTok * 128;
constexpr int kPackedSmem = kPackedSumBytes + kPackedStages * kPackedXBytes;

// A block's walk over the 64-K groups, one entry at a time: the splits
// in order (split: groups [gs, gs + n), n = min(chunk, groups - gs)), and
// within a split the chains one after another (chain w: groups gs + w,
// gs + w + 8, ..., len = ceil((n - w) / 8) of them, in that order).
// Design (2) sums each chain from 0 in one warp; walking them in turn
// gives every chain the same sequence of MMAs.  Advanced by compares and
// adds only (every thread of the block holds the same walk).  An entry is
// one word: group << 5 | chain << 2 | chain's end << 1 | split's end.
struct PackedWalk {
  int gs, n, w, i, len;
  __device__ __forceinline__ void start_split(int g, int chunk, int groups) {
    gs = g;
    n = min(groups, g + chunk) - g;
    w = 0;
    i = 0;
    len = (n + 7) >> 3;
  }
  __device__ __forceinline__ int entry() const {
    const bool chain_end = i == len - 1;
    const bool split_end = chain_end && w == min(n, 8) - 1;
    return (gs + w + 8 * i) << 5 | w << 2 | (int)chain_end << 1 |
           (int)split_end;
  }
  __device__ __forceinline__ void advance(int chunk, int groups) {
    if (++i < len) return;
    i = 0;
    if (++w < min(n, 8))
      len = (n - w + 7) >> 3;
    else
      start_split(gs + chunk, chunk, groups);
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Grid (ceil(M/64), n_split, ceil(N/128)), 4 warps: one block owns 64
// tokens x 128 channels over split blockIdx.y of K, the tile's splits a
// cluster of (1, n_split, 1).
// Warp w owns channels 32w .. 32w+31 of the tile and all 64 tokens: per
// group of its walk (PackedWalk) it decodes its channels' planes as design
// (2)'s warp does (lane (g, t): plane rows 8*grp + t and + 4, channels
// 4g .. 4g+3, two A tiles; the words loaded a group ahead) and feeds
// those A fragments, from registers, to all 8 token tiles (64 MMAs a
// decode, against (2)'s 8 to 32).  x goes through shared memory, copied
// with cp.async two groups ahead and read by all four warps.  At a
// chain's end each thread adds its sums into s (s = the chain's sums for
// chain 0); at the split's end s takes the empty chains' +0, and the
// cluster's blocks add their s in split order into v = 0: design (2)'s
// adds on the same operands, so every output is the decode route's bit
// for bit.  s lives in shared memory, in the thread's own slots.
template <int BITS, bool VEC>
__global__ void __launch_bounds__(kPackedThreads, 2)
psi_gemm_packed_rows_kernel(const __nv_bfloat16* __restrict__ x,
                            const uint8_t* __restrict__ planes,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ out32, int M, int K, int N,
                            int chunk) {
  constexpr int kThreads = kPackedThreads;
  extern __shared__ float4 packed_smem[];
  float4* ss = packed_smem;                         // [16][128]: s
  char* xs = reinterpret_cast<char*>(ss + kPackedSums * kThreads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = K >> 3;                          // plane rows
  const int groups = (rows + kPackedGroupRows - 1) / kPackedGroupRows;
  const int m0 = blockIdx.x * kPackedTok, nb = blockIdx.z * kPackedTN;
  const int e_begin = blockIdx.y * chunk;
  const int e_end = min(groups, e_begin + chunk);
  const size_t pstride = (size_t)rows * N;

  // the walk's entries e, e + 1, e + 2: the MMAs' (and decode's), the
  // plane loads', the x copy's (valid below e_end)
  PackedWalk walk;
  walk.start_split(e_begin, chunk, groups);
  int en[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    en[j] = walk.entry();
    walk.advance(chunk, groups);
  }

  // the group's x rows (64 tokens x 8 pieces of 16 bytes, 4 a thread):
  // token row r = i / 8, piece c = i % 8 (K rows 64*grp + 8c ..), stored
  // at piece c ^ 4(r & 1) so that a warp's fragment reads hit every bank
  // once; 0 past M and past K (`live`: the entry is the block's)
  auto copy_x = [&](int grp, int buf, bool live) {
    char* st = xs + buf * kPackedXBytes;
#pragma unroll
    for (int j = 0; j < kPackedTok * 8 / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i >> 3, c = i & 7;
      const bool ok = live && m0 + r < M && grp * 8 + c < rows;
      cp_async16(st + r * 128 + ((c ^ ((r & 1) << 2)) << 4),
                 ok ? x + (size_t)(m0 + r) * K + 64 * grp + 8 * c : x,
                 ok ? 16 : 0);
    }
  };
  // this lane's plane words: P rows 8*grp + t, Q rows 8*grp + 4 + t of
  // every plane, channels n .. n+3 (design (2)'s load_group)
  const int n = nb + 32 * warp + 4 * g;
  const uint8_t* pw = planes + (size_t)t * N + n;
  uint32_t P[BITS], Q[BITS];
  auto load_planes = [&](int grp, bool live) {
    const uint8_t* p = pw + (size_t)grp * 8 * N;
    const bool pa = live && grp * 8 + t < rows;
    const bool pb = live && grp * 8 + 4 + t < rows;
#pragma unroll
    for (int b = 0; b < BITS; ++b, p += pstride) {
      P[b] = load_word<VEC>(p, pa, n, N);
      Q[b] = load_word<VEC>(p + (size_t)4 * N, pb, n, N);
    }
  };

  copy_x(en[0] >> 5, 0, true);
  cp_async_commit();
  copy_x(en[1] >> 5, 1, e_begin + 1 < e_end);
  cp_async_commit();
  load_planes(en[0] >> 5, true);

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][nt][c] = 0.f;
  // this lane's x pieces in a stage (token tile 0, row g; tile nt is
  // 1024 bytes on, its rows 8nt + g keeping g's parity): K rows 8ra ..
  // (piece t) and 8rb .. (piece t + 4)
  const int xfa = g * 128 + ((t ^ ((g & 1) << 2)) << 4);
  const int xfb = g * 128 + (((t + 4) ^ ((g & 1) << 2)) << 4);
  int s0 = 0;                                       // x stage: e % 3
  for (int e = e_begin; e < e_end; ++e) {
    const int s1 = s0 == 2 ? 0 : s0 + 1, s2 = s1 == 2 ? 0 : s1 + 1;
    // entry e's x has landed (only the last commit group may be in
    // flight), and every warp is done with stage s2 (entry e - 1)
    cp_async_wait<1>();
    __syncthreads();
    copy_x(en[2] >> 5, s2, e + 2 < e_end);
    cp_async_commit();
    // entry e's A tiles, from the words loaded a group ahead, then the
    // next group's words
    uint32_t W[2][8];
    tile_words<BITS>(P, Q, 0, W[0]);
    tile_words<BITS>(P, Q, 1, W[1]);
    load_planes(en[1] >> 5, e + 1 < e_end);
    transpose_words(W[0]);
    transpose_words(W[1]);
    uint32_t af[2][4][4];                           // [tile][k-step][reg]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tile_weights<BITS>(W[a][2 * q + h], af[a][q][2 * h],
                             af[a][q][2 * h + 1]);
    const char* st = xs + s0 * kPackedXBytes;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint4 xa = *reinterpret_cast<const uint4*>(st + nt * 1024 + xfa);
      const uint4 xb = *reinterpret_cast<const uint4*>(st + nt * 1024 + xfb);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wa = q == 0 ? xa.x : q == 1 ? xa.y
                          : q == 2 ? xa.z : xa.w;
        const uint32_t wb = q == 0 ? xb.x : q == 1 ? xb.y
                          : q == 2 ? xb.z : xb.w;
        uint32_t b0, b1;
        x_pair(wa, wb, b0, b1);
        mma_bf16(acc[0][nt], af[0][q], b0, b1);
        mma_bf16(acc[1][nt], af[1][q], b0, b1);
      }
    }
    s0 = s1;
    const int cur = en[0];
    en[0] = en[1];
    en[1] = en[2];
    en[2] = walk.entry();
    walk.advance(chunk, groups);
    if (cur & 2) {                                  // the chain's end
#pragma unroll
      for (int k = 0; k < kPackedSums; ++k) {
        float* c = acc[k >> 3][k & 7];
        const int i = k * kThreads + threadIdx.x;
        float4 s = make_float4(c[0], c[1], c[2], c[3]);
        const int chain = (cur >> 2) & 7;
        if (chain > 0) s = add4(ss[i], s);
        // at the split's end, the empty chains' sums (0) after the last
        if ((cur & 1) && chain < kMmaWarps - 1)
          s = add4(s, make_float4(0.f, 0.f, 0.f, 0.f));
        ss[i] = s;
        c[0] = c[1] = c[2] = c[3] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  // sum k of thread T: acc[a = k / 8][nt = k % 8] of warp T / 32, lane T %
  // 32: {(ch, tok), (ch, tok + 1), (ch + 1, tok), (ch + 1, tok + 1)}, ch =
  // 32w + 4g + 2a (A tile a: row g is channel 4g + 2a, row g + 8 the next)
  auto store4 = [&](int i, float4 y4) {
    const int T = i % kThreads, k = i / kThreads;
    const int w = T >> 5, l = T & 31;
    const int col = nb + 32 * w + 4 * (l >> 2) + 2 * (k >> 3);
    const int row = m0 + 8 * (k & 7) + 2 * (l & 3);
    const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row + (c & 1), cc = col + (c >> 1);
      if (r < M && cc < N)
        store_out(out, out32, (size_t)r * N + cc, y[c] * scale[cc]);
    }
  };
  // ss holds this split's sums: the cluster's blocks add the splits in
  // split order into 0, as design (2) does, each block a share of the
  // tile's outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_split = (int)cluster.num_blocks();
  for (int i = cluster.block_rank() * kThreads + threadIdx.x;
       i < kPackedSums * kThreads; i += n_split * kThreads) {
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < n_split; ++r)
      y = add4(y, cluster.map_shared_rank(ss, r)[i]);
    store4(i, y);
  }
  cluster.sync();              // keep ss alive until the cluster has read it
}

// One split a block, the tile's splits one cluster (of one block where
// the plan has one split); word loads of the planes where rows allow them
// (design (2)'s VEC).  `grid` is the wrapper's (kernels/psi_matmul.py::
// packed_rows_grid), checked by the caller.
template <int BITS>
int launch_packed_rows(const void* x, const void* w, const void* scale,
                       void* out, bool f32_out, int M, int K, int N,
                       int chunk, dim3 grid, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const auto kern = vec ? psi_gemm_packed_rows_kernel<BITS, true>
                        : psi_gemm_packed_rows_kernel<BITS, false>;
  // on every launch: the attribute holds for the current device only
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kPackedSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kPackedThreads);
  cfg.dynamicSmemBytes = kPackedSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr1[1];
  attr1[0].id = cudaLaunchAttributeClusterDimension;
  attr1[0].val.clusterDim.x = 1;
  attr1[0].val.clusterDim.y = grid.y;
  attr1[0].val.clusterDim.z = 1;
  cfg.attrs = attr1;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      f32_out ? nullptr : static_cast<__nv_bfloat16*>(out),
      f32_out ? static_cast<float*>(out) : nullptr, M, K, N, chunk);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// x bf16 (M, K), codes int8 (K, N), scale f32 (N,): design (4) on
// `tile`-channel tiles (64 or 128), K split into at most 8 chunks of
// `chunk` 16-K steps (kernels/psi_matmul.py::codes_split_plan), blocks of
// 32 tokens, the splits one after another in a block (rows_cluster 0) or
// one a block of a cluster (1; tile 64 only: a 128-channel tile's plan has
// one split).  out_dtype 0 writes f32, 1 bf16.  Returns the launch's
// cudaError_t.
extern "C" int psi_matmul_codes_rows(const void* x, const void* codes,
                                     const void* scale, void* out, int M,
                                     int K, int N, int out_dtype, int tile,
                                     int chunk, int rows_cluster,
                                     void* stream) {
  const int steps = (K + kStepK - 1) / kStepK;
  if (M <= 0 || K <= 0 || N <= 0 || out_dtype < 0 || out_dtype > 1 ||
      chunk < 1 || chunk > steps || rows_cluster < 0 || rows_cluster > 1)
    return (int)cudaErrorInvalidValue;
  const int n_split = (steps + chunk - 1) / chunk;
  if (n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
  using Fn = int (*)(const void*, const void*, const void*, void*, bool, int,
                     int, int, int, int, cudaStream_t);
  Fn fn = nullptr;
  const bool cl = rows_cluster == 1;
  if (tile == 128 && !cl)
    fn = launch_codes_rows<4, false>;
  else if (tile == 64)
    fn = cl ? launch_codes_rows<2, true> : launch_codes_rows<2, false>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(x, codes, scale, out, out_dtype == 0, M, K, N, chunk, n_split,
            static_cast<cudaStream_t>(stream));
}

// x bf16 (M, K), 16-byte aligned; planes uint8 (bits, K/8, N), bits 2..7;
// scale f32 (N,): design (5), K split into at most 8 chunks of `chunk`
// 64-K groups (kernels/psi_matmul.py::split_plan, the decode route's),
// blocks of 64 tokens x 128 channels, one split a block, a tile's splits
// one cluster.  The grid (grid_m, grid_s, grid_n) is the wrapper's
// (kernels/psi_matmul.py::packed_rows_grid): one that does not tile M, the
// splits and N exactly with these blocks is refused.  out_dtype 0 writes
// f32, 1 bf16.  Returns the launch's cudaError_t.
extern "C" int psi_matmul_packed_rows(const void* x, const void* planes,
                                      const void* scale, void* out, int M,
                                      int K, int N, int bits, int out_dtype,
                                      int chunk, int grid_m, int grid_s,
                                      int grid_n, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || bits < 2 || bits > 7 ||
      out_dtype < 0 || out_dtype > 1 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int groups = (K / 8 + kPackedGroupRows - 1) / kPackedGroupRows;
  if (chunk < 1 || chunk > groups) return (int)cudaErrorInvalidValue;
  const int n_split = (groups + chunk - 1) / chunk;
  if (n_split > kMaxSplit || grid_m != (M + kPackedTok - 1) / kPackedTok ||
      grid_s != n_split || grid_n != (N + kPackedTN - 1) / kPackedTN)
    return (int)cudaErrorInvalidValue;
  using Fn = int (*)(const void*, const void*, const void*, void*, bool, int,
                     int, int, int, dim3, cudaStream_t);
  constexpr Fn kRoute[] = {launch_packed_rows<2>, launch_packed_rows<3>,
                           launch_packed_rows<4>, launch_packed_rows<5>,
                           launch_packed_rows<6>, launch_packed_rows<7>};
  return kRoute[bits - 2](x, planes, scale, out, out_dtype == 0, M, K, N,
                          chunk, dim3(grid_m, grid_s, grid_n),
                          static_cast<cudaStream_t>(stream));
}
