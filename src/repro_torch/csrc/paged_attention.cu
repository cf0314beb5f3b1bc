// Paged split-KV flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_kernel_body, pallas_call at :274): GQA decode attention that walks
// each slot's block table through the KV block pool, with no gathered
// temporary.
//
//   q      (B, Hq, D)            f32 or bf16
//   pools  (N, bs, Hkv, D)       same dtype as q, or int8 codes with
//   scales (N, bs, Hkv, 1) f32   per-entry k/v scales (kv_quant="int8")
//   bt     (B, n_bt) int32       physical block per logical block, -1 = none
//   pos    (B,) int32            query position; key j*bs+o is visible iff
//                                bt[b][j] >= 0 and j*bs+o <= pos[b]
//   out    (B, Hq, D)            q's dtype; exact zeros where no key is visible
//
// Bound on the H100: bytes.  Every visible K and V row (plus its scales) is
// read once; the arithmetic, 4 G D flops per row and kv head, is at most
// 4*48 = 192 flops per pool byte (G = 48, bf16) and 8 at qwen3-8b's G = 4,
// below the card's ~295 flops/byte ridge.  Worked numbers (qwen3-8b,
// Hkv = 8, D = 128, bf16 pool): 16 slots x 2048 positions move
// 16*2048*8*128*2 bytes * 2 (K, V) = 134 MB, 40.1 us at 3.35 TB/s; 4 x 512
// positions move 8.4 MB, 2.5 us; 4 x 80 move 1.3 MB, 0.4 us, far below
// the few microseconds a launch and two dependent memory round trips take.
//
// What the design does about that bound:
//   * The Pallas kernel's sequential table axis (grid (B, n_bt), VMEM carry)
//     is split across blocks: grid (B*Hkv*head_groups, n_split); block y
//     takes table entries [y*chunk, (y+1)*chunk).  The wrapper picks the
//     heads per block (1, 2, 4 or 8 of a kv head's G) and chunk, from the
//     shapes alone (never from pos, which would cost a device sync): as
//     many splits as one wave of one 256-thread block per SM holds.  This
//     file only checks them.  One block per (slot, kv head) walking the whole table
//     would be 32 blocks on 132 SMs at 4 slots.
//   * The block first compacts its range of the table into shared memory:
//     entries that are -1 or lie wholly past pos are dropped (the Pallas
//     update has p = 0 and alpha = 1 there, so dropping them is the same
//     result without reading the block).  A range with nothing visible exits
//     at once and writes m = -1e30, l = 0.
//   * bf16 q and pool at D = 64 or 128 (qwen3-8b's serving path) run on
//     the tensor cores (paged_attn_split_mma_kernel): a warp takes tiles of
//     16 key rows, cp.asyncs K and V into its own XOR-swizzled shared ring
//     (each copy instruction takes whole 256-byte rows, so a warp's request
//     is a few contiguous runs, not 16 scattered 32-byte pieces), and runs
//     S^T = K Q^T and O^T += V^T P^T as mma.sync m16n8k16 with the head
//     group on N (ldmatrix for K, ldmatrix.trans for V, movmatrix to turn
//     the scores' accumulator into P^T's operand).  The math is then 2 D/16
//     MMAs per 16 rows, off the copy's critical path.
//   * Every other case (f32 q, int8 pools, other D) runs on CUDA cores
//     (paged_attn_split_kernel): a row of D elements is held by D/8 lanes,
//     8 elements each (16 bytes for bf16, 2 x 16 for f32, 8 for int8
//     codes), so a warp takes 32/(D/8) rows per copy and U rows per step.
//     Each lane cp.asyncs its own slices into a shared ring of kStages
//     steps and reads back only what it copied, so the loads of the next
//     step are in flight during the math on this one with no barrier.  q
//     for the block's heads (up to 8, the head group) sits in registers as
//     f32, pre-scaled by D^-1/2 * log2(e).  Each lane group reduces its
//     partial dot products by xor shuffles (one stage per offset, all
//     U*heads shuffles of a stage independent) and keeps its own online
//     softmax state (m, l and an f32 accumulator slice per head).  int8
//     rows are dequantized by their per-entry scale (k's on the score, v's
//     on p), the codes turned into floats through the mantissa, not I2F.
//   * Both keep the online softmax in base 2 and rescale l and acc only in
//     steps where a running max grew.
//   * Lane groups merge by shuffles and warps through shared memory, once, at
//     the end of the block.  With n_split == 1 the block writes the output;
//     otherwise it writes (m, l, acc) to f32 scratch (B, Hq, n_split, D+2)
//     and paged_attn_merge_kernel combines the splits with log-sum-exp
//     weights, divides by l and writes exact zeros where l == 0.
//   * A D that is not 8 x a divisor of 32 (or a pool that is not 16-byte
//     aligned) takes the scalar-load instantiation: one lane per element,
//     32 lanes per row, D <= 256, register ping-pong instead of the ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kEpl = 8;             // row elements per lane
constexpr int kMaxChunk = 2 * kThreads;  // table entries per split
constexpr int kMaxD = 32 * kEpl;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// 2^x in one MUFU op (relative error ~2^-22; 2^(-1e30) flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 row elements: 32 bytes (f32), 16 (bf16) or 8 (int8); loaded as one
// vector (two 16-byte loads for f32).
template <typename T>
struct alignas(8 * sizeof(T) >= 16 ? 16 : 8 * sizeof(T)) Vec8 {
  T e[kEpl];
};

// 8 row elements to f32.  int8 codes go through the float's mantissa
// (bits 0x4B0000bb are 2^23 + bb, with bb = code + 128) instead of I2F,
// which issues at a quarter of the FMA rate.
template <typename T>
__device__ __forceinline__ void to_f32x8(const Vec8<T>& v, float (&f)[kEpl]) {
#pragma unroll
  for (int i = 0; i < kEpl; ++i) f[i] = to_f32(v.e[i]);
}
template <>
__device__ __forceinline__ void to_f32x8(const Vec8<int8_t>& v,
                                         float (&f)[kEpl]) {
  const uint2 w = *reinterpret_cast<const uint2*>(&v);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned u = (h ? w.y : w.x) ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * h + k] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
          8388736.f;
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* pos;
  void* out;
  float* part;     // (B, Hq, n_split, D + 2): m, l, acc[D]; n_split > 1 only
  int Hkv, G, D, n_bt, bs, chunk, n_split, n_hg, lpr;
  float qscale;    // D^-1/2 * log2(e): scores and m are in base 2
  float inv_bs;    // 1/bs: row -> table entry without an integer divide
};

// One step's rows of one lane group: U rows, 8 elements each per lane.
template <typename TKV, int U>
struct Rows {
  Vec8<TKV> k[U], v[U];
  float ks[U], vs[U];
  bool ok[U];
};

// Row ridx of the block's compacted table range -> its pool row (entry,
// offset, kv head h) and whether its key is visible (offset <= pos).
__device__ __forceinline__ bool locate(const Params& p, const int* s_ent,
                                       const int* s_j, int ridx, int R, int h,
                                       int pb, size_t& row) {
  row = 0;
  if (ridx >= R) return false;
  // exact: ridx < kMaxChunk * bs, so the product errs by far less than 1/bs
  const int e = __float2int_rz(((float)ridx + 0.5f) * p.inv_bs);
  const int o = ridx - e * p.bs;
  row = ((size_t)s_ent[e] * p.bs + o) * p.Hkv + h;
  return s_j[e] * p.bs + o <= pb;
}

// cp.async of N = 4, 8 or 16 bytes; a masked row copies nothing and
// zero-fills its slot (src-size 0), so it stays finite.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared ring of the vector path: kStages steps of U rows per lane
// group, each lane copying (and later reading) only its own 8-element
// slices of K and V, in chunks of 16 bytes (8 for int8) laid out
// [chunk][lane] so that a warp's reads are conflict-free.
constexpr int kStages = 2;

template <typename TKV, bool QUANT, int U>
struct Ring {
  static constexpr int kB = kEpl * (int)sizeof(TKV);  // bytes/lane/row
  static constexpr int kC = kB >= 16 ? 16 : kB;       // bytes per copy
  static constexpr int kSlot = 32 * kB;                // one row, one warp
  static constexpr int kKV = kWarps * kStages * U * 2 * kSlot;
  static constexpr int kScale = QUANT ? kKV / kB * 4 : 0;
  // + one visibility flag per (warp, stage, u, lane), written by the lane
  // that issues the copy and read back by the same lane
  static constexpr int kBytes = kKV + kScale + kWarps * kStages * U * 32 * 4;
  __device__ static int* flag(char* ring, int warp, int stage, int u,
                              int lane) {
    return reinterpret_cast<int*>(ring + kKV + kScale) +
           ((warp * kStages + stage) * U + u) * 32 + lane;
  }
  // slot (warp, stage, u, kind = 0 for K / 1 for V)
  __device__ static int idx(int warp, int stage, int u, int kind) {
    return ((warp * kStages + stage) * U + u) * 2 + kind;
  }
  __device__ static void issue(char* ring, const Params& p, const int* s_ent,
                               const int* s_j, int step, int nstream,
                               int stream, int R, int h, int pb, int sub,
                               int lane, int warp) {
    const int stage = step % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      size_t row;
      const bool ok = locate(p, s_ent, s_j, (step * U + u) * nstream + stream,
                             R, h, pb, row);
      *flag(ring, warp, stage, u, lane) = ok;
      const size_t off = (row * p.D + sub * kEpl) * sizeof(TKV);
#pragma unroll
      for (int kind = 0; kind < 2; ++kind) {
        const char* src = static_cast<const char*>(kind ? p.v : p.k);
        char* dst = ring + idx(warp, stage, u, kind) * kSlot + lane * kC;
#pragma unroll
        for (int c = 0; c < kB / kC; ++c)
          cp_async<kC>(dst + c * 32 * kC, src + (ok ? off + c * kC : 0), ok);
        if constexpr (QUANT) {
          const float* sc = kind ? p.vs : p.ks;
          float* sdst = reinterpret_cast<float*>(ring + kKV) +
                        idx(warp, stage, u, kind) * 32 + lane;
          cp_async<4>(sdst, sc + (ok ? row : 0), ok);
        }
      }
    }
  }
  __device__ static void read(Rows<TKV, U>& r, char* ring, int step,
                              int lane, int warp) {
    const int stage = step % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      r.ok[u] = *flag(ring, warp, stage, u, lane);
#pragma unroll
      for (int kind = 0; kind < 2; ++kind) {
        const char* src = ring + idx(warp, stage, u, kind) * kSlot + lane * kC;
        char* dst = reinterpret_cast<char*>(kind ? &r.v[u] : &r.k[u]);
#pragma unroll
        for (int c = 0; c < kB / kC; ++c) {
          if constexpr (kC == 16)
            *reinterpret_cast<uint4*>(dst + c * 16) =
                *reinterpret_cast<const uint4*>(src + c * 32 * kC);
          else
            *reinterpret_cast<uint2*>(dst + c * 8) =
                *reinterpret_cast<const uint2*>(src + c * 32 * kC);
        }
        if constexpr (QUANT) {
          const float sc = reinterpret_cast<const float*>(ring + kKV)
              [idx(warp, stage, u, kind) * 32 + lane];
          (kind ? r.vs[u] : r.ks[u]) = sc;
        }
      }
    }
  }
};

// The scalar path's register loads (one element per lane, any D <= 256).
template <typename TKV, bool QUANT, int U>
__device__ __forceinline__ void load_rows(Rows<TKV, U>& r, const Params& p,
                                          const int* s_ent, const int* s_j,
                                          int step, int nstream, int stream,
                                          int R, int h, int pb, int sub) {
  const TKV* kpool = static_cast<const TKV*>(p.k);
  const TKV* vpool = static_cast<const TKV*>(p.v);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    size_t row;
    const bool ok = locate(p, s_ent, s_j, (step * U + u) * nstream + stream,
                           R, h, pb, row);
    r.ok[u] = ok;
    r.k[u] = Vec8<TKV>{};              // zeros: masked rows stay finite
    r.v[u] = Vec8<TKV>{};
    r.ks[u] = 0.f;
    r.vs[u] = 0.f;
    if (ok) {
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const int d = sub + 32 * i;
        if (d < p.D) {
          r.k[u].e[i] = kpool[row * p.D + d];
          r.v[u].e[i] = vpool[row * p.D + d];
        }
      }
      if constexpr (QUANT) {
        r.ks[u] = p.ks[row];
        r.vs[u] = p.vs[row];
      }
    }
  }
}

template <typename TKV, bool QUANT, int GH, int U>
__device__ __forceinline__ void attend(const Rows<TKV, U>& r,
                                       const float (&q)[GH][kEpl],
                                       float (&acc)[GH][kEpl], float (&m)[GH],
                                       float (&l)[GH], int lpr) {
  float s[U][GH];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[kEpl];
    to_f32x8(r.k[u], kf);
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) d = fmaf(q[g][i], kf[i], d);
      s[u][g] = d;
    }
  }
  // partial dots -> row dots over the lpr lanes of a row: one stage per
  // xor offset, its U*GH shuffles independent of each other
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= lpr) continue;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GH; ++g)
        s[u][g] += __shfl_xor_sync(kFull, s[u][g], o);
  }
  if constexpr (QUANT) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GH; ++g) s[u][g] *= r.ks[u];
  }
  // online softmax; the running max and the rescale of l and acc are
  // touched only in a step where some lane's max grew (alpha = 1 exactly
  // otherwise, so skipping it changes nothing)
  float mx[GH];
  bool grew = false;
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    mx[g] = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r.ok[u]) mx[g] = fmaxf(mx[g], s[u][g]);
    grew |= mx[g] > m[g];
  }
  if (__any_sync(kFull, grew)) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float alpha = fast_exp2(m[g] - mx[g]);
      m[g] = mx[g];
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) acc[g][i] *= alpha;
    }
  }
#pragma unroll
  for (int g = 0; g < GH; ++g) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = r.ok[u] ? fast_exp2(s[u][g] - m[g]) : 0.f;
      l[g] += pu;
      s[u][g] = QUANT ? pu * r.vs[u] : pu;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[kEpl];
    to_f32x8(r.v[u], vf);
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int i = 0; i < kEpl; ++i)
        acc[g][i] = fmaf(s[u][g], vf[i], acc[g][i]);
  }
}

// Compacts the visible entries of this block's table range into s_ent
// (physical block) and s_j (logical index): an entry that is -1 or lies
// wholly past pos is dropped, as the Pallas update leaves acc unchanged
// there.  Every thread of the block calls it; returns the count.
__device__ __forceinline__ int compact(const Params& p, int b, int split,
                                       int pb, int* s_ent, int* s_j,
                                       int (*s_cnt)[kWarps]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j0 = split * p.chunk;
  const int len = min(p.chunk, p.n_bt - j0);
  int ent[2];
  bool vis[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = c * kThreads + t;
    ent[c] = -1;
    if (i < len) ent[c] = p.bt[(size_t)b * p.n_bt + j0 + i];
    vis[c] = i < len && ent[c] >= 0 && (j0 + i) * p.bs <= pb;
  }
  unsigned bal[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    bal[c] = __ballot_sync(kFull, vis[c]);
    if (lane == 0) s_cnt[c][warp] = __popc(bal[c]);
  }
  __syncthreads();
  int nv = 0, before[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_cnt[c][w];
      if (c * kWarps + w < warp) before[0] += n;
      if (c * kWarps + w < kWarps + warp) before[1] += n;
      nv += n;
    }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (vis[c]) {
      const int at = before[c] + __popc(bal[c] & ((1u << lane) - 1u));
      s_ent[at] = ent[c];
      s_j[at] = j0 + c * kThreads + t;
    }
  __syncthreads();
  return nv;
}

// A range with no visible key: exact zeros, or an empty partial (l = 0).
template <typename TQ, int GH>
__device__ void write_empty(const Params& p, int b, int h, int g0,
                            int split) {
  const int D = p.D, G = p.G, Hq = p.Hkv * G;
  for (int idx = threadIdx.x; idx < GH * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    if (g0 + g >= G) continue;
    const size_t bq = (size_t)b * Hq + h * G + g0 + g;
    if (p.n_split == 1) {
      store(static_cast<TQ*>(p.out) + bq * D + d, 0.f);
    } else if (d == 0) {
      float* part = p.part + (bq * p.n_split + split) * (D + 2);
      part[0] = kNegInf;
      part[1] = 0.f;
    }
  }
}

// The warps' states in red[warp][GH][D + 2] (m, l, acc) -> the block's
// output, or its split's partial (m, l, acc) in p.part.
template <typename TQ, int GH>
__device__ void combine(const Params& p, const float* red, int b, int h,
                        int g0, int split) {
  const int D = p.D, G = p.G, Hq = p.Hkv * G;
  for (int idx = threadIdx.x; idx < GH * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * GH + g) * (D + 2)]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = red + (w * GH + g) * (D + 2);
      const float wt = exp2f(rw[0] - mx);
      L = fmaf(wt, rw[1], L);
      A = fmaf(wt, rw[2 + d], A);
    }
    const size_t bq = (size_t)b * Hq + h * G + g0 + g;
    if (p.n_split == 1) {
      store(static_cast<TQ*>(p.out) + bq * D + d, A / (L == 0.f ? 1.f : L));
    } else {
      float* part = p.part + (bq * p.n_split + split) * (D + 2);
      part[2 + d] = A;
      if (d == 0) {
        part[0] = mx;
        part[1] = L;
      }
    }
  }
}

template <typename TQ, typename TKV, bool QUANT, bool VEC, int GH>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const Params p) {
  constexpr int U = (sizeof(TKV) == 4 || GH == 8) ? 1 : 4;  // rows/step
  static_assert(Ring<TKV, QUANT, U>::kBytes + 2 * kMaxChunk * 4 <= 227 * 1024,
                "ring too big");
  __shared__ int s_ent[kMaxChunk];
  __shared__ int s_j[kMaxChunk];
  __shared__ int s_cnt[2][kWarps];
  // the cp.async ring while streaming, then [kWarps][GH][D + 2] partials
  extern __shared__ __align__(16) float s_red[];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int hg = blockIdx.x % p.n_hg;
  const int bh = blockIdx.x / p.n_hg;
  const int h = bh % p.Hkv, b = bh / p.Hkv;
  const int split = blockIdx.y;
  const int D = p.D, G = p.G, Hq = p.Hkv * G, g0 = hg * GH;
  const int pb = p.pos[b];

  // -- lane -> (stream, row slice)
  const int lpr = VEC ? p.lpr : 32;                // lanes per row
  const int rpw = 32 / lpr;                        // rows per warp and load
  const int sub = lane & (lpr - 1);
  const int stream = warp * rpw + lane / lpr;
  const int nstream = kWarps * rpw;

  float q[GH][kEpl], acc[GH][kEpl], m[GH], l[GH];
  const TQ* qp = static_cast<const TQ*>(p.q);
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const bool live = g0 + g < G;
    const size_t base = ((size_t)b * Hq + h * G + g0 + g) * D;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      const int d = VEC ? sub * kEpl + i : sub + 32 * i;
      q[g][i] = (live && d < D) ? to_f32(qp[base + d]) * p.qscale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const int nv = compact(p, b, split, pb, s_ent, s_j, s_cnt);

  if (nv == 0) {                       // nothing visible in this range
    write_empty<TQ, GH>(p, b, h, g0, split);
    return;
  }

  // -- stream the rows
  const int R = nv * p.bs;
  const int per = U * nstream;
  const int T = (R + per - 1) / per;
  if constexpr (VEC) {
    // cp.async ring: the next kStages-1 steps in flight during this one's math
    using RingT = Ring<TKV, QUANT, U>;
    char* ring = reinterpret_cast<char*>(s_red);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < T)
        RingT::issue(ring, p, s_ent, s_j, st, nstream, stream, R, h, pb, sub,
                     lane, warp);
      cp_async_commit();
    }
    for (int st = 0; st < T; ++st) {
      if (st + kStages - 1 < T)
        RingT::issue(ring, p, s_ent, s_j, st + kStages - 1, nstream, stream,
                     R, h, pb, sub, lane, warp);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      Rows<TKV, U> r;
      RingT::read(r, ring, st, lane, warp);
      attend<TKV, QUANT, GH, U>(r, q, acc, m, l, lpr);
    }
    cp_async_wait<0>();
    __syncthreads();                   // the ring becomes s_red below
  } else {
    // register ping-pong: the next step's loads in flight during this one
    Rows<TKV, U> ra, rb;
    load_rows<TKV, QUANT, U>(ra, p, s_ent, s_j, 0, nstream, stream, R, h,
                             pb, sub);
    for (int st = 0; st < T; st += 2) {
      if (st + 1 < T)
        load_rows<TKV, QUANT, U>(rb, p, s_ent, s_j, st + 1, nstream,
                                 stream, R, h, pb, sub);
      attend<TKV, QUANT, GH, U>(ra, q, acc, m, l, lpr);
      if (st + 1 >= T) break;
      if (st + 2 < T)
        load_rows<TKV, QUANT, U>(ra, p, s_ent, s_j, st + 2, nstream,
                                 stream, R, h, pb, sub);
      attend<TKV, QUANT, GH, U>(rb, q, acc, m, l, lpr);
    }
  }

  // -- merge the lane groups of a warp by shuffles ...
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float m2 = __shfl_xor_sync(kFull, m[g], o);
      const float l2 = __shfl_xor_sync(kFull, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float w1 = exp2f(m[g] - mx), w2 = exp2f(m2 - mx);
      l[g] = w1 * l[g] + w2 * l2;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const float a2 = __shfl_xor_sync(kFull, acc[g][i], o);
        acc[g][i] = w1 * acc[g][i] + w2 * a2;
      }
    }
  }
  // ... and the warps through shared memory
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float* red = s_red + (warp * GH + g) * (D + 2);
      if (lane == 0) {
        red[0] = m[g];
        red[1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const int d = VEC ? sub * kEpl + i : sub + 32 * i;
        if (d < D) red[2 + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  combine<TQ, GH>(p, s_red, b, h, g0, split);
}

// ---------------------------------------------------------------------------
// The tensor-core instantiation: bf16 q and pool, D = 64 or 128.  A warp
// takes tiles of 16 key rows; per tile, scores S^T (16 rows x 8 heads) =
// K (16 x D) . Q^T and O^T (D x 8 heads) += V^T . P^T, each a chain of
// mma.sync m16n8k16 with the head group on N, so the math costs 2 D/16
// MMAs per 16 rows where the CUDA-core path spends ~8 GH FMAs per element.
// P^T is rounded to bf16, as the plain version rounds p to v's dtype.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* a) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(a);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* a) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(a);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned movm_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr int kMmaStages = 2;      // tiles in a warp's ring

template <int D>
struct MmaTile {
  static constexpr int kRow = D * 2;                  // bytes of a bf16 row
  static constexpr int kTile = 16 * kRow;             // one K or V tile
  static constexpr int kWarpBytes = kMmaStages * 2 * kTile;
  static constexpr int kBytes = kWarps * (kWarpBytes + kMmaStages * 4);
  // 16-byte chunk c of row r, XOR-swizzled so that ldmatrix's 8 row
  // addresses at one chunk fall in 8 different bank groups
  __device__ static int at(int r, int c) {
    return r * kRow + ((c ^ (r & 7)) << 4);
  }
};

template <int GH, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_mma_kernel(const Params p) {
  using Tile = MmaTile<D>;
  constexpr int NC = D / 8;                 // 16-byte chunks per row
  constexpr int NK = D / 16;                // k-chunks (QK) = m-tiles (PV)
  __shared__ int s_ent[kMaxChunk];
  __shared__ int s_j[kMaxChunk];
  __shared__ int s_cnt[2][kWarps];
  extern __shared__ __align__(16) float s_red[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int hg = blockIdx.x % p.n_hg;
  const int bh = blockIdx.x / p.n_hg;
  const int h = bh % p.Hkv, b = bh / p.Hkv;
  const int split = blockIdx.y;
  const int G = p.G, Hq = p.Hkv * G, g0 = hg * GH;
  const int pb = p.pos[b];

  // Q^T fragments (B operand): head g0 + gid, d = 16 kc + 2 tq (+8)
  unsigned qf[NK][2];
  {
    const bool live = gid < GH && g0 + gid < G;
    const unsigned* qrow = reinterpret_cast<const unsigned*>(
        static_cast<const __nv_bfloat16*>(p.q) +
        ((size_t)b * Hq + h * G + g0 + (live ? gid : 0)) * D);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      qf[kc][0] = live ? qrow[kc * 8 + tq] : 0u;
      qf[kc][1] = live ? qrow[kc * 8 + tq + 4] : 0u;
    }
  }

  const int nv = compact(p, b, split, pb, s_ent, s_j, s_cnt);
  if (nv == 0) {
    write_empty<__nv_bfloat16, GH>(p, b, h, g0, split);
    return;
  }

  const int R = nv * p.bs;
  const int n_tiles = (R + 15) / 16;
  const int T = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  char* ring = reinterpret_cast<char*>(s_red) + warp * Tile::kWarpBytes;
  int* masks = reinterpret_cast<int*>(reinterpret_cast<char*>(s_red) +
                                      kWarps * Tile::kWarpBytes) +
               warp * kMmaStages;
  const char* kbase = static_cast<const char*>(p.k);
  const char* vbase = static_cast<const char*>(p.v);

  // one tile: lane r < 16 locates row r; each copy instruction then takes
  // 32/NC whole rows, NC consecutive lanes on one row's NC 16-byte chunks
  auto issue = [&](int i) {
    const int stage = i % kMmaStages;
    size_t row;
    const bool ok = locate(p, s_ent, s_j, (warp + i * kWarps) * 16 +
                           (lane & 15), R, h, pb, row);
    const unsigned bits = __ballot_sync(kFull, ok) & 0xffffu;
    if (lane == 0) masks[stage] = (int)bits;
    const unsigned row32 = (unsigned)row;
    char* kt = ring + stage * 2 * Tile::kTile;
    char* vt = kt + Tile::kTile;
    constexpr int RPI = 32 / NC;
    const int c = lane % NC;
#pragma unroll
    for (int k = 0; k < 16 / RPI; ++k) {
      const int r = lane / NC + k * RPI;
      const unsigned rw = __shfl_sync(kFull, row32, r);
      const bool okr = (bits >> r) & 1u;
      const size_t off = okr ? (size_t)rw * Tile::kRow + c * 16 : 0;
      cp_async<16>(kt + Tile::at(r, c), kbase + off, okr);
      cp_async<16>(vt + Tile::at(r, c), vbase + off, okr);
    }
  };

  float o[NK][4];                           // O^T: d = 16 mt + gid (+8)
#pragma unroll
  for (int mt = 0; mt < NK; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // heads 2tq, 2tq+1
  const int mi = lane >> 3, rr = lane & 7;

#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < T) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < T; ++i) {
    if (i + kMmaStages - 1 < T) issue(i + kMmaStages - 1);
    cp_async_commit();
    cp_async_wait<kMmaStages - 1>();
    __syncwarp();
    const int stage = i % kMmaStages;
    const char* kt = ring + stage * 2 * Tile::kTile;
    const char* vt = kt + Tile::kTile;
    const unsigned bits = (unsigned)masks[stage];      // bit r: row r
    const bool ok0 = (bits >> gid) & 1u;
    const bool ok1 = (bits >> (gid + 8)) & 1u;

    // S^T[row gid (+8)][head 2tq (+1)], in two chains of D/32 MMAs
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sc2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      unsigned a[4];
      ldsm_x4(a, kt + Tile::at(rr + (mi & 1) * 8, kc * 2 + (mi >> 1)));
      mma16816(kc & 1 ? sc2 : sc, a, qf[kc][0], qf[kc][1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] += sc2[e];
    float s0[2], s1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s0[e] = ok0 ? sc[e] * p.qscale : kNegInf;
      s1[e] = ok1 ? sc[2 + e] * p.qscale : kNegInf;
    }
    float mx[2];
    bool grew = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = fmaxf(s0[e], s1[e]);
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, o2));
      mx[e] = fmaxf(m[e], v);
      grew |= mx[e] > m[e];
    }
    if (__any_sync(kFull, grew)) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float alpha = fast_exp2(m[e] - mx[e]);
        m[e] = mx[e];
        l[e] *= alpha;
#pragma unroll
        for (int mt = 0; mt < NK; ++mt) {
          o[mt][e] *= alpha;
          o[mt][2 + e] *= alpha;
        }
      }
    }
    float p0[2], p1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p0[e] = ok0 ? fast_exp2(s0[e] - m[e]) : 0.f;
      p1[e] = ok1 ? fast_exp2(s1[e] - m[e]) : 0.f;
      l[e] += p0[e] + p1[e];
    }
    // P^T as the B operand: rows 0-7 and 8-15, transposed in registers
    const unsigned b0 = movm_t(pack_bf16(p0[0], p0[1]));
    const unsigned b1 = movm_t(pack_bf16(p1[0], p1[1]));
#pragma unroll
    for (int mt = 0; mt < NK; ++mt) {
      unsigned a[4];
      ldsm_x4_t(a, vt + Tile::at(rr + (mi >> 1) * 8, mt * 2 + (mi & 1)));
      mma16816(o[mt], a, b0, b1);
    }
    __syncwarp();                          // the stage is free for reuse
  }
  cp_async_wait<0>();

  // l over the 8 lanes that share tq (rows); m is already shared
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o2 = 4; o2 < 32; o2 <<= 1)
      l[e] += __shfl_xor_sync(kFull, l[e], o2);
  __syncthreads();                         // every ring is done: s_red now
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = 2 * tq + e;
    if (g >= GH) continue;
    float* red = s_red + (warp * GH + g) * (D + 2);
    if (gid == 0) {
      red[0] = m[e];
      red[1] = l[e];
    }
#pragma unroll
    for (int mt = 0; mt < NK; ++mt) {
      red[2 + mt * 16 + gid] = o[mt][e];
      red[2 + mt * 16 + gid + 8] = o[mt][2 + e];
    }
  }
  __syncthreads();
  combine<__nv_bfloat16, GH>(p, s_red, b, h, g0, split);
}

// One block per (slot, query head): combine the n_split partials.  A split
// with l == 0 saw no visible key and wrote only m and l; it is skipped.
// Each thread folds the splits for its d in one pass (online log-sum-exp),
// its loads independent of each other: one round trip to memory.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_attn_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                        int n_split, int D) {
  const size_t bq = blockIdx.x;
  const float* pp = part + bq * n_split * (D + 2);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float M = kNegInf, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float* ps = pp + (size_t)s * (D + 2);
      const float ms = ps[0], ls = ps[1], as = ps[2 + d];
      if (ls > 0.f) {
        const float mx = fmaxf(M, ms);
        const float a = fast_exp2(M - mx), b = fast_exp2(ms - mx);
        L = fmaf(L, a, ls * b);
        A = fmaf(A, a, as * b);
        M = mx;
      }
    }
    store(out + bq * D + d, A / (L == 0.f ? 1.f : L));
  }
}

template <typename TQ, typename TKV, bool QUANT, bool VEC, int GH>
int launch_split(const Params& p, int B, cudaStream_t stream) {
  constexpr int U = (sizeof(TKV) == 4 || GH == 8) ? 1 : 4;
  size_t smem = sizeof(float) * (size_t)kWarps * GH * (p.D + 2);
  if (VEC && smem < (size_t)Ring<TKV, QUANT, U>::kBytes)
    smem = Ring<TKV, QUANT, U>::kBytes;
  auto kern = paged_attn_split_kernel<TQ, TKV, QUANT, VEC, GH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B * p.Hkv * p.n_hg, p.n_split), dim3(kThreads), smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

template <int GH, int D>
int launch_mma(const Params& p, int B, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)kWarps * GH * (D + 2);
  if (smem < (size_t)MmaTile<D>::kBytes) smem = MmaTile<D>::kBytes;
  auto kern = paged_attn_split_mma_kernel<GH, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B * p.Hkv * p.n_hg, p.n_split), dim3(kThreads), smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma_gh(const Params& p, int GH, int B, cudaStream_t s) {
  switch (GH) {
    case 1: return launch_mma<1, D>(p, B, s);
    case 2: return launch_mma<2, D>(p, B, s);
    case 4: return launch_mma<4, D>(p, B, s);
    default: return launch_mma<8, D>(p, B, s);
  }
}

template <typename TQ, typename TKV, bool QUANT, bool VEC>
int launch_gh(const Params& p, int GH, int B, cudaStream_t s) {
  switch (GH) {
    case 1: return launch_split<TQ, TKV, QUANT, VEC, 1>(p, B, s);
    case 2: return launch_split<TQ, TKV, QUANT, VEC, 2>(p, B, s);
    case 4: return launch_split<TQ, TKV, QUANT, VEC, 4>(p, B, s);
    default: return launch_split<TQ, TKV, QUANT, VEC, 8>(p, B, s);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(Params p, int GH, int B, int Hq, cudaStream_t s) {
  const int vec_bytes = 8 * (int)sizeof(TKV) >= 16 ? 16 : 8 * (int)sizeof(TKV);
  const bool vec = p.D % kEpl == 0 && 32 % (p.D / kEpl) == 0 &&
                   (uintptr_t)p.k % vec_bytes == 0 &&
                   (uintptr_t)p.v % vec_bytes == 0;
  p.lpr = vec ? p.D / kEpl : 32;
  int err;
  if constexpr (std::is_same_v<TQ, __nv_bfloat16> &&
                std::is_same_v<TKV, __nv_bfloat16>) {
    const bool mma = vec && (uintptr_t)p.q % 4 == 0;
    if (mma && p.D == 128)
      err = launch_mma_gh<128>(p, GH, B, s);
    else if (mma && p.D == 64)
      err = launch_mma_gh<64>(p, GH, B, s);
    else
      err = vec ? launch_gh<TQ, TKV, QUANT, true>(p, GH, B, s)
                : launch_gh<TQ, TKV, QUANT, false>(p, GH, B, s);
  } else {
    err = vec ? launch_gh<TQ, TKV, QUANT, true>(p, GH, B, s)
              : launch_gh<TQ, TKV, QUANT, false>(p, GH, B, s);
  }
  if (err != 0 || p.n_split == 1) return err;
  paged_attn_merge_kernel<TQ><<<dim3(B * Hq), dim3(kThreads), 0, s>>>(
      p.part, static_cast<TQ*>(p.out), p.n_split, p.D);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale/v_scale required).  A float pool must match q's dtype.
// chunk: table entries per split (1..512); n_split = ceil(n_bt / chunk).
// heads: query heads per block (1, 2, 4 or 8); a kv head's G = Hq/Hkv heads
// take ceil(G / heads) blocks.  The caller chooses chunk and heads (it sizes
// the grid and the scratch from them); this entry only checks them.
// part: f32 scratch of B*Hq*n_split*(D+2) floats, unused when n_split == 1.
// One call is one launch (n_split == 1) or two (split, then merge).
// Returns cudaGetLastError() after the launches.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* bt, const void* pos, void* out,
                               void* part, int B, int Hq, int Hkv, int D,
                               int n_bt, int bs, int chunk, int heads,
                               int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D > kMaxD || n_bt <= 0 ||
      bs <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      (heads != 1 && heads != 2 && heads != 4 && heads != 8))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(bt);
  p.pos = static_cast<const int*>(pos);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.D = D;
  p.n_bt = n_bt;
  p.bs = bs;
  p.chunk = chunk;
  p.n_split = (n_bt + chunk - 1) / chunk;
  p.n_hg = (p.G + heads - 1) / heads;
  p.qscale = (float)(kLog2e / sqrt((double)D));
  p.inv_bs = 1.f / (float)bs;
  if (p.n_split > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(p, heads, B, Hq, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(p, heads, B, Hq, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true>(p, heads, B, Hq, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(p, heads, B, Hq, s);
  return (int)cudaErrorInvalidValue;
}
