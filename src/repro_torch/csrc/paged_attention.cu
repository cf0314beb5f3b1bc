// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_kernel_body): GQA decode attention that walks each slot's block
// table through the KV block pool, with no gathered temporary.
//
//   q      (B, Hq, D)            f32 or bf16
//   pools  (N, bs, Hkv, D)       same dtype as q, or int8 codes with
//   scales (N, bs, Hkv, 1) f32   per-entry k/v scales (kv_quant="int8")
//   bt     (B, n_bt) int32       physical block per logical block, -1 = none
//   pos    (B,) int32            query position; key j*bs+o is visible iff
//                                bt[b][j] >= 0 and j*bs+o <= pos[b]
//   out    (B, Hq, D)            q's dtype; exact zeros where no key is visible
//
// Bound on the H100: every visible pool block of K and V (plus its scales)
// is read once, so the bound is streamed_bytes(valid entries) over the memory
// rate (B=4 slots at 512 positions, bf16, full qwen3-8b width: 8.4 MB per
// layer, 2.5 us at 3.35 TB/s).  The arithmetic (2 products of G x bs x D per
// block) is far below the card's rate.
//
// Design against that bound (a first, simple kernel):
//   * One 128-thread block per (slot b, kv head h): the G = Hq/Hkv query heads
//     sharing head h reuse every K/V row the block loads.  q is held in f32.
//   * The TPU's sequential table axis j becomes a loop inside the block.  An
//     entry that is -1, or lies wholly past pos (j*bs > pos[b]), is skipped:
//     the Pallas kernel's masking gives p = 0 and alpha = 1 there, so skipping
//     is the same result without reading the block.
//   * Each visible block's K and V rows for head h (row stride Hkv*D in the
//     (N, bs, Hkv, D) pool) are loaded coalesced into shared memory as f32,
//     int8 rows dequantized by their per-entry scale on the way.
//   * Scores (G x bs) by warp-reduced dot products, then the online softmax
//     update (running max m, sum l, f32 accumulator) with p re-masked, then
//     acc = alpha*acc + p.V; epilogue acc / (l == 0 ? 1 : l).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                  const TKV* __restrict__ vpool,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ bt, const int* __restrict__ pos,
                  TQ* __restrict__ out, int n_bt, int bs, int Hkv, int D,
                  int G, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [G][D]
  float* acc = qs + G * D;          // [G][D]
  float* ks = acc + G * D;          // [bs][D]
  float* vs = ks + bs * D;          // [bs][D]
  float* sc = vs + bs * D;          // [G][bs]  scores, then p
  float* mrun = sc + G * bs;        // [G]
  float* lrun = mrun + G;           // [G]
  float* alpha = lrun + G;          // [G]

  const int b = blockIdx.x, h = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = kThreads / 32;
  const int Hq = Hkv * G;
  const int p_b = pos[b];

  for (int idx = t; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    qs[idx] = to_f32(q[((size_t)b * Hq + h * G + g) * D + d]);
    acc[idx] = 0.f;
  }
  if (t < G) {
    mrun[t] = kNegInf;
    lrun[t] = 0.f;
  }

  for (int j = 0; j < n_bt; ++j) {
    const int entry = bt[(size_t)b * n_bt + j];
    if (entry < 0 || j * bs > p_b) continue;     // uniform over the block
    __syncthreads();
    for (int idx = t; idx < bs * D; idx += kThreads) {
      const int o = idx / D, d = idx % D;
      const size_t row = (size_t)entry * bs + o;
      const size_t off = (row * Hkv + h) * D + d;
      float kv = to_f32(kpool[off]), vv = to_f32(vpool[off]);
      if constexpr (QUANT) {
        kv *= kscale[row * Hkv + h];
        vv *= vscale[row * Hkv + h];
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();
    for (int pr = warp; pr < G * bs; pr += nwarps) {
      const int g = pr / bs, o = pr % bs;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[g * D + d] * ks[o * D + d];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
      if (lane == 0) sc[pr] = (j * bs + o <= p_b) ? s * sm_scale : kNegInf;
    }
    __syncthreads();
    if (t < G) {
      float mx = kNegInf;
      for (int o = 0; o < bs; ++o) mx = fmaxf(mx, sc[t * bs + o]);
      const float m_new = fmaxf(mrun[t], mx);
      const float a = expf(mrun[t] - m_new);
      float sum = 0.f;
      for (int o = 0; o < bs; ++o) {
        const float pv = (j * bs + o <= p_b) ? expf(sc[t * bs + o] - m_new)
                                             : 0.f;
        sc[t * bs + o] = pv;
        sum += pv;
      }
      lrun[t] = a * lrun[t] + sum;
      mrun[t] = m_new;
      alpha[t] = a;
    }
    __syncthreads();
    for (int idx = t; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      float s = 0.f;
      for (int o = 0; o < bs; ++o) s += sc[g * bs + o] * vs[o * D + d];
      acc[idx] = alpha[g] * acc[idx] + s;
    }
  }
  __syncthreads();
  for (int idx = t; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const float l = lrun[g];
    store(out + ((size_t)b * Hq + h * G + g) * D + d,
          acc[idx] / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* pos, void* out, int B,
           int Hq, int Hkv, int D, int n_bt, int bs, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      (size_t)(2 * G * D + 2 * bs * D + G * bs + 3 * G);
  auto kern = paged_attn_kernel<TQ, TKV, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  kern<<<dim3(B, Hkv), dim3(kThreads), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<TQ*>(out), n_bt, bs, Hkv, D,
      G, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale/v_scale required).  A float pool must match q's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* bt, const void* pos, void* out,
                               int B, int Hq, int Hkv, int D, int n_bt,
                               int bs, int q_dtype, int kv_dtype,
                               void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || n_bt <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k, v, k_scale, v_scale, bt, pos,
                                       out, B, Hq, Hkv, D, n_bt, bs, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, k_scale, v_scale, bt, pos, out, B, Hq, Hkv, D, n_bt, bs, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, bt, pos,
                                       out, B, Hq, Hkv, D, n_bt, bs, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k, v, k_scale, v_scale, bt, pos, out, B, Hq, Hkv, D, n_bt, bs, s);
  return (int)cudaErrorInvalidValue;
}
