// PSI matmul kernels for Hopper (sm_90a): y[M,N] = (x[M,K] @ W[K,N]) * scale[N]
// with W held in PSI serving format and expanded in registers.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   psi_matmul_codes  <- repro/kernels/psi_matmul.py::psi_matmul_int8
//                        (body _int8_kernel; int8 codes (K, N))
//   psi_matmul_packed <- repro/kernels/psi_matmul.py::psi_matmul_packed
//                        (body _packed_kernel; uint8 bit-planes (bits, K/8, N),
//                        bit j of planes[b][i][n] is bit b of the offset-binary
//                        weight 8i+j, bits 2..7)
//
// Bound on the H100: on the serving path M is the decode batch (1-16), so the
// work is a GEMV over the weight: every code byte (or bits/8 plane bytes per
// weight) is read once from HBM and used M times.  The bound is the weight
// bytes over the memory rate (wq 16.8 MB -> 5.0 us at 3.35 TB/s; packed psi5
// reads 5/8 of that).  Prefill (M = prompt tokens) is the only place the
// arithmetic (2*M*K*N) could matter.
//
// Design against that bound (a first, simple kernel — no tensor cores, no TMA):
//   * One 256-thread block per (32-column N tile, BM-row M tile).  Lanes read
//     4 adjacent columns per load (char4 / one 32-bit word per plane), so the
//     8 threads of one K row fetch one 32-byte sector and a warp four rows.
//     When N % 4 != 0 (or W is not 4-byte aligned) the rows are not word
//     aligned, so a second instantiation (VEC = false, BM = 8 only) reads
//     the same 4 columns byte by byte instead, masking the columns past N;
//     the aligned shapes of the serving path keep the word loads.
//   * The TPU's sequential K grid axis becomes a loop inside the block: the
//     32 K-lanes of the block stride over K, each accumulating BM x 4 f32
//     partial sums in registers; one shared-memory pass reduces the K-lanes,
//     applies scale[n] once and stores in x's dtype.
//   * x is staged in shared memory as f32, 512 K values per pass.
//   * BM (1, 4 or 8) follows M so a decode step does not pay for padded rows.
//   * Ragged M, N and K are masked, never padded: the packed kernel reads only
//     the K/8 plane rows that exist, so no padded byte (which would decode to
//     -2^(bits-1)) is ever touched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                 // columns per block
constexpr int kColGroups = kBN / 4;     // 8 lanes of 4 columns
constexpr int kKLanes = kThreads / kColGroups;   // 32 lanes over K
constexpr int kKC = 512;                // K values of x staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// BITS == 8: W is int8 codes (K, N), one unit = one K row.
// BITS < 8:  W is uint8 planes (BITS, K/8, N), one unit = 8 K rows.
template <int BITS, int BM, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads)
psi_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, T* __restrict__ out,
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
      xs[idx] = (row < M && k < K) ? to_f32(x[(size_t)row * K + k]) : 0.f;
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
    store(out + (size_t)row * N + n, s * scale[n]);
  }
}

template <int BITS, typename T>
int launch_t(const void* x, const void* w, const void* scale, void* out,
             int M, int K, int N, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int gx = (N + kBN - 1) / kBN;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (N % 4 || reinterpret_cast<uintptr_t>(w) % 4) {
    psi_gemm_kernel<BITS, 8, false, T>
        <<<dim3(gx, (M + 7) / 8), block, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else if (M == 1) {
    psi_gemm_kernel<BITS, 1, true, T><<<dim3(gx, M), block, 0, stream>>>(
        xp, wp, sp, op, M, K, N);
  } else if (M <= 4) {
    psi_gemm_kernel<BITS, 4, true, T><<<dim3(gx, 1), block, 0, stream>>>(
        xp, wp, sp, op, M, K, N);
  } else {
    psi_gemm_kernel<BITS, 8, true, T>
        <<<dim3(gx, (M + 7) / 8), block, 0, stream>>>(xp, wp, sp, op, M, K, N);
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int launch(const void* x, const void* w, const void* scale, void* out,
           int M, int K, int N, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_t<BITS, float>(x, w, scale, out, M, K, N, stream);
  if (dtype == 1)
    return launch_t<BITS, __nv_bfloat16>(x, w, scale, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns cudaGetLastError().
extern "C" int psi_matmul_codes(const void* x, const void* codes,
                                const void* scale, void* out, int M, int K,
                                int N, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  return launch<8>(x, codes, scale, out, M, K, N, dtype,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int psi_matmul_packed(const void* x, const void* planes,
                                 const void* scale, void* out, int M, int K,
                                 int N, int bits, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, planes, scale, out, M, K, N, dtype, s);
    case 3: return launch<3>(x, planes, scale, out, M, K, N, dtype, s);
    case 4: return launch<4>(x, planes, scale, out, M, K, N, dtype, s);
    case 5: return launch<5>(x, planes, scale, out, M, K, N, dtype, s);
    case 6: return launch<6>(x, planes, scale, out, M, K, N, dtype, s);
    case 7: return launch<7>(x, planes, scale, out, M, K, N, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
