"""Where the PSI matmuls' prefill routes spend their time, on the card.

    python tools/psi_rows_probe.py

1. The tensor cores' ceiling for this kernel's instruction mix:
   ``mma.sync.m16n8k16`` (bf16 in, f32 sums) on register operands alone,
   and with the int8-to-bf16 decode of ``csrc/psi_common.cuh``
   (``code_pair``) in front of it, 8 warps a block and 1, 2 or 4 blocks an
   SM: TFLOP/s.
2. ``psi_gemm_codes_rows_kernel`` with part of its work left out:
   ``csrc/psi_rows.cu`` is built once more with a switch that skips its
   x copies, its code copies or both (the stages then hold stale bytes, so
   the outputs are wrong and only the times mean anything), timed at
   qwen3-8b's wq, w_gate and lm-head at 288 rows and whisper's 512 x 2048
   at 6000, in the layout the wrapper picks.
3. ``psi_gemm_packed_rows_kernel`` (kernel 2's prefill route) built once
   more with ``clock64()`` marks between the phases of its loop over the
   64-K groups, read by lane 0 of each warp of the first block: clocks a
   group in the copy wait, the barrier, the x copies' issue, the decode
   (plane words to A fragments, the next group's plane loads issued), the
   MMAs (x fragments read, ``mma.sync`` issued) and the walk with the
   chains' sums, at psi5 on granite-34b's wq and w_down and qwen3-8b's
   w_gate at 288 rows.  The marks order the phases, so the total is a
   little above the route's own.

Builds with nvcc into a temporary directory and prints one JSON line a
measurement, each with the card's name and power limit.  Needs a card; imports
no JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

CEILING_CU = r"""
#include "psi_common.cuh"
// 4 A tiles x 4 token tiles a step, as the route's 64-channel blocks
template <bool DECODE>
__global__ void __launch_bounds__(256) ceiling(float* out, int iters) {
  float acc[4][4][4] = {};
  uint32_t w0 = threadIdx.x, w1 = 3u, w2 = 7u, w3 = 0x55u;
  const uint32_t xb = 0x3f803f80u ^ threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      uint32_t f[4];
      if (DECODE) {
        f[0] = code_pair(w0, w1, a & 3);
        f[1] = code_pair(w0, w1, (a + 1) & 3);
        f[2] = code_pair(w2, w3, a & 3);
        f[3] = code_pair(w2, w3, (a + 1) & 3);
      } else {
        f[0] = w0 + a; f[1] = w1; f[2] = w2; f[3] = w3;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_bf16(acc[a][n], f, xb + n, xb ^ n);
    }
    w0 += 0x01010101u;
    w1 ^= it;
  }
  float s = 0.f;
  for (int a = 0; a < 4; ++a)
    for (int n = 0; n < 4; ++n)
      for (int c = 0; c < 4; ++c) s += acc[a][n][c];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" int run(int decode, int blocks, float* out, int iters) {
  if (decode) ceiling<true><<<blocks, 256>>>(out, iters);
  else ceiling<false><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

# the route's copies, and what the probe build puts in their place
PATCHES = (
    ("namespace {\n", "namespace {\n__constant__ int rows_probe = 0;\n"),
    ("          cp_async16(d, ok ? x + (size_t)tok * K + k : x, ok ? 16 : 0);",
     "          if (!(rows_probe & 1))\n"
     "            cp_async16(d, ok ? x + (size_t)tok * K + k : x, ok ? 16 : 0);"),
    ("          cp_async16(d, ok ? src : codes, ok ? 16 : 0);",
     "          if (!(rows_probe & 2)) cp_async16(d, ok ? src : codes, ok ? 16 : 0);"),
)
SETTER = """
extern "C" int set_rows_probe(int p) {
  return (int)cudaMemcpyToSymbol(rows_probe, &p, sizeof(int));
}
"""
SKIPS = {0: "all", 1: "no_x_copies", 2: "no_code_copies", 3: "no_copies"}

# kernel 2's prefill route with clock marks: lane 0 of each warp of block
# (0, 0, 0) adds the clocks since the last mark to its phase's count
PHASES = ("copy_wait", "barrier", "x_copies", "decode", "mma", "sums")
CLOCK_PATCHES = (
    ("namespace {\n", "__device__ long long packed_clocks[4][8];\n"
     "namespace {\n"),
    ("  int s0 = 0;                                       // x stage: e % 3\n",
     "  int s0 = 0;\n"
     "  long long clk[6] = {0, 0, 0, 0, 0, 0}, last = clock64();\n"
     "  const bool mark = blockIdx.x + blockIdx.y + blockIdx.z == 0 && "
     "lane == 0;\n"
     "#define MARK(k) if (mark) { const long long c_ = clock64(); "
     "clk[k] += c_ - last; last = c_; }\n"),
    ("  for (int e = e_begin; e < e_end; ++e) {\n"
     "    const int s1 = s0 == 2 ? 0 : s0 + 1, s2 = s1 == 2 ? 0 : s1 + 1;\n",
     "  for (int e = e_begin; e < e_end; ++e) {\n"
     "    MARK(5)\n"
     "    const int s1 = s0 == 2 ? 0 : s0 + 1, s2 = s1 == 2 ? 0 : s1 + 1;\n"),
    ("    cp_async_wait<1>();\n    __syncthreads();\n"
     "    copy_x(en[2] >> 5, s2, e + 2 < e_end);\n    cp_async_commit();\n",
     "    cp_async_wait<1>();\n    MARK(0)\n    __syncthreads();\n    MARK(1)\n"
     "    copy_x(en[2] >> 5, s2, e + 2 < e_end);\n    cp_async_commit();\n"
     "    MARK(2)\n"),
    ("    const char* st = xs + s0 * kPackedXBytes;\n",
     "    MARK(3)\n    const char* st = xs + s0 * kPackedXBytes;\n"),
    ("    s0 = s1;\n    const int cur = en[0];\n",
     "    MARK(4)\n    s0 = s1;\n    const int cur = en[0];\n"),
    ("  cp_async_wait<0>();\n  // sum k of thread T: acc[a = k / 8]",
     "  MARK(5)\n  if (mark) {\n    for (int k = 0; k < 6; ++k) "
     "packed_clocks[warp][k] = clk[k];\n"
     "    packed_clocks[warp][6] = e_end - e_begin;\n  }\n"
     "  cp_async_wait<0>();\n  // sum k of thread T: acc[a = k / 8]"),
)
CLOCK_READER = """
extern "C" int read_packed_clocks(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, packed_clocks, sizeof(packed_clocks));
}
"""


def _nvcc(src: Path, out: Path) -> None:
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")


def _ms(torch, fn, iters=20, reps=3):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        best.append(s.elapsed_time(e) / iters)
    return sorted(best)[len(best) // 2]


def ceiling(torch, tmp: Path, card: str) -> None:
    cu = tmp / "ceiling.cu"
    cu.write_text(CEILING_CU)
    _nvcc(cu, tmp / "ceiling.so")
    lib = ctypes.CDLL(str(tmp / "ceiling.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sm * 4 * 256, device="cuda")
    iters = 2000
    for decode in (0, 1):
        for per_sm in (1, 2, 4):
            def go():
                if lib.run(decode, n_sm * per_sm, out.data_ptr(), iters):
                    raise SystemExit("ceiling kernel failed to launch")
            ms = _ms(torch, go, iters=1)
            mmas = n_sm * per_sm * 8 * iters * 4 * 4
            print(json.dumps({"probe": "mma_sync_ceiling", "card": card,
                              "int8_decode": bool(decode),
                              "blocks_per_sm": per_sm,
                              "tflop_per_s": mmas * 4096 / ms / 1e9}),
                  flush=True)


def route(torch, tmp: Path, card: str) -> None:
    from repro_torch.core import psi
    from repro_torch.kernels import psi_matmul as pm
    src = (SRC / "repro_torch" / "csrc" / "psi_rows.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/psi_rows.cu no longer holds {old!r}")
        src = src.replace(old, new)
    cu = tmp / "psi_rows_probe.cu"
    cu.write_text(src + SETTER)
    _nvcc(cu, tmp / "probe.so")
    lib = ctypes.CDLL(str(tmp / "probe.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.psi_matmul_codes_rows.argtypes = [P] * 4 + [I] * 7 + [P]
    lib.set_rows_probe.argtypes = [I]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("wq", 4096, 4096, 288), ("w_gate", 4096, 12288, 288),
             ("lm_head", 4096, 151936, 288), ("whisper w_up", 512, 2048, 6000)]
    for label, K, N, M in cases:
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        qt = psi.quantize_weights(w, 8, axis=(0,))
        del w
        scale = qt.scale.reshape(-1)
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        tile, chunk, _, cluster = pm.codes_launch_plan(M, K, N, n_sm)
        row = {"probe": "rows_route_parts", "card": card, "weight": label,
               "K": K, "N": N, "M": M, "rows_cluster": cluster}
        for skip, name in SKIPS.items():
            if lib.set_rows_probe(skip):
                raise SystemExit("could not set the probe switch")

            def go():
                err = lib.psi_matmul_codes_rows(
                    x.data_ptr(), qt.data.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), M, K, N, 1, tile, chunk, cluster,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"probe launch failed: {err}")
            row[f"{name}_device_ms"] = _ms(torch, go)
        print(json.dumps(row), flush=True)
        del qt, x, out
        torch.cuda.empty_cache()


def packed(torch, tmp: Path, card: str) -> None:
    from repro_torch.core import psi
    from repro_torch.kernels import psi_matmul as pm
    src = (SRC / "repro_torch" / "csrc" / "psi_rows.cu").read_text()
    for old, new in CLOCK_PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/psi_rows.cu no longer holds {old!r}")
        src = src.replace(old, new)
    cu = tmp / "psi_rows_clocks.cu"
    cu.write_text(src + CLOCK_READER)
    _nvcc(cu, tmp / "clocks.so")
    lib = ctypes.CDLL(str(tmp / "clocks.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.psi_matmul_packed_rows.argtypes = [P] * 4 + [I] * 9 + [P]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("granite wq", 6144, 6144, 288), ("granite w_down", 24576, 6144,
                                                288),
             ("qwen3-8b w_gate", 4096, 12288, 288)]
    for label, K, N, M in cases:
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        qt = psi.quantize_weights(w, 5, axis=(0,)).pack()
        del w
        scale = qt.scale.reshape(-1)
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        chunk, _ = pm.packed_launch_plan(M, K, N, n_sm)

        def go():
            err = lib.psi_matmul_packed_rows(
                x.data_ptr(), qt.data.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, K, N, 5, 1, chunk,
                *pm.packed_rows_grid(M, K, N, chunk),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"probe launch failed: {err}")
        ms = _ms(torch, go)
        h = (ctypes.c_longlong * 32)()
        if lib.read_packed_clocks(h):
            raise SystemExit("could not read the clock marks")
        groups = h[6]
        row = {"probe": "packed_rows_phases", "card": card, "weight": label,
               "K": K, "N": N, "M": M, "bits": 5, "device_ms": ms,
               "groups_a_block": groups}
        for k, name in enumerate(PHASES):
            row[f"{name}_clocks_a_group"] = sum(
                h[8 * wp + k] for wp in range(4)) / 4 / groups
        print(json.dumps(row), flush=True)
        del qt, x, out
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("psi_rows_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    with tempfile.TemporaryDirectory() as d:
        ceiling(torch, Path(d), card)
        route(torch, Path(d), card)
        packed(torch, Path(d), card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
