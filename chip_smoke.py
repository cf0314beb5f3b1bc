#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, serves
full-width qwen3-8b from PSI codes through them, and compares the card with
the CPU.  Phases, each printing one JSON line; any failure exits non-zero
before the result line:

  1. card and build    — nvidia-smi name and power limit, kernel build time;
  2. kernels           — each kernel against its plain version at the
                         serving shapes (and ragged reduced ones, f32 and,
                         for kernel 1, bf16 with any K; for paged
                         attention also tables long enough to split, every
                         (G, D) of the configs), with its eager median time
                         (ms), its device time from CUDA-graph replays
                         (device_ms), its host time per call (host_ms), the
                         plain version's, one library call's (yardstick
                         only) and the memory bound;
  3. serve psi8        — Server.serve of qwen3-8b, all 36 layers, in
                         continuous and static modes: identical tokens, and
                         253 PSI-matmul (kernel 1) + 36 attention launches
                         per decode step, each step a replay of the captured
                         decode graph; a profiled decode window three ways:
                         the eager step, the horizon-1 graph and a horizon-8
                         round graph over 8;
  3b. serve psi8 at horizon 8 (serve_psi8_horizon) — the same trace in
                         rounds of 8 steps: tokens identical to horizon 1,
                         the same launch counts per step under replay, one
                         captured round graph;
  4. serve psi5        — the same as 3 at psi5, all 36 layers, fewer
                         requests: the packed path (kernel 2), 253 launches
                         per step;
  5. card vs CPU       — prefill + 8 greedy decode steps of a 2-layer
                         float32 psi8 model on the card and on the CPU;
  6. summary           — {"kernels": [...]}, the card line, then the result
                         {"ok": true, "device": {...}} as the last line.

It exits non-zero, printing no result, without a CUDA device or when the
repository's ``src/repro_torch`` is not beside it.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the main path's weight shapes (K, N) and launches per decode step
# (36 layers x wq, wk, wv, wo, w_gate, w_up, w_down, plus lm_head = 253)
N_LAYERS = 36
SHAPES = {
    "wq/wo": ((4096, 4096), 2 * N_LAYERS),
    "wk/wv": ((4096, 1024), 2 * N_LAYERS),
    "w_gate/w_up": ((4096, 12288), 2 * N_LAYERS),
    "w_down": ((12288, 4096), N_LAYERS),
    "lm_head": ((4096, 151936), 1),
}
DECODE_M = 4                     # decode rows = max_batch of the serve phase
HORIZON = 8                      # decode steps per round, serve_psi8_horizon
PREFILL_M = 64                   # one admission's bucketed prompt
L2_BYTES = 50e6                  # H100 L2: rotate weight copies past it


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    emit({"ok": False, "error": msg})
    raise SystemExit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_rates(name):
    """(bytes/s, bf16 dense FLOP/s) of the H100 SXM from NVIDIA's data
    sheet; any other card fails rather than get a bound from guessed
    rates."""
    check("H100" in name and "HBM3" in name,
          f"no memory and compute rates known for {name!r} (H100 SXM only)")
    return 3.35e12, 989e12


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the H100",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # the f32 yardsticks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. card/build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    bw, peak = card_rates(name)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    build = _build.build_all()
    build_s = time.perf_counter() - t0
    regs = {}
    for src in _build.SOURCES:
        log = (build / f"{src}.log").read_text()
        regs[src] = sorted({int(w) for line in log.splitlines()
                            if "registers" in line
                            for w in [line.split("Used ")[1].split()[0]]})
    emit({"phase": "card_and_build", "nvidia_smi": card_line, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "build_dir": str(build.relative_to(ROOT)),
          "registers_per_thread": regs,
          "psi8_mma_ptxas": _ptxas_report(
              (build / "psi_matmul.log").read_text(),
              "psi_gemm_codes_kernelI"),
          "psi5_mma_ptxas": _ptxas_report(
              (build / "psi_matmul.log").read_text(),
              "psi_gemm_mma_kernelILi5E"),
          "bytes_per_s": bw, "bf16_flop_per_s": peak})

    from repro_torch.kernels import ops
    summary = phase_kernels(torch, dev, bw, peak)
    launches = {}
    phase_serve(torch, dev, launches, "psi8")
    phase_serve(torch, dev, launches, "psi5")
    phase_card_vs_cpu(torch, dev)

    # ---------------------------------------------------------- 6. summary
    kernels = []
    for k in ("psi_matmul_codes", "psi_matmul_packed", "paged_attention"):
        row = dict(summary[k])
        row["launches"] = launches[k]
        check(row["launches"] > 0, f"{k} never launched on its main path")
        kernels.append(row)
    check(set(launches) == set(ops.KERNELS), "a kernel has no main path")
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def _ptxas_report(log, key):
    """{"template arguments": "N registers, ... smem"} from ptxas -v for the
    kernels whose mangled names contain ``key``: psi_gemm_mma_kernel
    <BITS, NT, VEC> (ILi5ELi1ELb1 -> "5,1,1") and psi_gemm_codes_kernel
    <NT, VEC, XVEC> (ILi1ELb1ELb1 -> "1,1,1")."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if key in line else None
        elif fn and "Used " in line:
            args = fn.split("_kernelI", 1)[1].split("EE")[0]
            label = ",".join(c for c in args if c.isdigit())
            out[label] = line.split("Used ", 1)[1].strip()
            fn = None
    return out


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions; times and bounds.
# ---------------------------------------------------------------------------
def _median_ms(torch, fn, n_variants, iters=10, reps=5):
    for i in range(3):
        fn(i % n_variants)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i % n_variants)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def _graph_ms(torch, fn, n_variants, iters=20, reps=5):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's cost of launching them is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_variants)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_variants)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    del graph
    return statistics.median(times)


def _host_ms(torch, fn, n_variants, iters=50, reps=5):
    """Host time to issue one call: ``iters`` calls with no sync between
    them, on the host's clock.  Where it exceeds the device time per call,
    an eager loop runs at the host's pace."""
    for i in range(3):
        fn(i % n_variants)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i % n_variants)
        times.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return statistics.median(times)


def _copies(t, nbytes):
    """Enough distinct copies of ``t`` that cycling through them streams
    from HBM, not from the 50 MB L2 (a decode step finds its weights
    cold)."""
    n = max(1, math.ceil(3 * L2_BYTES / nbytes))
    return [t] + [t.clone() for _ in range(n - 1)]


def _gemm_errors(torch, ops, ref, qt, plain, Ms, dtype, gen, dev):
    """max |kernel - plain| over M in Ms, and the worst err / tol ratio."""
    worst_err, worst_ratio = 0.0, 0.0
    K = qt.shape[0]
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
        got = ops.psi_matmul_2d(x, qt).float()
        want = plain(x).float()
        err = float((got - want).abs().max())
        amax = float(want.abs().max())
        # bf16 out: both round an f32 sum (summed in another order) to bf16,
        # one bf16 ulp of the largest output; f32 out: ~1e-5 relative
        tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * max(amax,
                                                                     1.0)
        worst_err = max(worst_err, err)
        worst_ratio = max(worst_ratio, err / tol)
        check(torch.isfinite(got).all().item(), "non-finite kernel output")
    return worst_err, worst_ratio


def phase_kernels(torch, dev, bw, peak):
    from repro_torch.core import psi
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = torch.bfloat16
    out = {}
    max_err = {"psi_matmul_codes": 0.0, "psi_matmul_packed": 0.0,
               "paged_attention": 0.0}
    agg = {k: dict.fromkeys(("ms", "device_ms", "host_ms", "plain_ms",
                             "library_ms", "library_device_ms", "bytes",
                             "flops"), 0.0)
           for k in ("psi_matmul_codes", "psi_matmul_packed")}

    # -- ragged shapes, f32 (the reduced configs' dtype): reduced widths,
    # odd N (unaligned rows: byte loads, tail columns masked) up to a
    # vocabulary-sized one
    for (M, K, N) in [(1, 64, 32), (3, 64, 64), (7, 64, 128), (16, 64, 256),
                      (5, 40, 36), (5, 40, 37), (2, 64, 33),
                      (4, 512, 51865)]:
        w = torch.randn(K, N, generator=gen, device=dev)
        for bits in range(2, 9):
            qt = psi.quantize_weights(w, bits, axis=(0,))
            if bits < 8:
                qt = qt.pack()
                plain = lambda x, q=qt, b=bits: ref.psi_matmul_packed_ref(
                    x, q.data, q.scale, b)
            else:
                plain = lambda x, q=qt: ref.psi_matmul_codes_ref(
                    x, q.data, q.scale)
            err, ratio = _gemm_errors(torch, ops, ref, qt, plain, [M],
                                      torch.float32, gen, dev)
            key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
            check(ratio <= 1.0, f"{key} bits={bits} ({M},{K},{N}) f32 err "
                                f"{err} over tolerance")
    emit({"phase": "kernels_reduced_f32", "ok": True,
          "shapes": "M,K,N in (1,64,32) (3,64,64) (7,64,128) (16,64,256) "
                    "(5,40,36) (5,40,37) (2,64,33) (4,512,51865), bits 2..8",
          "tolerance": "1e-5 x max|plain| (f32 sums in another order)"})

    # -- ragged shapes, bf16 codes (kernel 1's tensor-core route takes any
    # K: K % 8 != 0 reads x element by element, a partial last 64-K group)
    worst = 0.0
    for (M, K, N) in [(5, 40, 37), (3, 37, 33), (72, 1032, 1000),
                      (16, 72, 100), (1, 100, 36), (4, 4101, 1024)]:
        w = torch.randn(K, N, generator=gen, device=dev)
        qt = psi.quantize_weights(w, 8, axis=(0,))
        err, ratio = _gemm_errors(
            torch, ops, ref, qt,
            lambda x, q=qt: ref.psi_matmul_codes_ref(x, q.data, q.scale),
            [M], bf16, gen, dev)
        check(ratio <= 1.0, f"psi_matmul_codes ({M},{K},{N}) bf16 err {err} "
                            f"over one bf16 ulp of the output")
        worst = max(worst, err)
    max_err["psi_matmul_codes"] = max(max_err["psi_matmul_codes"], worst)
    emit({"phase": "kernels_reduced_bf16_codes", "ok": True,
          "shapes": "M,K,N in (5,40,37) (3,37,33) (72,1032,1000) (16,72,100) "
                    "(1,100,36) (4,4101,1024), bits 8",
          "max_abs_err": worst,
          "tolerance": "2^-7 x max|plain| (one bf16 ulp of the output)"})

    # -- full-width shapes, bf16 activations
    for label, ((K, N), per_step) in SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
        row = {"phase": "kernel_shape", "weight": label, "K": K, "N": N,
               "launches_per_decode_step": per_step}
        for bits in (8, 2, 3, 4, 5, 6, 7):
            qt = psi.quantize_weights(w, bits, axis=(0,))
            key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
            if bits < 8:
                qt = qt.pack()
                plain = lambda x, q=qt, b=bits: ref.psi_matmul_packed_ref(
                    x, q.data, q.scale, b)
            else:
                plain = lambda x, q=qt: ref.psi_matmul_codes_ref(
                    x, q.data, q.scale)
            err, ratio = _gemm_errors(torch, ops, ref, qt, plain,
                                      [1, DECODE_M, 16, PREFILL_M], bf16,
                                      gen, dev)
            check(ratio <= 1.0, f"{key} bits={bits} {label} bf16 err {err} "
                                f"over one bf16 ulp of the output")
            max_err[key] = max(max_err[key], err)
            row[f"psi{bits}_max_abs_err"] = err
            if bits not in (8, 5):
                continue
            # times at the decode shape (M = max_batch), weights cold.
            # ms, plain_ms, library_ms: eager loops timed by CUDA events (an
            # eager call costs its host time, host_ms, where that exceeds its
            # device time); device_ms, library_device_ms: the same calls
            # replayed from a CUDA graph, i.e. device time without the host
            wbytes = qt.data.numel() * qt.data.element_size()
            datas = _copies(qt.data, wbytes)
            scale = qt.scale.reshape(-1)
            x = torch.randn(DECODE_M, K, generator=gen, device=dev).to(bf16)
            sub = psi.QuantizedTensor
            kern = lambda i, x=x: ops.psi_matmul_2d(
                x, sub(datas[i], scale, qt.fmt, qt.packed))
            t_k = _median_ms(torch, kern, len(datas))
            n_graph = max(20, len(datas))   # every copy once: cold
            t_dev = _graph_ms(torch, kern, len(datas), iters=n_graph)
            t_host = _host_ms(torch, kern, len(datas))
            if bits == 8:
                pl = lambda i: ref.psi_matmul_codes_ref(x, datas[i], scale)
            else:
                pl = lambda i: ref.psi_matmul_packed_ref(x, datas[i], scale,
                                                         bits)
            t_p = _median_ms(torch, pl, len(datas), iters=3, reps=3)
            wdq = qt.dequantize(bf16)
            libs = _copies(wdq, wdq.numel() * 2)
            lib = lambda i: torch.matmul(x, libs[i])
            t_l = _median_ms(torch, lib, len(libs))
            t_l_dev = _graph_ms(torch, lib, len(libs),
                                iters=max(20, len(libs)))
            del libs, wdq
            nbytes = (wbytes + 4 * N + 2 * DECODE_M * K + 2 * DECODE_M * N)
            flops = 2.0 * DECODE_M * K * N
            bound = max(nbytes / bw, flops / peak) * 1e3
            row[f"psi{bits}_decode"] = {
                "M": DECODE_M, "ms": t_k, "device_ms": t_dev,
                "host_ms": t_host, "plain_ms": t_p, "library_ms": t_l,
                "library_device_ms": t_l_dev, "bound_ms": bound,
                "bytes": nbytes, "roofline_share": bound / t_k,
                "device_roofline_share": bound / t_dev}
            a = agg[key]
            for f, t in (("ms", t_k), ("device_ms", t_dev),
                         ("host_ms", t_host), ("plain_ms", t_p),
                         ("library_ms", t_l), ("library_device_ms", t_l_dev),
                         ("bytes", nbytes), ("flops", flops)):
                a[f] += per_step * t
            # one prefill-shaped time (an admission's bucketed prompt)
            xp = torch.randn(PREFILL_M, K, generator=gen, device=dev).to(bf16)
            row[f"psi{bits}_prefill"] = {
                "M": PREFILL_M,
                "ms": _median_ms(torch, lambda i: kern(i, xp), len(datas),
                                 iters=3, reps=3),
                "device_ms": _graph_ms(torch, lambda i: kern(i, xp),
                                       len(datas), iters=5)}
            del datas
        emit(row)
        del w
        torch.cuda.empty_cache()

    replaces = {"psi_matmul_codes": "src/repro/kernels/psi_matmul.py:153",
                "psi_matmul_packed": "src/repro/kernels/psi_matmul.py:197"}
    for key, bits in (("psi_matmul_codes", 8), ("psi_matmul_packed", 5)):
        a = agg[key]
        bound = max(a["bytes"] / bw, a["flops"] / peak) * 1e3
        out[key] = {
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/psi_matmul.cu",
            "replaces": replaces[key], "launches": 0,
            "max_abs_err": max_err[key], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": bound,
            "bound_by": ("bytes" if a["bytes"] / bw >= a["flops"] / peak
                         else "operations"),
            "library_ms": a["library_ms"],
            "device_ms": a["device_ms"], "host_ms": a["host_ms"],
            "library_device_ms": a["library_device_ms"],
            "device_roofline_share": bound / a["device_ms"],
            "scope": f"one full-width decode step at psi{bits}: 253 "
                     f"launches at M={DECODE_M}, weights cold; ms, plain_ms "
                     f"and library_ms are eager loops (host cost included), "
                     f"device_ms and library_device_ms CUDA-graph replays",
            "bytes": a["bytes"]}

    # -- paged attention
    def case(seed, B, n_bt, hq, hkv, D, bs, qdt, pool):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        N = B * n_bt + B
        q = torch.randn(B, hq, D, generator=g, device=dev).to(qdt)
        if pool == "int8":
            kp = torch.randint(-127, 128, (N, bs, hkv, D), generator=g,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (N, bs, hkv, D), generator=g,
                               device=dev, dtype=torch.int8)
            ks = torch.rand(N, bs, hkv, 1, generator=g, device=dev) * 0.05
            vs = torch.rand(N, bs, hkv, 1, generator=g, device=dev) * 0.05
        else:
            kp = torch.randn(N, bs, hkv, D, generator=g, device=dev).to(qdt)
            vp = torch.randn(N, bs, hkv, D, generator=g, device=dev).to(qdt)
            ks = vs = None
        bt = torch.randperm(B * n_bt, generator=g, device=dev).to(
            torch.int32).reshape(B, n_bt)
        holes = torch.rand(B, n_bt, generator=g, device=dev) < 0.3
        bt = torch.where(holes, torch.full_like(bt, -1), bt)
        bt[seed % B] = -1                              # an inactive slot
        bounds = torch.tensor([0, bs - 1, bs, n_bt * bs - 1], device=dev,
                              dtype=torch.int32)
        pos = bounds[torch.arange(B, device=dev) % 4].clone()
        return q, kp, vp, bt.contiguous(), pos, ks, vs

    def visible(bt, pos, bs):
        j = torch.arange(bt.shape[1], device=bt.device) * bs
        return ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)

    for (hq, hkv, D, bs, qdt, pool) in [
            (32, 8, 128, 16, bf16, "bf16"), (32, 8, 128, 16, bf16, "int8"),
            (32, 8, 128, 16, torch.float32, "f32"),
            (32, 8, 128, 16, torch.float32, "int8"),
            (4, 2, 16, 16, bf16, "bf16"), (4, 2, 16, 16, bf16, "int8"),
            (4, 2, 16, 16, torch.float32, "f32"),
            (4, 2, 16, 16, torch.float32, "int8")]:
        worst = 0.0
        for seed in range(4):
            for B, n_bt in ((4, 6), (3, 4), (1, 2)):
                q, kp, vp, bt, pos, ks, vs = case(seed, B, n_bt, hq, hkv, D,
                                                  bs, qdt, pool)
                got = ops.paged_decode_attention(q, kp, vp, bt, pos, ks, vs)
                want = pa.paged_attention_ref(q, kp, vp, bt, pos, ks, vs)
                rows = visible(bt, pos, bs)
                check(bool((got[~rows] == 0).all()),
                      "paged_attention: rows with no visible key not zero")
                want = want[rows].float()
                d = (got[rows].float() - want).abs()
                # a per-element bound: A = sum(p |v|) / l, the plain version
                # on |V|, is the size of the terms each output sums.  bf16:
                # the two outputs each round once (one ulp, 2^-7 |want|);
                # the plain version also rounds p and dequantized V to bf16
                # (2^-9 A each), and dequantized K, which moves the scores
                # and so p (a few 2^-9 A on int8 pools): 2^-5 A.  f32: the
                # same sums in another order, 1e-5 of |want| + A.
                a = pa.paged_attention_ref(q, kp, vp.abs(), bt, pos, ks,
                                           vs)[rows].float()
                tol = (2.0 ** -7 * want.abs() + 2.0 ** -5 * a
                       if qdt == bf16 else 1e-5 * (want.abs() + a))
                bad = d > tol
                check(not bool(bad.any()),
                      f"paged_attention {hq}/{hkv}/{D} {pool}: err "
                      f"{float(d[bad].max()) if bad.any() else 0.0} over "
                      f"its per-element tolerance")
                err = float(d.max()) if d.numel() else 0.0
                worst = max(worst, err)
        max_err["paged_attention"] = max(max_err["paged_attention"], worst)
        emit({"phase": "kernel_paged_attention", "Hq": hq, "Hkv": hkv,
              "D": D, "bs": bs, "q": str(qdt), "pool": pool,
              "max_abs_err": worst, "ok": True,
              "tolerance": ("2^-7 |want| + 2^-5 A" if qdt == bf16
                            else "1e-5 (|want| + A)") +
                           ", A = plain version on |V|"})

    # -- the split path: tables the kernel splits across blocks, with pos
    # on the first split boundary, one short of it, inside the first split
    # only, an all -1 slot, visible keys only in the last split, and a full
    # slot; every (G, D) the configs use, in all four q/pool types
    def split_case(seed, n_bt, G, hkv, D, qdt, pool, bs=16):
        B = 6
        chunk, n_split = pa.split_plan(B, hkv, G, n_bt, bs,
                                       _build.sm_count(0))
        check(n_split > 1, f"split case n_bt={n_bt} G={G} did not split")
        q, kp, vp, bt, _, ks, vs = case(seed, B, n_bt, G * hkv, hkv, D, bs,
                                        qdt, pool)
        bt[:, 0] = bt[:, 0].abs()
        bt[3] = -1
        bt[4, :(n_split - 1) * chunk] = -1
        bt[4, -1] = B * n_bt + 4
        pos = torch.tensor([chunk * bs, chunk * bs - 1, bs + 3] + [
            n_bt * bs - 1] * 3, dtype=torch.int32, device=dev)
        return q, kp, vp, bt, pos, ks, vs

    def held(args, bs=16):
        """Worst |kernel - plain| on rows with a visible key, after checking
        the per-element tolerance above and exact zeros elsewhere."""
        q, kp, vp, bt, pos, ks, vs = args
        got = ops.paged_decode_attention(*args)
        want = pa.paged_attention_ref(*args)
        rows = visible(bt, pos, bs)
        check(bool((got[~rows] == 0).all()),
              "paged_attention: rows with no visible key not zero")
        want = want[rows].float()
        a = pa.paged_attention_ref(q, kp, vp.abs(), bt, pos, ks,
                                   vs)[rows].float()
        tol = (2.0 ** -7 * want.abs() + 2.0 ** -5 * a
               if q.dtype == bf16 else 1e-5 * (want.abs() + a))
        d = (got[rows].float() - want).abs()
        check(not bool((d > tol).any()), f"paged_attention split path "
              f"{tuple(q.shape)} {kp.dtype}: err {float(d.max())} over its "
              f"per-element tolerance")
        return float(d.max())

    types = [(bf16, "bf16"), (bf16, "int8"), (torch.float32, "f32"),
             (torch.float32, "int8")]
    worst = 0.0
    for n_bt in (64, 160):
        for qdt, pool in types:
            for seed in range(2):
                worst = max(worst, held(split_case(seed, n_bt, 4, 8, 128, qdt,
                                                   pool)))
    for G in (1, 2, 4, 6, 8, 16, 48):
        for D in (16, 64, 128, 256):
            for qdt, pool in types:
                worst = max(worst, held(split_case(
                    G * 1000 + D, 64, G, 1 if G == 48 else 2, D, qdt, pool)))
    max_err["paged_attention"] = max(max_err["paged_attention"], worst)
    emit({"phase": "kernel_paged_attention_split", "ok": True,
          "max_abs_err": worst,
          "cases": "n_bt 64/160 at 32/8/128 (pos on, one short of, inside "
                   "the first split; all -1 slot; last split only), and "
                   "G in 1,2,4,6,8,16,48 x D in 16,64,128,256 at n_bt 64; "
                   "q/pool bf16/bf16, bf16/int8, f32/f32, f32/int8",
          "tolerance": "as kernel_paged_attention"})

    import torch.nn.functional as F

    def attn_times(B, n_pos, pool):
        """Decode read of B slots at ``n_pos`` positions each, full width."""
        hq, hkv, D, bs = 32, 8, 128, 16
        n_bt = -(-n_pos // bs)
        N = B * n_bt + B
        g = torch.Generator(device=dev)
        g.manual_seed(n_pos)
        q = torch.randn(B, hq, D, generator=g, device=dev).to(bf16)
        if pool == "int8":
            kp = torch.randint(-127, 128, (N, bs, hkv, D), generator=g,
                               device=dev, dtype=torch.int8)
            vp = kp.clone()
            ks = torch.rand(N, bs, hkv, 1, generator=g, device=dev) * 0.05
            vs = ks.clone()
        else:
            kp = torch.randn(N, bs, hkv, D, generator=g, device=dev).to(bf16)
            vp = torch.randn(N, bs, hkv, D, generator=g, device=dev).to(bf16)
            ks = vs = None
        bt = torch.randperm(B * n_bt, generator=g, device=dev).to(
            torch.int32).reshape(B, n_bt).contiguous()
        pos = torch.full((B,), n_pos - 1, dtype=torch.int32, device=dev)
        # cold: cycle through enough copies of the pools (and of the
        # gathered K/V below) that each call streams from HBM, not L2
        pools = [kp, vp] + ([ks, vs] if ks is not None else [])
        sets = list(zip(*(_copies(t, sum(u.numel() * u.element_size()
                                         for u in pools)) for t in pools)))
        sets = [s if ks is not None else s + (None, None) for s in sets]
        attend = lambda i: ops.paged_decode_attention(
            q, sets[i][0], sets[i][1], bt, pos, sets[i][2], sets[i][3])
        # ms, plain_ms, library_ms: eager loops timed by CUDA events, as for
        # the matmul kernels; an eager call costs its host time (host_ms)
        # where that exceeds its device time.  *device_ms: the same calls
        # replayed from a CUDA graph, i.e. device time without the host.
        # warm_ms: the eager loop on one pool set, L2-resident at 4 x 80.
        plain = lambda i: pa.paged_attention_ref(
            q, sets[i][0], sets[i][1], bt, pos, sets[i][2], sets[i][3])
        t_k = _median_ms(torch, attend, len(sets), iters=50)
        t_warm = _median_ms(torch, attend, 1, iters=50)
        t_host = _host_ms(torch, attend, len(sets))
        t_dev = _graph_ms(torch, attend, len(sets))
        t_p = _median_ms(torch, plain, len(sets), iters=10)
        t_p_dev = _graph_ms(torch, plain, len(sets), iters=5)
        # yardstick: SDPA on K/V gathered (and dequantized) beforehand
        kg = pa._gather(kp, bt)
        vg = pa._gather(vp, bt)
        if ks is not None:
            kg = (kg.float() * pa._gather(ks, bt)).to(bf16)
            vg = (vg.float() * pa._gather(vs, bt)).to(bf16)
        S = kg.shape[1]
        kg = kg.transpose(1, 2).contiguous()             # (B, Hkv, S, D)
        vg = vg.transpose(1, 2).contiguous()
        mask = (torch.arange(S, device=dev)[None] <= pos[:, None])
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        kgs = _copies(kg, 2 * kg.numel() * kg.element_size())
        vgs = [vg] + [vg.clone() for _ in kgs[1:]]
        try:
            F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                           enable_gqa=True)
            lib = lambda i: F.scaled_dot_product_attention(
                q4, kgs[i], vgs[i], attn_mask=mask, enable_gqa=True)
        except TypeError:
            ke = kg.repeat_interleave(hq // hkv, dim=1)
            ve = vg.repeat_interleave(hq // hkv, dim=1)
            kgs = _copies(ke, 2 * ke.numel() * ke.element_size())
            vgs = [ve] + [ve.clone() for _ in kgs[1:]]
            lib = lambda i: F.scaled_dot_product_attention(
                q4, kgs[i], vgs[i], attn_mask=mask)
        t_l = _median_ms(torch, lib, len(kgs), iters=50)
        t_l_dev = _graph_ms(torch, lib, len(kgs))
        del sets, kgs, vgs
        chunk, n_split = pa.split_plan(B, hkv, hq // hkv, n_bt, bs,
                                       _build.sm_count(0))
        valid = int((bt >= 0).sum())
        nbytes = (pa.streamed_bytes(valid, bs, hkv, D,
                                    quantized=pool == "int8")
                  + 2 * 2 * q.numel() + 4 * (bt.numel() + B))
        flops = 4.0 * B * hq * D * n_pos
        bound = max(nbytes / bw, flops / peak) * 1e3
        return {"B": B, "positions": n_pos, "pool": pool, "ms": t_k,
                "warm_ms": t_warm, "host_ms": t_host, "device_ms": t_dev,
                "chunk": chunk, "n_split": n_split, "plain_ms": t_p,
                "plain_device_ms": t_p_dev, "library_ms": t_l,
                "library_device_ms": t_l_dev, "bound_ms": bound,
                "bytes": nbytes, "bound_by": ("bytes" if nbytes / bw >=
                                              flops / peak else "operations"),
                "roofline_share": bound / t_k,
                "device_roofline_share": bound / t_dev}

    main_shape = attn_times(4, 80, "bf16")      # the serve phase's decode
    emit({"phase": "kernel_paged_attention_time", **main_shape})
    for extra in (attn_times(4, 512, "bf16"), attn_times(4, 512, "int8"),
                  attn_times(16, 2048, "bf16"), attn_times(16, 2048, "int8")):
        emit({"phase": "kernel_paged_attention_time", **extra})
    out["paged_attention"] = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:274",
        "launches": 0, "max_abs_err": max_err["paged_attention"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "scope": "one call: 4 slots x 80 positions, bf16 pool, full "
                 "width, pools cold; ms, plain_ms and library_ms are eager "
                 "loops (host cost included), device_ms and "
                 "library_device_ms CUDA-graph replays",
        "bytes": main_shape["bytes"]}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3-4: the serving path.
# ---------------------------------------------------------------------------
def _serve_args(**kw):
    base = dict(arch="qwen3-8b", reduced=False, n_layers=0, quant="psi8",
                quant_policy=None, requests=8, max_batch=4,
                arrival_rate=100.0, max_new=16, min_new=8, prompt_len=64,
                prompt_jitter=8, block_size=0, cache_blocks=None, eos_id=-1,
                seed=0, device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def phase_serve(torch, dev, launches, quant):
    """Server.serve of full-width qwen3-8b (all 36 layers) from ``quant``
    codes, continuous then static: identical tokens, 253 PSI-matmul
    launches per forward (kernel 1 at psi8, kernel 2 at psi5) and 36
    attention launches per decode step, each decode step a replay of the
    captured horizon-1 graph; then a profiled decode window three ways
    (eager step, horizon-1 graph, horizon-8 round) and, at psi8, the same
    trace served at horizon 8 (phase serve_psi8_horizon)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = (_serve_args() if quant == "psi8" else
            _serve_args(quant=quant, requests=4, max_new=8, min_new=4))
    key = "psi_matmul_codes" if quant == "psi8" else "psi_matmul_packed"
    t0 = time.perf_counter()
    server, cfg = serve.build_server(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(cfg.n_layers == 36 and cfg.d_model == 4096, "not full width")
    server.warmup(serve.trace_from_args(args, cfg))
    ops.reset_launch_counts()                         # the main path starts
    runs = {}
    for mode in ("continuous", "static"):
        done, stats = server.serve(serve.trace_from_args(args, cfg),
                                   continuous=(mode == "continuous"),
                                   warmup=False)
        runs[mode] = ({r.rid: r.tokens for r in done}, stats, done)
    torch.cuda.synchronize()
    got = ops.launch_counts()                         # ... and ends here
    (tc, sc, done_c), (ts, ss, _) = runs["continuous"], runs["static"]
    check(tc == ts, f"{quant}: continuous and static modes emitted "
                    f"different tokens")
    check(all(len(r.tokens) == r.max_new for r in done_c),
          f"{quant}: a request did not get its max_new tokens")
    check(all(0 <= t < cfg.vocab_size for toks in tc.values() for t in toks),
          "token id out of the vocabulary")
    check(sc["decode_compiles"] == ss["decode_compiles"] == 1,
          f"{quant}: want one captured decode graph, got "
          f"{sc['decode_compiles']} / {ss['decode_compiles']}")
    steps = sc["decode_steps"] + ss["decode_steps"]
    fwd = sc["prefill_forwards"] + ss["prefill_forwards"]
    want = {"psi_matmul_codes": 0, "psi_matmul_packed": 0,
            "paged_attention": 36 * steps}
    want[key] = 253 * (steps + fwd)
    check(got == want, f"{quant} launch counts {got} != expected {want} "
                       f"(253 per forward, 36 attention per decode step)")
    ex = server.executor
    r0 = done_c[0]
    with torch.inference_mode():
        logits, _ = ex.model.forward(
            ex.params, torch.as_tensor(r0.prompt[None], device=dev))
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, len(r0.prompt), cfg.vocab_size), "prefill logits not finite")
    launches[key] = launches.get(key, 0) + got[key]
    launches["paged_attention"] = (launches.get("paged_attention", 0)
                                   + got["paged_attention"])
    # the same params behind a horizon-8 server: its warmup captures the
    # one 8-step round graph
    server8 = serve.Server(cfg, ex.params, max_batch=args.max_batch,
                           max_seq=server.max_seq, eos_id=args.eos_id,
                           device=dev, decode_horizon=HORIZON)
    server8.warmup(serve.trace_from_args(args, cfg))
    window = _decode_window(torch, server, server8)
    keep = ("tok_per_s", "wall_s", "tokens", "p50_latency_s",
            "p99_latency_s", "p50_ttft_s", "p99_ttft_s", "p50_itl_s",
            "p99_itl_s", "decode_steps", "prefill_forwards",
            "peak_concurrency", "cache_bytes", "block_util_pct",
            "host_syncs", "host_syncs_per_token", "decode_compiles")
    emit({"phase": f"serve_{quant}_full_width", "layers": cfg.n_layers,
          "requests": args.requests, "max_batch": args.max_batch,
          "prompt_len": f"{args.prompt_len}+-{args.prompt_jitter}",
          "max_new": args.max_new, "init_quantize_s": round(init_s, 3),
          "param_bytes": _param_bytes(ex.params),
          "continuous": {k: sc[k] for k in keep},
          "static": {k: ss[k] for k in keep},
          "tokens_identical": True, "launches": got,
          "decode_window": window,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if quant == "psi8":
        phase_serve_horizon(torch, server8, args, cfg, tc, launches, keep)
    del server, server8, ex, logits
    torch.cuda.empty_cache()


def phase_serve_horizon(torch, server, args, cfg, want_tokens, launches,
                        keep):
    """The psi8 trace of phase_serve served at horizon 8 (continuous, then
    static) on a server whose warmup captured its round graph: tokens
    identical to horizon 1, 253 matmul launches per forward and 36
    attention launches per decode step under replay (decode_steps = 8 x
    rounds), one captured decode graph."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()                         # the main path starts
    runs = {}
    for mode in ("continuous", "static"):
        done, stats = server.serve(serve.trace_from_args(args, cfg),
                                   continuous=(mode == "continuous"),
                                   warmup=False)
        runs[mode] = ({r.rid: r.tokens for r in done}, stats)
    torch.cuda.synchronize()
    got = ops.launch_counts()                         # ... and ends here
    (tc, sc), (ts, ss) = runs["continuous"], runs["static"]
    check(tc == want_tokens and ts == want_tokens,
          f"horizon {HORIZON}: tokens differ from horizon 1")
    steps = sc["decode_steps"] + ss["decode_steps"]
    rounds = sc["decode_rounds"] + ss["decode_rounds"]
    fwd = sc["prefill_forwards"] + ss["prefill_forwards"]
    check(steps == HORIZON * rounds, "decode steps != horizon x rounds")
    want = {"psi_matmul_codes": 253 * (steps + fwd), "psi_matmul_packed": 0,
            "paged_attention": 36 * steps}
    check(got == want, f"horizon {HORIZON} launch counts {got} != expected "
                       f"{want} (253 per forward, 36 attention per step)")
    check(sc["decode_compiles"] == ss["decode_compiles"] == 1
          and server.executor.graph_counts() == {"decode": 0,
                                                 "decode_multi": 1},
          f"horizon {HORIZON}: want exactly one captured round graph, got "
          f"{server.executor.graph_counts()}")
    for k in got:
        launches[k] = launches.get(k, 0) + got[k]
    emit({"phase": "serve_psi8_horizon", "decode_horizon": HORIZON,
          "layers": cfg.n_layers, "requests": args.requests,
          "continuous": {k: sc[k] for k in keep + ("decode_rounds",
                                                   "loop_iters")},
          "static": {k: ss[k] for k in keep + ("decode_rounds",
                                               "loop_iters")},
          "tokens_identical_to_horizon_1": True, "launches": got})


def _decode_window(torch, server, multi=None, steps=5):
    """Where a steady decode step's time goes, three ways: the model's
    decode_step called eagerly, the horizon-1 graph (Executor.decode) and,
    with ``multi``, its horizon-M round graph (Executor.decode_multi), per
    step (a round's time over M).  Wall time per step on the host clock
    (synchronized at the end of the window), against device time by kernel
    from a torch.profiler trace of the same window (all slots active at 72
    positions, full table; a round rebuilt from host arrays each time).
    Device numbers are "not measured" when the profiler records no device
    time."""
    import numpy as np
    ex = server.executor
    B = server.max_batch
    dev = ex.device
    table = np.arange(B * ex.n_bt, dtype=np.int32).reshape(B, ex.n_bt)
    tok = np.arange(B, dtype=np.int32)[:, None]
    pos = np.full((B, 1), 72, np.int32)
    act = np.ones((B,), bool)
    cache = ex.init_cache()
    batch = {"token": torch.from_numpy(tok).to(dev),
             "pos": torch.from_numpy(pos).to(dev),
             "active": torch.from_numpy(act).to(dev),
             "block_table": torch.from_numpy(table).to(dev)}

    def eager():
        with torch.inference_mode():
            ex.model.decode_step(ex.params, batch, cache)

    modes = {"eager": (eager, 1),
             "graph": (lambda: ex.decode(tok, pos, act, cache, table), 1)}
    if multi is not None:
        mex = multi.executor
        mcache = mex.init_cache()
        rem = np.full((B,), 1 << 20, np.int32)
        modes[f"horizon_{mex.decode_horizon}"] = (
            lambda: mex.decode_multi(tok, pos, act, rem, mcache, table),
            mex.decode_horizon)
    return {name: _window(torch, fn, per_call, steps)
            for name, (fn, per_call) in modes.items()}


def _window(torch, fn, per_call, calls):
    """Wall and device time per step of ``calls`` calls of ``fn``, each
    ``per_call`` decode steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    run(3)
    n_steps = calls * per_call
    t0 = time.perf_counter()
    run(calls)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(calls)
    # each kernel once, from its own device event: a CPU op's row repeats
    # the time of the kernels it launched as its self device time, so
    # summing every row would count each eager aten kernel twice
    by = {"psi_gemm": 0.0, "paged_attn": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) or 0.0
        key = next((k for k in ("psi_gemm", "paged_attn") if k in ev.key),
                   "other")
        by[key] += us / 1e3 / n_steps
    dev_ms = sum(by.values())
    if dev_ms <= 0:
        return {"wall_ms_per_step": wall_ms,
                "device_ms_per_step": "not measured"}
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
            "psi_gemm_ms_per_step": by["psi_gemm"],
            "psi_gemm_share": by["psi_gemm"] / dev_ms,
            "paged_attn_ms_per_step": by["paged_attn"],
            "device_ms_by_kernel": by,
            "device_idle_share": max(0.0, 1.0 - dev_ms / wall_ms)}


def _param_bytes(params):
    from repro_torch.core.quantizer import quantized_bytes
    return quantized_bytes(params)


# ---------------------------------------------------------------------------
# Phase 5: the card against the CPU.
# ---------------------------------------------------------------------------
def phase_card_vs_cpu(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.executor import params_to
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = get_config("qwen3-8b", n_layers=2, dtype="float32",
                     quant_mode="psi8")
    model = build_model(cfg)
    params = model.init(seed=1, device=dev, bits=8)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(5))
    bt = torch.arange(4, dtype=torch.int32)[None]

    def run(device, p, feed=None):
        with torch.inference_mode():
            logits, seq = model.prefill(p, prompt.to(device))
            cache = model.init_cache(1, 64, device=device, n_blocks=4)
            model.insert_cache(cache, seq, 0, bt[0].long().to(device))
            outs, toks = [logits.float().cpu()], []
            tok = int(logits.argmax(-1)[0])
            for i in range(8):
                tok = tok if feed is None else feed[i]
                toks.append(tok)
                batch = {"token": torch.tensor([[tok]], device=device),
                         "pos": torch.tensor([[16 + i]], dtype=torch.int32,
                                             device=device),
                         "active": torch.tensor([True], device=device),
                         "block_table": bt.to(device)}
                logits, cache = model.decode_step(p, batch, cache)
                outs.append(logits.float().cpu())
                tok = int(logits.argmax(-1)[0])
        return outs, toks

    card, toks = run(dev, params)
    cpu, _ = run(torch.device("cpu"), params_to(params, "cpu"), feed=toks)
    err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    amax = max(float(b.abs().max()) for b in cpu)
    agree = sum(int(a.argmax() == b.argmax()) for a, b in zip(card, cpu))
    # f32 on both sides, sums over K <= 12288 in other orders (and other
    # exp/rsqrt libraries): ~1e-6 relative per product; 1e-3 absolute on
    # O(1)-O(10) logits leaves two decades of room
    tol = 1e-3 * max(1.0, amax / 10.0)
    check(err <= tol, f"card vs CPU logits differ by {err} > {tol}")
    emit({"phase": "card_vs_cpu", "layers": cfg.n_layers, "dtype": "float32",
          "steps": "prefill(16) + 8 decode", "max_abs_err": err,
          "max_abs_logit": amax, "tolerance": tol,
          "argmax_agree": f"{agree}/{len(card)}", "ok": True})


if __name__ == "__main__":
    sys.exit(main())
