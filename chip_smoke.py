#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, serves
full-width qwen3-8b (on the paged pool and on the dense slab),
phi3-medium-14b, granite-34b, chatglm3-6b, qwen3-moe-30b-a3b, qwen2-vl-2b,
recurrentgemma-9b, falcon-mamba-7b and whisper-base from PSI codes through
them, and compares the card with the CPU; then trains qwen3-8b at full
width on 4 layers and serves the result, trains it through the sharded
step on a one-card mesh, and runs the paper's networks (AlexNet,
LeNet-5).  Phases, each
printing one JSON line; any failure exits non-zero before the result line:

  1. card and build    — nvidia-smi name and power limit, kernel build time;
  2. kernels           — each kernel against its plain version at the
                         serving shapes (and ragged reduced ones, f32 and,
                         for kernel 1, bf16 with any K; for paged
                         attention also tables long enough to split, every
                         (G, D) of the configs), with its eager median time
                         (ms), its device time from CUDA-graph replays
                         (device_ms), its host time per call (host_ms), the
                         plain version's, one library call's (yardstick
                         only) and the memory bound; kernels 1 and 2 also
                         at the five weight shapes of each other dense
                         config (kernel_shape_arch, kernel_step_arch;
                         falcon-mamba's x_proj / dt_proj_w also on the
                         f32 route its prefill takes, M 1-288, batch
                         invariant; whisper's 512-wide matrices at its
                         encoder's and cross K/V's B x 1500 rows, and its
                         odd 512 x 51865 head) and kernel 3 at their head
                         layouts (4 x 80, 4 x 512, 16 x 2048), qwen3-moe's
                         32/4 and qwen2-vl's 12/2 (G = 6) included
                         (recurrentgemma, falcon-mamba and whisper decode
                         on the dense slab: no kernel 3); kernels 1-2
                         also at one rank's weights of falcon-mamba,
                         qwen3-moe and mixtral on a model axis of 4 (TP /
                         EP over four cards: kernel_shape_local), and of
                         recurrentgemma-9b and granite-34b there at M = 4
                         (their cut MQA K/V projections, the RG-LRU's
                         channels), and kernel 3 at their local heads
                         8/1, 12/2 and 12/1; kernels 1 and 2's f32 output
                         route (a row-parallel shard's partial sums) at
                         every served config's weight shapes at M 4 and
                         288 against the plain version, its cast to bf16
                         equal to the bf16 route's output bit for bit,
                         both routes' device times at M = 4 (f32_out);
  2b. split-ring merge (ring_merge) — the decode read of a dense KV ring
                         split over a model axis of 4, on one card as 4
                         chunks of one slab (B 4, C 2048; granite-34b's
                         48/1 heads of 128, recurrentgemma-9b's 16/1 of
                         256 under its 2048 window): each chunk's partial
                         softmax and the merge, against plain sdpa over
                         the whole slab, and both timed;
  3. serve psi8        — Server.serve of qwen3-8b, all 36 layers, in
                         continuous and static modes: identical tokens, and
                         253 PSI-matmul (kernel 1) + 36 attention launches
                         per decode step and 253 per prefill forward (one
                         forward per admission event: a burst of admissions
                         is one forward), each step a replay of the
                         captured decode graph; a profiled decode window
                         three ways: the eager step, the horizon-1 graph
                         and a horizon-8 round graph over 8; a burst
                         prefill of four 64-80-token prompts against the
                         same four alone (rows bit-identical, both timed);
  3b. serve psi8 at horizon 8 (serve_psi8_horizon) — the same trace in
                         rounds of 8 steps: tokens identical to horizon 1,
                         the same launch counts per step under replay, one
                         captured round graph;
  3d. dense layout (serve_psi8_dense) — the same trace and params on
                         --cache-layout dense (a 112-position slab a slot,
                         plain reads), continuous and static at horizon 1
                         and continuous at horizon 8: tokens identical
                         across the three and to 3's or diverging only
                         under the token rule of 3c; 253 PSI launches a
                         forward and step, no paged-attention launch; one
                         decode graph and one round graph; a decode window
                         and the plain read alone at the step's shape;
  3e. mesh serving (serve_psi8_mesh) — the same trace and params through
                         a Server on a (1, 1) DeviceMesh of a world-1 NCCL
                         process group: tokens identical to 3's, one slot
                         shard, the token all-gathers it issued (> 0),
                         exact launch counts (added to the kernels line);
                         its macs_per_token, mfu and tokens_per_joule at
                         the card's power limit and the roofline terms of
                         qwen3-8b's decode_32k cell on one H100; then
                         10 alternating pairs of plain and mesh serves
                         (tok/s of each, tokens identical).  Every
                         serve phase's line carries macs_per_token, mfu,
                         watts and tokens_per_joule;
  3c. context serving (serve_psi8_ctx) — the psi8 model, all 36 layers,
                         serving (a) a shared-prefix trace with the prefix
                         cache off and (b) on, (c) a bursty heavy-tail
                         trace under FIFO and (d) the same trace under
                         --slo with --prefill-chunk 128 at horizon 4 on a
                         pool tight enough to preempt: tokens of (b) equal
                         (a)'s and (d) equal (c)'s, or a divergence only
                         where the baseline's top-2 margin is a near tie;
                         reuse and chunk counts worked out from the runs'
                         fills; exact launch counts; no block leaks;
  4. serve psi5        — the same as 3 at psi5, all 36 layers, fewer
                         requests: the packed path (kernel 2), 253 launches
                         per step;
  4b. speculative (serve_psi5_spec) — psi5 with --qat-precondition 3, all
                         36 layers, served plain and with --speculative 3:4
                         (a psi3 draft of kernel 2 at M = 4, a verify of
                         kernels 2 and 3 at B*k rows), continuous and
                         static: spec tokens equal plain's or diverge only
                         at a near tie; one draft and one verify graph, no
                         plain decode graph; exact launch counts (k draft
                         steps and one verify a round); no leaked block;
                         acceptance above 0; a profiled window of one draft
                         graph, one verify graph and one plain psi5 step;
  4c. other configs (serve_phi3_psi8, serve_granite_psi5,
                         serve_chatglm3_psi8) — each at full width and
                         depth, the psi8 trace of 3 (granite at psi5):
                         identical tokens across modes, exact launch counts
                         (281 / 529 / 197 matmuls per forward, 40 / 88 / 28
                         attention calls per step), one decode graph, no
                         leaked block, a decode window (eager, graph) and
                         one 288-row prefill forward;
  4d. MoE (serve_qwen3moe_psi8, serve_qwen3moe_psi8_horizon) — full-width
                         qwen3-moe-30b-a3b, all 48 layers, psi8: 8
                         requests arriving at once (the same two bursts of
                         four in every run), continuous and static at
                         horizon 1 and continuous at horizon 8, tokens
                         identical across the three; 193 matmuls per
                         forward (none from the experts), 48 attention
                         calls per step; one decode and one round graph;
                         no leaked block; tokens dropped in the prefills
                         (slots kept < k x S summed over the forwards); a
                         decode window (eager, graph), one 288-row
                         prefill forward (C = 23) and one decode step's
                         MoE time split into expert dequantize and expert
                         GEMMs;
  4e. VLM and hybrid (serve_qwen2vl_psi8, serve_recurrentgemma_psi8 and
                         their _horizon phases) — full width and depth,
                         the psi8 trace: qwen2-vl on the paged pool (197
                         matmuls a forward, 28 attention calls a step),
                         recurrentgemma on the dense 2048-ring (293
                         matmuls, no kernel 3; exact-length prefills:
                         one forward a request where an admission's
                         prompt lengths differ); continuous and static at
                         horizon 1 and continuous at horizon 8, tokens
                         identical; one decode and one round graph; a
                         decode window (eager, graph), one 288-row
                         prefill; the tied head's time built once against
                         a transpose per call; for the hybrid the rec
                         blocks' non-PSI time at decode and prefill (the
                         scan's share) split out (rec_layer_split);
  4f. SSM and encoder-decoder (serve_falconmamba_psi8, serve_whisper_psi8
                         and their _horizon phases) — full width and
                         depth (64 mamba layers; 6 + 6 layers over 1500
                         stub frames), dense, the psi8 trace at horizons 1
                         and 8, tokens identical; 257 matmuls a forward
                         and step for falcon-mamba, 61 a step and 97 a
                         prefill forward for whisper (its encoder), no
                         kernel 3; exact-length prefills; one decode and
                         one round graph; a decode window (eager, graph),
                         one 288-row prefill; the mamba blocks' non-PSI
                         time at decode, the prefill's scan and its peak
                         memory (mamba_layer_split); whisper's cross K/V
                         projection a step and its encoder's share of a
                         prefill (xattn_split), its tied head;
  5. card vs CPU       — prefill + 8 greedy decode steps of a 2-layer
                         float32 psi8 model on the card and on the CPU, on
                         the card a suffix prefill (the prompt split at a
                         block boundary) against the full prefill, and a
                         speculative serve (--speculative 3:4, QAT
                         precondition 3) on the card and on the CPU, a
                         2-layer float32 serve of each other config
                         (qwen3-moe with 32 of its 128 experts, plus a
                         --speculative 3:3 serve whose verifies drop
                         tokens), and a 2-layer float32 qwen3-8b serve and
                         a reduced mixtral-8x22b serve on a 16-position SWA
                         ring (dense; wrapping rings, a burst that
                         prefills one by one), a 2-layer qwen2-vl serve,
                         a 3-layer (one group) recurrentgemma serve, a
                         2-layer qwen2-vl prefill with 8 spliced patches
                         and distinct M-RoPE streams (logits), the
                         reduced 5-layer hybrid on its 32-ring, a 2-layer
                         falcon-mamba serve, a whisper serve of 2 + 2
                         layers over 1500 frames and the reduced SSM on
                         prompts of 1 and 2 tokens, tokens identical on
                         the card and the CPU;
  5b. training (train_qwen3_8b) — qwen3-8b at full width, its depth cut to
                         4 layers (all 36 layers' params, gradients and
                         Adam moments would not fit), qat8: 8 steps of
                         launch.train.train (AdamW, cosine schedule, batch
                         8 x 128 from TokenStream), each step's loss,
                         device and wall ms and peak memory, the loss
                         falling; 2 more with --compress-grads; a step
                         split into forward, backward, AdamW and
                         compression; then the trained weights at psi8:
                         their logits against the QAT forward's, and 8
                         tokens for 4 prompts served on the paged pool
                         through kernels 1 and 3 (exact launch counts,
                         added to the kernels line);
  5b'. sharded training (train_mesh) — the same 4-layer qat8 cell through
                         the sharded step (params, m and v on the training
                         specs, gathered on use, gradients reduce-scattered)
                         on a (1, 1) mesh of a world-1 NCCL group against
                         the plain step, 2 steps each from the same params
                         and batches: losses and every leaf bit-equal;
                         each step's device ms and the peak memory of
                         each; a one-rank all-gather / reduce-scatter's
                         GB/s against a clone; the dry run's resident bytes
                         of the cell against its tensors'; pipeline_apply
                         on one stage against the layer loop; the dry run
                         of qwen3-8b's shapes on the (16, 16) mesh; then
                         full-width qwen3-moe-30b-a3b on 2 layers, qat8,
                         the same pair (its aux loss inside), bit-equal;
  5c. resume (train_resume) — reduced qwen3-8b: 6 steps against 3, a
                         checkpoint and 3 more in a fresh trainer (bit for
                         bit under deterministic algorithms), and against
                         the CPU;
  5d. CNNs (cnn)       — AlexNet at batch 4: forwards at fp32, psi8 and
                         psi5 against the CPU, their ms, 3 qat5 SGD steps;
                         LeNet-5 with examples/train_lenet_qat.py's recipe
                         at fp32 and qat8, test accuracy card vs CPU;
  6. summary           — {"kernels": [...]}, the card line, then the result
                         {"ok": true, "device": {...}} as the last line.

It exits non-zero, printing no result, without a CUDA device or when the
repository's ``src/repro_torch`` is not beside it.
"""
import argparse
import dataclasses
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

# the first main path's model; the other dense configs each serve in a
# phase of their own (serve_<ARCHS label>), at the width their quant names
MAIN_ARCH = "qwen3-8b"
ARCHS = {"phi3-medium-14b": ("phi3", "psi8"),
         "granite-34b": ("granite", "psi5"),
         "chatglm3-6b": ("chatglm3", "psi8"),
         "qwen3-moe-30b-a3b": ("qwen3moe", "psi8"),
         "qwen2-vl-2b": ("qwen2vl", "psi8"),
         "recurrentgemma-9b": ("recurrentgemma", "psi8"),
         "falcon-mamba-7b": ("falconmamba", "psi8"),
         "whisper-base": ("whisper", "psi8")}
# configs whose phase also serves the trace at horizon 8 (continuous)
HORIZON_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-vl-2b", "recurrentgemma-9b",
                 "falcon-mamba-7b", "whisper-base")
# whisper's card-vs-CPU serve also cuts its encoder (its 1500 frames kept)
CARD_VS_CPU_ENC_LAYERS = 2
# the card-vs-CPU serve's depth by config (2 layers; the hybrid one
# (rec, rec, attn) group)
CARD_VS_CPU_LAYERS = {"recurrentgemma-9b": 3}
# the card-vs-CPU serve of an MoE config cuts its experts (the CPU's plain
# path dequantizes every expert block each forward): qwen3-moe keeps its
# widths and top-8 over 32 experts, so a 3-token verify still has C = 1
MOE_CARD_VS_CPU_EXPERTS = 32
MOE_SPEC_K = 3                   # the MoE card-vs-CPU serve's --speculative
# the rows kernels 1 and 2 are held at for those configs' weights: decode,
# the 16-row prefill of the card-vs-CPU serve, the serve's bucketed
# prompts (64 +- 8 -> 64, 80) and the prefill window's 288 (a burst's
# B x 64-80 rows are held where a serve runs them: _check_prefill_rows)
ARCH_MS = (1, 4, 16, 64, 80, 288)
ARCH_PREFILL_ROWS = 288
DECODE_M = 4                     # decode rows = max_batch of the serve phase
# the kernel phase also holds kernels 1-3 at one rank's share of these
# configs on a model axis of TP_LOCAL_M (expert / tensor parallelism on
# four cards), kernels 1 and 2 at TP_LOCAL_MS bf16 rows
TP_LOCAL_M = 4
TP_LOCAL_ARCHS = ("falcon-mamba-7b", "qwen3-moe-30b-a3b", "mixtral-8x22b")
TP_LOCAL_MS = (1, 4, 16, 64, 288)
# the configs whose KV heads do not split over the model axis (a cut MQA
# K/V projection, the dense ring split by position) and the hybrid's
# channels: one rank's weights at the decode rows only
TP_RING_ARCHS = ("recurrentgemma-9b", "granite-34b")
RING_B, RING_C = 4, 2048         # the split-ring merge's slots and ring
HORIZON = 8                      # decode steps per round, serve_psi8_horizon
MESH_PAIRS = 10                  # serve_psi8_mesh's plain / mesh serve pairs
# serve_psi8_ctx: the bursty trace's seed (its first burst holds two long
# requests), its pool (two long requests' optimistic reservations, 2 x 29
# blocks: the second long request is preempted when the first outgrows
# its reservation), the chunk and the horizon of run (d)
CTX_SEED = 3
CTX_CACHE_BLOCKS = 58
CTX_CHUNK = 128
CTX_HORIZON = 4
# serve_psi5_spec: the draft width and the draft length k of a round
SPEC_BITS = 3
SPEC_K = 4
# the token rule: a divergence between two context runs is accepted only
# where the baseline's top-2 logit margin is below this many times the
# largest logit difference of the two runs' replays before it
MARGIN_FACTOR = 4.0
PREFILL_M = 64                   # one admission's bucketed prompt
# the rows kernels 1 and 2 are checked at for the served widths (psi8,
# psi5): the decode rows and every multiple of the prefill bucket (16) up
# to CTX_LONG_SEQ, the longest sequence of serve_psi8_ctx (448-token
# prompts, 24 new tokens, 8 of slack and one bucket for a restore, as
# build_server sizes it).  Each serve phase checks that its prefill
# forwards ran at these rows only.
CTX_LONG_SEQ = 448 + 24 + 8 + 16
PREFILL_MS = tuple(range(16, CTX_LONG_SEQ + 1, 16))
L2_BYTES = 50e6                  # H100 L2: rotate weight copies past it
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# train_qwen3_8b: qwen3-8b at full width, its depth cut to TRAIN_LAYERS
# (all 36 layers' f32 params, gradients and two Adam moments, 16 B a
# parameter, are 131 GB: more than the card's 80), qat8, batch x seq from
# TokenStream, the optimizer train() sets; then psi8 generation
TRAIN_LAYERS = 4
TRAIN_STEPS = 8
TRAIN_COMPRESS_STEPS = 2
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# train_mesh: the sharded step on a (1, 1) mesh against the plain step,
# this many steps each from the same params and batches; then the MoE
# step at full width, its depth cut to MOE_TRAIN_LAYERS (all 48 layers'
# f32 params, gradients and Adam moments, 16 B a parameter, would not fit)
MESH_TRAIN_STEPS = 2
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "qwen3-moe-30b-a3b", 2
# pipeline_apply on a one-stage mesh: layers, microbatches, rows, width
PIPE_L, PIPE_M, PIPE_MB, PIPE_D = 8, 6, 64, 1024
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 4, 64, 8
# the psi8 forward against the QAT forward of the same trained weights:
# psi8 also quantizes the embedding table (per row; ~0.8 % rms noise on
# every input embedding), which QAT keeps in float, and the QAT products
# round the grid weights to bf16; on the CPU at a quarter of the width the
# logits differed by 2.3 % rms and 2.5 % at the max (rms and max of the
# difference over those of the QAT logits)
QAT_PSI8_RMS, QAT_PSI8_MAX = 0.05, 0.10
# a served first token equals the single-prompt psi8 forward's argmax, or
# that forward's top-2 margin is below this fraction of its max |logit|
# (bf16 logits of a 151936-wide head tie within a few ulps)
GEN_TIE = 1e-2
# train_resume: reduced qwen3-8b qat8, card against CPU (f32, no TF32):
# Adam's m / sqrt(v) turns a rounding-size gradient difference into an
# update of size lr
RESUME_RTOL = 1e-3
# cnn: card against CPU forwards (f32 convolutions without TF32, cuDNN
# against oneDNN: other summation orders), as a fraction of max |logit|;
# LeNet-5's test accuracy on the card within LENET_PP points of the CPU's
CNN_REL = 1e-4
LENET_PP = 2.0
ALEXNET_BATCH = 4                # the paper's Fig. 8 batch
ALEXNET_LR = 1e-3                # 3 qat5 SGD steps (momentum 0.9)
LENET_STEPS, LENET_BATCH, LENET_LR = 300, 128, 0.05


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    emit({"ok": False, "error": msg})
    raise SystemExit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def counts_per_step(cfg):
    """(PSI-matmul launches per decode step, attention calls per decode
    step): wq, wk, wv, wo (a rec layer's w_in_gate, w_in_rec, rglru_wa,
    rglru_wx, w_out; a mamba layer's in_proj, x_proj, dt_proj_w,
    out_proj and no MLP; an xattn layer's four and its cross attention's
    four) and the MLP's matrices (3 gated, 2 for the GELU MLP, none for
    MoE: its experts are dequantized blocks in a plain batched product)
    per layer plus the lm-head; one paged attention read per attention
    layer (none on the dense slab: its read is plain).  A prefill forward
    launches :func:`encoder_launches` more."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    mlp = 0 if cfg.family == "moe" else (2 if cfg.act == "gelu" else 3)
    own = {"rec": 5 + mlp, "mamba": 4, "xattn": 8 + mlp}
    per_fwd = sum(own.get(k, 4 + mlp) for k in kinds) + 1
    paged = cfg.resolved_cache_layout == "paged"
    return per_fwd, kinds.count("attn") if paged else 0


def encoder_launches(cfg):
    """PSI-matmul launches of whisper's encoder, which runs in a prefill
    forward only: wq, wk, wv, wo, w_up and w_down a layer (0 for every
    other family)."""
    return 6 * cfg.n_enc_layers if cfg.family == "encdec" else 0


def matmul_launches(cfg, steps, forwards):
    """The PSI-matmul launches of ``steps`` decode steps and ``forwards``
    prefill forwards."""
    per_step = counts_per_step(cfg)[0]
    return per_step * (steps + forwards) + encoder_launches(cfg) * forwards


def weight_shapes(cfg, m=1):
    """{label: ((K, N), launches per decode step)} of a config's PSI
    matmuls (wq and wo apart where n_heads x head_dim != d_model; no MLP
    for MoE or the SSM; the rec layers' five, the mamba layers' four,
    whisper's cross attention's four; labels of one shape merged), or of
    one rank's share on a model axis of ``m`` (its heads, FFN, RG-LRU and
    SSM channels; a K/V projection whose heads do not split cut by
    column, the dense gate projections' K whole, the lm-head's V/m
    vocab-parallel columns; an MoE's experts are dequantized blocks, no
    PSI matmul)."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, len(kinds)
    La = kinds.count("attn") + 2 * kinds.count("xattn")
    Lr, dr = kinds.count("rec"), cfg.resolved_d_rnn
    Lm, di = kinds.count("mamba"), cfg.d_inner
    q = cfg.n_heads * hd // m
    kv = cfg.n_kv_heads * hd
    kv = kv // m if kv % m == 0 else kv
    ff = cfg.d_ff // m
    rows = []
    if La:
        rows = ([("wq/wo", (d, d), 2 * La)] if q == d
                else [("wq", (d, q), La), ("wo", (q, d), La)])
        rows.append(("wk/wv", (d, kv), 2 * La))
    if Lr:
        rows += [("w_in_gate/w_in_rec", (d, dr // m), 2 * Lr),
                 ("rglru_wa/rglru_wx", (dr, dr // m), 2 * Lr),
                 ("w_out", (dr // m, d), Lr)]
    if Lm:
        r, N, dl = cfg.resolved_dt_rank, cfg.ssm_state, di // m
        rows += [("in_proj", (d, 2 * dl), Lm),
                 ("x_proj", (dl, r + 2 * N), Lm),
                 ("dt_proj_w", (r, dl), Lm),
                 ("out_proj", (dl, d), Lm)]
    if cfg.family in ("moe", "ssm"):
        pass
    elif cfg.act == "gelu":
        rows += [("w_up", (d, ff), L), ("w_down", (ff, d), L)]
    else:
        rows += [("w_gate/w_up", (d, ff), 2 * L),
                 ("w_down", (ff, d), L)]
    rows.append(("lm_head", (d, cfg.vocab_size // m), 1))
    out = {}
    for label, kn, n in rows:
        old = next((k for k, (s, _) in out.items() if s == kn), None)
        if old is None:
            out[label] = (kn, n)
        else:
            out[f"{old}+{label}"] = (kn, out.pop(old)[1] + n)
    return out


def check_full(cfg, arch):
    """The served config is ``arch``'s published one: every width and the
    whole depth."""
    from repro_torch.configs import get_config
    want = get_config(arch)
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "act", "rope", "n_experts", "top_k",
            "capacity_factor", "block_pattern", "d_rnn", "rglru_c",
            "window", "vision_patches", "tie_embeddings", "norm",
            "ssm_state", "ssm_expand", "ssm_conv", "ssm_dt_rank",
            "n_enc_layers", "enc_frames")
    check(all(getattr(cfg, k) == getattr(want, k) for k in keys),
          f"{arch}: not full width and depth")


def card_rates(name):
    """(bytes/s, bf16 dense FLOP/s) of the H100 SXM: the port's roofline
    constants (``perf.roofline_model``, from NVIDIA's data sheet); any
    other card fails rather than get a bound from guessed rates."""
    check("H100" in name and "HBM3" in name,
          f"no memory and compute rates known for {name!r} (H100 SXM only)")
    from repro_torch.perf.roofline_model import HBM_BW, PEAK_FLOPS
    return HBM_BW, PEAK_FLOPS


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
    seconds = {"build": round(build_s, 3)}

    def timed(name, fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 3)
        return got

    summary = timed("kernels", phase_kernels, torch, dev, bw, peak)
    timed("ring_merge", phase_ring_merge, torch, dev, bw)
    launches = {}
    timed("serve_psi8", phase_serve, torch, dev, launches, "psi8")
    timed("serve_psi8_ctx", phase_serve_ctx, torch, dev, launches)
    timed("serve_psi5", phase_serve, torch, dev, launches, "psi5")
    timed("serve_psi5_spec", phase_serve_spec, torch, dev, launches)
    for arch, (_, quant) in ARCHS.items():
        timed(f"serve_{arch}", phase_serve, torch, dev, launches, quant,
              arch)
    timed("card_vs_cpu", phase_card_vs_cpu, torch, dev)
    timed("train", phase_train, torch, dev, launches)
    timed("train_mesh", phase_train_mesh, torch, dev)
    timed("train_resume", phase_train_resume, torch, dev)
    timed("cnn", phase_cnn, torch, dev)
    emit({"phase": "phase_seconds", **seconds})

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
                             "flops", "f32_out_device_ms",
                             "f32_out_bf16_device_ms"), 0.0)
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
    from repro_torch.configs import get_config
    main_cfg = get_config(MAIN_ARCH)
    per_fwd = counts_per_step(main_cfg)[0]
    for label, ((K, N), per_step) in weight_shapes(main_cfg).items():
        w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
        row = {"phase": "kernel_shape", "weight": label, "K": K, "N": N,
               "launches_per_decode_step": per_step,
               "checked_M": f"psi8, psi5: 1, {DECODE_M}, "
                            f"{DECODE_M * SPEC_K} (verify), 16-{CTX_LONG_SEQ} "
                            f"step 16; psi2-4, 6, 7: 1, {DECODE_M}, "
                            f"{DECODE_M * SPEC_K} (verify), 16, {PREFILL_M}"}
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
            # a draft step runs SPEC_BITS-wide planes at DECODE_M rows, a
            # verify the serving width at DECODE_M * SPEC_K
            Ms = sorted({1, DECODE_M, DECODE_M * SPEC_K,
                         *(PREFILL_MS if bits in (8, 5) else (16, PREFILL_M))})
            err, ratio = _gemm_errors(torch, ops, ref, qt, plain, Ms, bf16,
                                      gen, dev)
            check(ratio <= 1.0, f"{key} bits={bits} {label} bf16 err {err} "
                                f"over one bf16 ulp of the output")
            max_err[key] = max(max_err[key], err)
            row[f"psi{bits}_max_abs_err"] = err
            if bits == SPEC_BITS:
                # a draft step's shape (M = max_batch), weights cold
                datas = _copies(qt.data, qt.data.numel())
                scale = qt.scale.reshape(-1)
                x = torch.randn(DECODE_M, K, generator=gen,
                                device=dev).to(bf16)
                draft = lambda i, x=x: ops.psi_matmul_2d(
                    x, psi.QuantizedTensor(datas[i], scale, qt.fmt, True))
                nbytes = qt.data.numel() + 4 * N + 2 * DECODE_M * (K + N)
                t_dev = _graph_ms(torch, draft, len(datas),
                                  iters=max(20, len(datas)))
                row[f"psi{bits}_draft"] = {"M": DECODE_M, "bytes": nbytes,
                                           "bound_ms": nbytes / bw * 1e3,
                                           "device_ms": t_dev}
                del datas
            if bits not in (8, 5):
                continue
            t, kern, datas = _decode_times(torch, qt, gen, dev, bw, peak)
            t["f32_out"] = _f32_out_route(torch, qt, datas, gen, dev)
            row[f"psi{bits}_decode"] = t
            a = agg[key]
            for f in ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                      "library_device_ms", "bytes", "flops"):
                a[f] += per_step * t[f]
            a["f32_out_device_ms"] += per_step * t["f32_out"]["device_ms"]
            a["f32_out_bf16_device_ms"] += (per_step
                                            * t["f32_out"]["bf16_device_ms"])
            n_graph = max(20, len(datas))   # every copy once: cold
            # a verify's rows (max_batch x k), weights cold
            xv = torch.randn(DECODE_M * SPEC_K, K, generator=gen,
                             device=dev).to(bf16)
            row[f"psi{bits}_verify"] = {
                "M": DECODE_M * SPEC_K,
                "device_ms": _graph_ms(torch, lambda i: kern(i, xv),
                                       len(datas), iters=n_graph)}
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

    _arch_gemm_rows(torch, dev, bw, peak, gen, max_err)
    _local_gemm_rows(torch, dev, bw, peak, gen, max_err)

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
            # the f32 output route's step (every launch on it) against the
            # bf16 route's, timed side by side
            "f32_out_device_ms": a["f32_out_device_ms"],
            "f32_out_bf16_device_ms": a["f32_out_bf16_device_ms"],
            "scope": f"one full-width {MAIN_ARCH} decode step at "
                     f"psi{bits}: {per_fwd} launches at M={DECODE_M}, "
                     f"weights cold; ms, plain_ms and library_ms are eager "
                     f"loops (host cost included), "
                     f"device_ms and library_device_ms CUDA-graph replays; "
                     f"f32_out_device_ms the same step on the f32 output "
                     f"route, f32_out_bf16_device_ms the bf16 route in the "
                     f"same measurement",
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
    # the other paged configs' head layouts (phi3 40/10, granite 48/1,
    # chatglm3 32/2, qwen3-moe 32/4, qwen2-vl 12/2: G = 6, a partial head
    # block; D 128) over split tables
    arch_heads = _arch_heads()
    for _, hq, hkv in arch_heads:
        for n_bt in (64, 160):
            for qdt, pool in types:
                worst = max(worst, held(split_case(
                    hq * 100 + n_bt, n_bt, hq // hkv, hkv, 128, qdt, pool)))
    max_err["paged_attention"] = max(max_err["paged_attention"], worst)
    emit({"phase": "kernel_paged_attention_split", "ok": True,
          "max_abs_err": worst,
          "cases": "n_bt 64/160 at 32/8/128 (pos on, one short of, inside "
                   "the first split; all -1 slot; last split only), and "
                   "G in 1,2,4,6,8,16,48 x D in 16,64,128,256 at n_bt 64; "
                   f"Hq/Hkv {[h[1:] for h in arch_heads]} at D 128, n_bt "
                   "64/160; q/pool "
                   "bf16/bf16, bf16/int8, f32/f32, f32/int8",
          "tolerance": "as kernel_paged_attention"})

    # -- the speculative verify's shape: DECODE_M slots x SPEC_K query rows,
    # each slot's table repeated SPEC_K times (jnp.repeat's row order),
    # consecutive positions across a block boundary, an inactive slot (its
    # table all -1) and tables with holes
    def verify_case(seed, hq, hkv, D, qdt, pool, bs=16, n_bt=8):
        q, kp, vp, bt, _, ks, vs = case(seed, DECODE_M, n_bt, hq, hkv, D, bs,
                                        qdt, pool)
        q = torch.randn(DECODE_M * SPEC_K, hq, D, generator=gen,
                        device=dev).to(qdt)
        bt[:, 0] = bt[:, 0].abs()
        bt[seed % DECODE_M] = -1
        pos0 = torch.tensor([bs - 2, 2 * bs - 1, 3 * bs + 1, 0][:DECODE_M],
                            dtype=torch.int32, device=dev)
        pos = (pos0[:, None] + torch.arange(SPEC_K, dtype=torch.int32,
                                            device=dev)).reshape(-1)
        tables = bt.repeat_interleave(SPEC_K, 0).contiguous()
        return q, kp, vp, tables, pos.contiguous(), ks, vs

    worst = 0.0
    for hq, hkv, D in ((32, 8, 128), (4, 2, 16)):
        for qdt, pool in types:
            for seed in range(2):
                worst = max(worst, held(verify_case(seed, hq, hkv, D, qdt,
                                                    pool)))
    max_err["paged_attention"] = max(max_err["paged_attention"], worst)
    emit({"phase": "kernel_paged_attention_verify", "ok": True,
          "max_abs_err": worst,
          "cases": f"{DECODE_M} slots x k={SPEC_K} rows, tables repeated k "
                   f"times, positions from bs-2, 2bs-1, 3bs+1, 0 (one slot "
                   f"inactive), 32/8/128 and 4/2/16, q/pool bf16/bf16, "
                   f"bf16/int8, f32/f32, f32/int8",
          "tolerance": "as kernel_paged_attention"})

    import torch.nn.functional as F

    def attn_times(B, n_pos, pool, hq=32, hkv=8):
        """Decode read of B slots at ``n_pos`` positions each, full width
        (qwen3-8b's heads unless ``hq``/``hkv`` say otherwise), held
        against the plain version, then timed."""
        D, bs = 128, 16
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
        err = held((q, kp, vp, bt, pos, ks, vs))
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
        return {"Hq": hq, "Hkv": hkv, "B": B, "positions": n_pos,
                "pool": pool, "max_abs_err": err, "ms": t_k,
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
    for arch, hq, hkv in arch_heads:
        for B, n_pos in ((4, 80), (4, 512), (16, 2048)):
            row = attn_times(B, n_pos, "bf16", hq, hkv)
            max_err["paged_attention"] = max(max_err["paged_attention"],
                                             row["max_abs_err"])
            emit({"phase": "kernel_paged_attention_time", "arch": arch,
                  **row})
    # one rank's heads on a model axis of TP_LOCAL_M
    for arch, hq, hkv in _local_heads():
        for B, n_pos in ((4, 80), (16, 2048)):
            row = attn_times(B, n_pos, "bf16", hq, hkv)
            max_err["paged_attention"] = max(max_err["paged_attention"],
                                             row["max_abs_err"])
            emit({"phase": "kernel_paged_attention_time", "arch": arch,
                  "model_axis": TP_LOCAL_M, **row})
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


def _decode_times(torch, qt, gen, dev, bw, peak, host=True):
    """Kernel 1 or 2 on the (K, N) weight ``qt`` at the decode shape (M =
    DECODE_M), weights cold: ms, plain_ms, library_ms (bf16
    torch.matmul) are eager loops timed by CUDA events (an eager call costs
    its host time, host_ms, where that exceeds its device time);
    device_ms, library_device_ms the same calls replayed from a CUDA graph,
    i.e. device time without the host.  Returns (times, kern, datas):
    ``kern(i, x)`` runs the kernel on weight copy i."""
    from repro_torch.core import psi
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    K, N = qt.shape
    bits = qt.fmt.bits
    wbytes = qt.data.numel() * qt.data.element_size()
    datas = _copies(qt.data, wbytes)
    scale = qt.scale.reshape(-1)
    x = torch.randn(DECODE_M, K, generator=gen, device=dev).to(bf16)
    kern = lambda i, x=x: ops.psi_matmul_2d(
        x, psi.QuantizedTensor(datas[i], scale, qt.fmt, qt.packed))
    t = {"M": DECODE_M, "ms": _median_ms(torch, kern, len(datas))}
    t["device_ms"] = _graph_ms(torch, kern, len(datas),
                               iters=max(20, len(datas)))
    if host:
        t["host_ms"] = _host_ms(torch, kern, len(datas))
    if bits == 8:
        pl = lambda i: ref.psi_matmul_codes_ref(x, datas[i], scale)
    else:
        pl = lambda i: ref.psi_matmul_packed_ref(x, datas[i], scale, bits)
    t["plain_ms"] = _median_ms(torch, pl, len(datas), iters=3, reps=3)
    wdq = qt.dequantize(bf16)
    libs = _copies(wdq, wdq.numel() * 2)
    lib = lambda i: torch.matmul(x, libs[i])
    t["library_ms"] = _median_ms(torch, lib, len(libs))
    t["library_device_ms"] = _graph_ms(torch, lib, len(libs),
                                       iters=max(20, len(libs)))
    del libs, wdq
    t["bytes"] = wbytes + 4 * N + 2 * DECODE_M * K + 2 * DECODE_M * N
    t["flops"] = 2.0 * DECODE_M * K * N
    t["bound_ms"] = max(t["bytes"] / bw, t["flops"] / peak) * 1e3
    t["roofline_share"] = t["bound_ms"] / t["ms"]
    t["device_roofline_share"] = t["bound_ms"] / t["device_ms"]
    return t, kern, datas


def _f32_out_route(torch, qt, datas, gen, dev):
    """Kernel 1 or 2's f32 output route (``out_dtype=torch.float32`` of a
    bf16 x: a row-parallel shard's partial sums, all-reduced before their
    one cast) on the (K, N) weight ``qt``: held against the plain
    version's f32 output at M = DECODE_M and ARCH_PREFILL_ROWS (1e-5 of
    the largest output: the same f32 sums in another order), its cast to
    bf16 equal to the bf16 route's output bit for bit; then both routes'
    device times at M = DECODE_M over the cold weight copies ``datas``
    (CUDA-graph replays of the same calls)."""
    from repro_torch.core import psi
    from repro_torch.kernels import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    K, N = qt.shape
    scale = qt.scale.reshape(-1)
    worst = 0.0
    for M in (DECODE_M, ARCH_PREFILL_ROWS):
        x = torch.randn(M, K, generator=gen, device=dev).to(bf16)
        got = ops.psi_matmul_2d(x, qt, out_dtype=f32)
        check(got.dtype == f32, f"the f32 route returned {got.dtype}")
        if qt.packed:
            want = ref.psi_matmul_packed_ref(x, qt.data, scale, qt.fmt.bits,
                                             out_dtype=f32)
        else:
            want = ref.psi_matmul_codes_ref(x, qt.data, scale, out_dtype=f32)
        err = float((got - want).abs().max())
        check(err <= 1e-5 * max(float(want.abs().max()), 1.0),
              f"f32 route ({M}, {K}, {N}) bits {qt.fmt.bits}: err {err} "
              f"over tolerance")
        check(torch.equal(got.to(bf16), ops.psi_matmul_2d(x, qt)),
              f"f32 route ({M}, {K}, {N}) bits {qt.fmt.bits}: its cast to "
              f"bf16 is not the bf16 route's output bit for bit")
        worst = max(worst, err)
    x = torch.randn(DECODE_M, K, generator=gen, device=dev).to(bf16)

    def run(i, dt):
        return ops.psi_matmul_2d(
            x, psi.QuantizedTensor(datas[i], scale, qt.fmt, qt.packed),
            out_dtype=dt)

    n = max(20, len(datas))
    return {"checked_M": [DECODE_M, ARCH_PREFILL_ROWS],
            "max_abs_err": worst, "bf16_cast_bit_equal": True,
            "M": DECODE_M,
            "device_ms": _graph_ms(torch, lambda i: run(i, f32), len(datas),
                                   iters=n),
            "bf16_device_ms": _graph_ms(torch, lambda i: run(i, None),
                                        len(datas), iters=n),
            "extra_bytes": 2 * DECODE_M * N}


def _extra_ms(cfg, label):
    """(bf16 rows, f32 rows) past ARCH_MS at which a served config runs a
    weight: the SSM's x_proj and dt_proj_w take f32 rows at prefill (the
    conv's f32 taps make x f32 there) at every prompt length up to the
    prefill window's ARCH_PREFILL_ROWS; whisper's encoder and cross K/V
    run its 512-wide matrices over B x enc_frames rows (a prefill of B
    rows, and every decode step's cross K/V over all DECODE_M slots)."""
    if cfg.family == "ssm" and label in ("x_proj", "dt_proj_w"):
        return (), ARCH_MS
    if cfg.family == "encdec" and label != "lm_head":
        return tuple(b * cfg.enc_frames for b in range(1, DECODE_M + 1)), ()
    return (), ()


def _rows_times(torch, qt, M, dtype, gen, dev, bw, peak):
    """Kernel 1 or 2 on ``qt`` at M rows of ``dtype`` x: device time from
    CUDA-graph replays, the plain version's eager time, one torch.matmul
    in x's dtype on the dequantized weight (yardstick), and the bound."""
    from repro_torch.kernels import ops, ref
    K, N = qt.shape
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    kern = lambda i: ops.psi_matmul_2d(x, qt)
    if qt.packed:
        plain = lambda i: ref.psi_matmul_packed_ref(x, qt.data, qt.scale,
                                                    qt.fmt.bits)
    else:
        plain = lambda i: ref.psi_matmul_codes_ref(x, qt.data, qt.scale)
    w = qt.dequantize(dtype)
    lib = lambda i: torch.matmul(x, w)
    t = {"M": M, "dtype": str(dtype).split(".")[-1],
         "device_ms": _graph_ms(torch, kern, 1, iters=10, reps=3),
         "plain_ms": _median_ms(torch, plain, 1, iters=3, reps=3),
         "library_device_ms": _graph_ms(torch, lib, 1, iters=10, reps=3)}
    esz = x.element_size()
    t["bytes"] = (qt.data.numel() * qt.data.element_size() + 4 * N
                  + esz * M * (K + N))
    t["flops"] = 2.0 * M * K * N
    # f32 x runs on CUDA cores: its bound takes the f32 (non-tensor) rate
    rate = peak if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t["bound_ms"] = max(t["bytes"] / bw, t["flops"] / rate) * 1e3
    t["bound_by"] = ("bytes" if t["bytes"] / bw >= t["flops"] / rate
                     else "operations")
    t["device_roofline_share"] = t["bound_ms"] / t["device_ms"]
    del w
    return t


def _arch_gemm_rows(torch, dev, bw, peak, gen, max_err):
    """Kernels 1 (psi8) and 2 (psi5) at the weight shapes of each other
    config: held against their plain versions at ARCH_MS rows in bf16
    (and 4, 16 in f32, the card-vs-CPU serve's rows), and at the rows of
    :func:`_extra_ms` (the SSM's f32 prefill route, also batch invariant
    bit for bit: 288 rows against 256 + 32; whisper's B x 1500 encoder
    and cross K/V rows), then timed alone at M = DECODE_M with the
    weights cold (eager, graph replay, plain version, bf16 torch.matmul)
    and at M = 64 (graph replay), and at psi8 at the largest extra row
    count.  One row per shape, then one per config and width with the
    sums over a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core import psi
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    for arch in ARCHS:
        cfg = get_config(arch)
        step = {8: dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms",
                                  "library_device_ms", "bytes", "flops"),
                                 0.0)}
        step[5] = dict(step[8])
        for wl, ((K, N), per_step) in weight_shapes(cfg).items():
            w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
            row = {"phase": "kernel_shape_arch", "arch": arch, "weight": wl,
                   "K": K, "N": N, "launches_per_decode_step": per_step,
                   "checked_M": f"bf16 {ARCH_MS}, f32 (4, 16)"}
            for bits in (8, 5):
                qt = psi.quantize_weights(w, bits, axis=(0,))
                key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
                if bits < 8:
                    qt = qt.pack()
                    plain = lambda x, q=qt: ref.psi_matmul_packed_ref(
                        x, q.data, q.scale, 5)
                else:
                    plain = lambda x, q=qt: ref.psi_matmul_codes_ref(
                        x, q.data, q.scale)
                err, ratio = _gemm_errors(torch, ops, ref, qt, plain,
                                          ARCH_MS, bf16, gen, dev)
                check(ratio <= 1.0, f"{key} {arch} {wl} bf16 err {err} over "
                                    f"one bf16 ulp of the output")
                err32, ratio = _gemm_errors(torch, ops, ref, qt, plain,
                                            (4, 16), torch.float32, gen, dev)
                check(ratio <= 1.0, f"{key} {arch} {wl} f32 err {err32} "
                                    f"over tolerance")
                extra = {}
                xb, xf = _extra_ms(cfg, wl)
                if xb:
                    e, ratio = _gemm_errors(torch, ops, ref, qt, plain, xb,
                                            bf16, gen, dev)
                    check(ratio <= 1.0, f"{key} {arch} {wl} bf16 err {e} at "
                                        f"rows {xb} over one bf16 ulp")
                    err = max(err, e)
                    extra["bf16_rows_M"], extra["bf16_rows_err"] = xb, e
                if xf:
                    e, ratio = _gemm_errors(torch, ops, ref, qt, plain, xf,
                                            torch.float32, gen, dev)
                    check(ratio <= 1.0, f"{key} {arch} {wl} f32 err {e} at "
                                        f"rows {xf} over tolerance")
                    err32 = max(err32, e)
                    extra["f32_rows_M"], extra["f32_rows_err"] = xf, e
                    x = torch.randn(ARCH_PREFILL_ROWS, K, generator=gen,
                                    device=dev)
                    whole = ops.psi_matmul_2d(x, qt)
                    parts = torch.cat([ops.psi_matmul_2d(x[:256], qt),
                                       ops.psi_matmul_2d(x[256:], qt)])
                    check(torch.equal(whole, parts),
                          f"{key} {arch} {wl}: the f32 route's rows depend "
                          f"on the batch ({ARCH_PREFILL_ROWS} vs 256 + "
                          f"{ARCH_PREFILL_ROWS - 256})")
                    extra["f32_batch_invariant"] = True
                if bits == 8 and (xb or xf):
                    extra["rows_time"] = _rows_times(
                        torch, qt, max(xb) if xb else ARCH_PREFILL_ROWS,
                        bf16 if xb else torch.float32, gen, dev, bw, peak)
                max_err[key] = max(max_err[key], err)
                t, kern, datas = _decode_times(torch, qt, gen, dev, bw, peak,
                                               host=False)
                t["f32_out"] = _f32_out_route(torch, qt, datas, gen, dev)
                xp = torch.randn(64, K, generator=gen, device=dev).to(bf16)
                t["prefill_64_device_ms"] = _graph_ms(
                    torch, lambda i: kern(i, xp), len(datas), iters=5)
                del datas, kern
                if bits == 8:
                    plan = _codes_plan(K, N)
                else:
                    plan = dict(zip(("chunk", "n_split"), _packed_plan(K, N)))
                row[f"psi{bits}"] = {"max_abs_err": err,
                                     "f32_max_abs_err": err32, **t,
                                     "plan": plan, **extra}
                for f in step[bits]:
                    step[bits][f] += per_step * t[f]
            emit(row)
            del w
            torch.cuda.empty_cache()
        for bits, a in step.items():
            bound = max(a["bytes"] / bw, a["flops"] / peak) * 1e3
            emit({"phase": "kernel_step_arch", "arch": arch,
                  "kernel": ("psi_matmul_codes" if bits == 8
                             else "psi_matmul_packed"),
                  "bits": bits, "launches_per_decode_step":
                  counts_per_step(cfg)[0], **a, "bound_ms": bound,
                  "device_roofline_share": bound / a["device_ms"]})


def local_weight_shapes(cfg, m):
    """:func:`weight_shapes` of one rank's share of ``cfg`` on a model axis
    of ``m``, the share ``parallel.tp_local_config`` holds."""
    from repro_torch.runtime.parallel import tp_local_config
    tp_local_config(cfg, m)             # the split is one the port serves
    return weight_shapes(cfg, m)


def _local_gemm_rows(torch, dev, bw, peak, gen, max_err):
    """Kernels 1 (psi8) and 2 (psi5) at every rank's local weight shapes of
    the tensor / expert-parallel configs on a model axis of TP_LOCAL_M:
    held against their plain versions at TP_LOCAL_MS rows in bf16 and
    (4, 16) in f32, plus the f32 rows of :func:`_extra_ms` (the SSM's
    x_proj / dt_proj at prefill), then timed at M = DECODE_M with the
    weights cold (graph replay, plain version, bf16 torch.matmul) and, for
    an f32-route weight, at ARCH_PREFILL_ROWS f32 rows."""
    from repro_torch.configs import get_config
    from repro_torch.core import psi
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    for arch in TP_LOCAL_ARCHS + TP_RING_ARCHS:
        cfg = get_config(arch)
        ms = (TP_LOCAL_MS, (4, 16)) if arch in TP_LOCAL_ARCHS else (
            (DECODE_M,), (DECODE_M,))
        for wl, ((K, N), per_step) in local_weight_shapes(
                cfg, TP_LOCAL_M).items():
            w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
            row = {"phase": "kernel_shape_local", "arch": arch,
                   "model_axis": TP_LOCAL_M, "weight": wl, "K": K, "N": N,
                   "launches_per_decode_step": per_step,
                   "checked_M": f"bf16 {ms[0]}, f32 {ms[1]}"}
            for bits in (8, 5):
                qt = psi.quantize_weights(w, bits, axis=(0,))
                key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
                if bits < 8:
                    qt = qt.pack()
                    plain = lambda x, q=qt: ref.psi_matmul_packed_ref(
                        x, q.data, q.scale, 5)
                else:
                    plain = lambda x, q=qt: ref.psi_matmul_codes_ref(
                        x, q.data, q.scale)
                err, ratio = _gemm_errors(torch, ops, ref, qt, plain,
                                          ms[0], bf16, gen, dev)
                check(ratio <= 1.0, f"{key} {arch} local {wl} bf16 err {err} "
                                    f"over one bf16 ulp of the output")
                _, xf = _extra_ms(cfg, wl)
                f32_ms = tuple(sorted({*ms[1], *xf}))
                err32, ratio = _gemm_errors(torch, ops, ref, qt, plain,
                                            f32_ms, torch.float32, gen, dev)
                check(ratio <= 1.0, f"{key} {arch} local {wl} f32 err "
                                    f"{err32} at rows {f32_ms} over tolerance")
                max_err[key] = max(max_err[key], err, err32)
                t, _, datas = _decode_times(torch, qt, gen, dev, bw, peak,
                                            host=False)
                del datas
                t["bound_by"] = ("bytes" if t["bytes"] / bw
                                 >= t["flops"] / peak else "operations")
                t["library_bound_share"] = (t["bound_ms"]
                                            / t["library_device_ms"])
                row[f"psi{bits}"] = {"max_abs_err": err,
                                     "f32_max_abs_err": err32,
                                     "f32_checked_M": f32_ms, **t}
                if bits == 8 and xf:
                    row["psi8"]["f32_rows_time"] = _rows_times(
                        torch, qt, ARCH_PREFILL_ROWS, torch.float32, gen,
                        dev, bw, peak)
            emit(row)
            del w
            torch.cuda.empty_cache()


def _local_heads():
    """(arch, local Hq, local Hkv) of each TP_LOCAL_ARCHS / TP_RING_ARCHS
    config that can read through kernel 3 (head_dim 128) on a model axis
    of TP_LOCAL_M (an MQA head is read whole by every rank's heads)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.parallel import tp_local_config
    out = []
    for a in TP_LOCAL_ARCHS + TP_RING_ARCHS:
        cfg = get_config(a)
        if cfg.is_attention_free or cfg.family == "hybrid":
            continue            # no attention, or only on the dense ring
        local = tp_local_config(cfg, TP_LOCAL_M)
        check(local.resolved_head_dim == 128, f"{a}: kernel 3's rows here "
                                              f"are at head_dim 128")
        out.append((a, local.n_heads, local.n_kv_heads))
    return out


def _arch_heads():
    """(arch, Hq, Hkv) of each config in ARCHS that decodes through kernel
    3 (the paged ones; all at head_dim 128), in order."""
    from repro_torch.configs import get_config
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        if cfg.paged_capable:
            check(cfg.resolved_head_dim == 128, f"{a}: kernel 3's rows here "
                                                f"are at head_dim 128")
            out.append((a, cfg.n_heads, cfg.n_kv_heads))
    return out


def _codes_plan(K, N):
    from repro_torch.kernels import _build
    from repro_torch.kernels import psi_matmul as pm
    tile, chunk, n_split = pm.codes_split_plan(K, N, _build.sm_count(0))
    return {"tile": tile, "chunk": chunk, "n_split": n_split,
            "blocks": -(-N // tile) * n_split}


def _packed_plan(K, N):
    from repro_torch.kernels import _build
    from repro_torch.kernels import psi_matmul as pm
    return pm.split_plan(K, N, _build.sm_count(0))


def phase_ring_merge(torch, dev, bw):
    """2b: the decode read of a dense KV ring whose positions split over a
    model axis of TP_LOCAL_M, on one card: RING_B rows against one
    RING_C-slot bf16 slab cut into TP_LOCAL_M chunks, each chunk's partial
    softmax (``attention.ring_partial``, every query head) merged in chunk
    order (``attention.merge_ring_partials``), held against plain sdpa
    over the whole slab (the single process's read); rows before the ring
    has filled, at its wrap and past it.  Device times (CUDA-graph
    replays, slabs cold): the whole-slab sdpa, all chunks and the merge,
    and one rank's share (its chunk and the merge of all the chunks'
    partials)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    bf16, m = torch.bfloat16, TP_LOCAL_M
    B, C = RING_B, RING_C
    cc = C // m
    for arch in ("granite-34b", "recurrentgemma-9b"):
        cfg = get_config(arch)
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        window = cfg.window if cfg.attn_type == "swa" else 0
        g = torch.Generator(device=dev)
        g.manual_seed(H * 1000 + D)
        q = torch.randn(B, 1, H, D, generator=g, device=dev).to(bf16)
        k = torch.randn(B, C, Hkv, D, generator=g, device=dev).to(bf16)
        v = torch.randn(B, C, Hkv, D, generator=g, device=dev).to(bf16)
        P = torch.tensor([C // 2 - 3, C - 1, C + 5, 3 * C + 17],
                         dtype=torch.int32, device=dev)[:B]
        # ring slot i holds the newest position p <= P with p % C == i
        i = torch.arange(C, dtype=torch.int32, device=dev)
        kp = P[:, None] - (P[:, None] - i[None]) % C
        kp = torch.where(kp >= 0, kp, torch.full_like(kp, -1))
        qp = P[:, None]

        def parts(kk, vv, n=m):
            return [att.ring_partial(q, kk[:, c * cc:(c + 1) * cc],
                                     vv[:, c * cc:(c + 1) * cc], qp,
                                     kp[:, c * cc:(c + 1) * cc], window)
                    for c in range(n)]

        want = att.sdpa(q, k, v, qp, kp, window=window)[:, 0].float()
        a = att.sdpa(q, k, v.abs(), qp, kp, window=window)[:, 0].float()
        got = att.merge_ring_partials(parts(k, v))
        check(torch.isfinite(got).all().item(), "ring merge: non-finite")
        d = (got - want).abs()
        # the plain read rounds its probabilities to bf16 before the values
        # (2^-9 A each), the merge does not, and both outputs round once
        tol = 2.0 ** -7 * want.abs() + 2.0 ** -5 * a
        check(not bool((d > tol).any()),
              f"ring merge {arch}: err {float(d.max())} over its "
              f"per-element tolerance")
        slab = 2 * k.numel() * k.element_size()
        sets = list(zip(_copies(k, slab), _copies(v, slab)))
        rest = parts(k, v)[1:]
        n = max(20, len(sets))
        t_whole = _graph_ms(torch, lambda j: att.sdpa(
            q, sets[j][0], sets[j][1], qp, kp, window=window), len(sets),
            iters=n)
        t_all = _graph_ms(torch, lambda j: att.merge_ring_partials(
            parts(*sets[j])), len(sets), iters=n)
        t_rank = _graph_ms(torch, lambda j: att.merge_ring_partials(
            parts(*sets[j], n=1) + rest), len(sets), iters=n)
        nbytes = slab + 2 * q.numel() * 2 + 4 * kp.numel()
        emit({"phase": "ring_merge", "arch": arch, "B": B, "C": C,
              "chunks": m, "Hq": H, "Hkv": Hkv, "D": D, "window": window,
              "positions": P.tolist(), "max_abs_err": float(d.max()),
              "tolerance": "2^-7 |want| + 2^-5 A, A = sdpa on |V|",
              "sdpa_device_ms": t_whole, "merge_all_device_ms": t_all,
              "rank_device_ms": t_rank, "bytes": nbytes,
              "bound_ms": nbytes / bw * 1e3,
              "rank_bound_ms": nbytes / m / bw * 1e3})
        del sets
    torch.cuda.empty_cache()


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


def _free(torch):
    """Drop the last phase's model: collect the reference cycles that keep
    its params (and graphs) alive, then return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, dev, launches, quant, arch=MAIN_ARCH):
    """Server.serve of full-width ``arch`` (all its layers) from ``quant``
    codes, continuous then static: identical tokens, the config's
    PSI-matmul launches per forward (kernel 1 at psi8, kernel 2 at psi5:
    253 for qwen3-8b, 281 phi3-medium-14b, 529 granite-34b, 197
    chatglm3-6b) and one attention launch per layer and decode step, each
    decode step a replay of the captured horizon-1 graph, no leaked block;
    then a profiled decode window: for qwen3-8b three ways (eager step,
    horizon-1 graph, horizon-8 round) and, at psi8, the same trace served
    at horizon 8 (phase serve_psi8_horizon); for the other configs the
    eager step and the graph, and one prefill forward of
    ARCH_PREFILL_ROWS rows.  The other configs serve the psi8 trace (8
    requests, prompts 64 +- 8, 8-16 new tokens).

    An MoE config (qwen3-moe-30b-a3b: 193 matmuls per forward, none from
    its experts) serves the same trace with every request arriving at
    once and 16 new tokens each, and is served at horizon 8 too (phase
    serve_qwen3moe_psi8_horizon); the routing of its prefills is logged
    (capacities, slots kept, which must fall short of the slots routed:
    tokens drop), and one decode step's MoE time is split into the
    expert dequantize and the expert GEMMs (moe_layer_split).

    qwen2-vl-2b (paged, M-RoPE's equal streams, 197 matmuls a forward)
    and recurrentgemma-9b (the dense 2048-ring, 293 matmuls, no kernel 3;
    one prefill forward a request where an admission's prompt lengths
    differ) serve the psi8 trace and, like MoE, at horizon 8
    (continuous); both time their tied head built once against a
    transpose per call (tied_head), and the hybrid splits its rec blocks
    into PSI and other time at decode and prefill (rec_layer_split).
    falcon-mamba-7b (dense, 257 matmuls a forward and step) and
    whisper-base (dense, 61 a step, 97 a prefill forward: its encoder)
    serve the same way, exact-length prefills both; falcon-mamba splits
    its mamba blocks (mamba_layer_split), whisper its cross K/V
    projection and encoder (xattn_split)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    main = arch == MAIN_ARCH
    family = get_config(arch).family
    moe = family == "moe"
    if main and quant != "psi8":
        args = _serve_args(quant=quant, requests=4, max_new=8, min_new=4)
    elif moe:
        # an MoE row's routing depends on the burst that prefills it (pad
        # positions route and take capacity; C follows the padded length),
        # in the JAX package too: so that continuous, static and horizon 8
        # are comparable token for token, every request arrives at once
        # with one budget and all three admit the same two bursts of four
        args = _serve_args(arch=arch, quant=quant, arrival_rate=1e9,
                           min_new=16)
    else:
        args = _serve_args(arch=arch, quant=quant)
    name = f"serve_{quant}" if main else f"serve_{ARCHS[arch][0]}_{quant}"
    key = "psi_matmul_codes" if quant == "psi8" else "psi_matmul_packed"
    t_phase = time.perf_counter()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, cfg = serve.build_server(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check_full(cfg, arch)
    per_fwd, per_step = counts_per_step(cfg)
    server.warmup(serve.trace_from_args(args, cfg))
    rows, undo = _record_prefill_rows(server.executor)
    routed, undo_route = _route_log() if moe else ([], lambda: None)
    ops.reset_launch_counts()                         # the main path starts
    runs, admitted = {}, {}
    try:
        for mode in ("continuous", "static"):
            admitted[mode], undo_admits = _admissions(server)
            try:
                done, stats = server.serve(serve.trace_from_args(args, cfg),
                                           continuous=(mode == "continuous"),
                                           warmup=False)
            finally:
                undo_admits()
            runs[mode] = ({r.rid: r.tokens for r in done}, stats, done)
    finally:
        undo()
        undo_route()
    torch.cuda.synchronize()
    got = ops.launch_counts()                         # ... and ends here
    held = _check_prefill_rows(torch, rows, name, server.executor.params,
                               PREFILL_MS if main else ARCH_MS)
    _check_bursts(name, {m: runs[m][1] for m in runs}, admitted,
                  exact=not server._pad_ok)
    (tc, sc, done_c), (ts, ss, _) = runs["continuous"], runs["static"]
    check(tc == ts, f"{name}: continuous and static modes emitted "
                    f"different tokens")
    check(all(len(r.tokens) == r.max_new for r in done_c),
          f"{name}: a request did not get its max_new tokens")
    check(all(0 <= t < cfg.vocab_size for toks in tc.values() for t in toks),
          "token id out of the vocabulary")
    drops = _drops(routed) if moe else None
    if moe:
        check(drops["slots_kept"] < drops["slots_routed"],
              f"{name}: no token dropped in the prefills {drops}")
    check(sc["decode_compiles"] == ss["decode_compiles"] == 1,
          f"{name}: want one captured decode graph, got "
          f"{sc['decode_compiles']} / {ss['decode_compiles']}")
    for st in (sc, ss):
        check("n_blocks" not in st or st["blocks_free_end"] == st["n_blocks"],
              f"{name}: {st.get('n_blocks', 0) - st.get('blocks_free_end', 0)}"
              f" blocks leaked")
    steps = sc["decode_steps"] + ss["decode_steps"]
    fwd = sc["prefill_forwards"] + ss["prefill_forwards"]
    want = {"psi_matmul_codes": 0, "psi_matmul_packed": 0,
            "paged_attention": per_step * steps}
    want[key] = matmul_launches(cfg, steps, fwd)
    check(got == want, f"{name} launch counts {got} != expected {want} "
                       f"({per_fwd} per decode step, "
                       f"{per_fwd + encoder_launches(cfg)} per prefill "
                       f"forward, {per_step} attention per decode step)")
    ex = server.executor
    r0 = done_c[0]
    with torch.inference_mode():
        logits, _ = ex.model.forward(
            ex.params, torch.as_tensor(r0.prompt[None], device=dev))
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, len(r0.prompt), cfg.vocab_size), "prefill logits not finite")
    del logits
    launches[key] = launches.get(key, 0) + got[key]
    launches["paged_attention"] = (launches.get("paged_attention", 0)
                                   + got["paged_attention"])
    server8 = prefill = split = tied = None
    if main or arch in HORIZON_ARCHS:
        # the same params behind a horizon-8 server: its warmup captures
        # the one 8-step round graph
        server8 = serve.Server(cfg, ex.params, max_batch=args.max_batch,
                               max_seq=server.max_seq, eos_id=args.eos_id,
                               device=dev, decode_horizon=HORIZON)
        server8.warmup(serve.trace_from_args(args, cfg))
    # an eager MoE step is ~10k ops, each recorded by the profiler: two
    # steps a mode, and no round window (its horizon phase serves one)
    window = (_decode_window(torch, server, steps=2) if moe
              else _decode_window(torch, server, server8))
    burst = _burst_window(torch, server) if main and quant == "psi8" \
        else None
    # the serve's peak, before a split resets the counter to read its own
    peak = torch.cuda.max_memory_allocated()
    if not main:
        # one prefill forward of ARCH_PREFILL_ROWS rows: a table (or a
        # slab) that covers them, one slot, no decode graph
        bs = cfg.cache_block_size
        nb = -(-(ARCH_PREFILL_ROWS + bs) // bs)
        pserver = serve.Server(cfg, ex.params, max_batch=1,
                               max_seq=nb * bs, device=dev,
                               n_blocks=nb if server.paged else None)
        prefill = _prefill_window(torch, pserver, rows=(ARCH_PREFILL_ROWS,),
                                  calls=1 if moe else 3)
        if moe:
            # one more such forward with its routing logged
            import numpy as np
            M = ARCH_PREFILL_ROWS
            log, undo_route = _route_log()
            try:
                pserver.executor.prefill(
                    (np.arange(M, dtype=np.int32) % cfg.vocab_size)[None],
                    np.asarray([M], np.int32))
            finally:
                undo_route()
            prefill["routing"] = _drops(log)
            split = _moe_split(torch, ex)
        if family == "hybrid":
            split = _rec_split(torch, ex)
        if family == "ssm":
            split = _mamba_split(torch, ex, pserver)
        if family == "encdec":
            split = _xattn_split(torch, ex, pserver)
        if cfg.tie_embeddings:
            tied = _tied_head_times(torch, ex)
        del pserver
    keep = ("tok_per_s", "wall_s", "tokens", "p50_latency_s",
            "p99_latency_s", "p50_ttft_s", "p99_ttft_s", "p50_itl_s",
            "p99_itl_s", "decode_steps", "prefill_forwards",
            "peak_concurrency", "cache_bytes", "block_util_pct",
            "host_syncs", "host_syncs_per_token", "decode_compiles",
            "macs_per_token", "mfu", "watts", "tokens_per_joule")
    step_bytes = _step_weight_bytes(ex.params)
    emit({"phase": f"{name}_full_width", "arch": arch,
          "layers": cfg.n_layers, "requests": args.requests,
          "max_batch": args.max_batch,
          "prompt_len": f"{args.prompt_len}+-{args.prompt_jitter}",
          "max_new": args.max_new, "init_quantize_s": round(init_s, 3),
          "param_bytes": _param_bytes(ex.params),
          "step_weight_bytes": step_bytes,
          "step_bound_ms": step_bytes / card_rates(
              torch.cuda.get_device_name(0))[0] * 1e3,
          "continuous": {k: sc[k] for k in keep if k in sc},
          "static": {k: ss[k] for k in keep if k in ss},
          "tokens_identical": True, "launches": got,
          "launches_per_forward": per_fwd,
          "attention_per_decode_step": per_step,
          "launches_per_prefill_forward": per_fwd + encoder_launches(cfg),
          "admissions": admitted, "prefill_rows_held_here": held,
          "decode_window": window, "prefill_window": prefill,
          "burst_prefill_window": burst, "prefill_routing": drops,
          SPLIT_KEYS.get(family, "moe_layer_split"): split,
          "tied_head": tied,
          "peak_mem_bytes": max(peak, torch.cuda.max_memory_allocated()),
          "phase_wall_s": time.perf_counter() - t_phase})
    if arch in HORIZON_ARCHS:
        phase_serve_horizon(torch, server8, args, cfg, tc, launches, keep,
                            f"{name}_horizon", ("continuous",))
    if main and quant == "psi8":
        phase_serve_horizon(torch, server8, args, cfg, tc, launches, keep)
        del server8
        _free(torch)
        server8 = None
        phase_serve_dense(torch, dev, server, args, cfg, done_c, launches,
                          keep, window)
        phase_serve_mesh(torch, dev, server, args, cfg, tc, launches, keep)
    del server, server8, ex, runs, done_c
    _free(torch)


# the phase line's key of each family's layer split
SPLIT_KEYS = {"moe": "moe_layer_split", "hybrid": "rec_layer_split",
              "ssm": "mamba_layer_split", "encdec": "xattn_split"}


def _check_bursts(name, stats, admitted, exact=False):
    """Each admission event of a full-attention serve outside context
    serving is one prefill forward, whatever its size: the burst rule.
    ``exact`` (recurrent state, which pads would pollute): an event of
    prompts of one length is one forward, of unequal lengths one forward
    a request."""
    for mode, st in stats.items():
        want = sum(1 if not exact or len(set(ev)) == 1 else len(ev)
                   for ev in admitted[mode])
        check(st["prefill_forwards"] == want,
              f"{name} {mode}: {st['prefill_forwards']} prefill forwards "
              f"for admission events (prompt lengths) {admitted[mode]}, "
              f"want {want}")


def _route_log():
    """Wrap the MoE router (``models.moe.route``) to record each call over
    more than one token (prefills, chunks, verifies; decode steps replay
    graphs): (tokens a row S, capacity C, slots routed B x k x S, slots
    kept as a device tensor read after the run); returns (log, undo)."""
    from repro_torch.models import moe
    log = []
    real = moe.route

    def logged(p, x, cfg, *a, **kw):
        out = real(p, x, cfg, *a, **kw)
        if x.shape[1] > 1:
            log.append((int(x.shape[1]), out[4], out[2].numel(),
                        out[2].sum()))
        return out

    moe.route = logged

    def undo():
        moe.route = real
    return log, undo


def _drops(log):
    """The routing a _route_log recorded: calls, rows S and capacities C
    seen, slots routed and kept, and the dropped share."""
    kept = sum(int(k) for _, _, _, k in log)
    total = sum(n for _, _, n, _ in log)
    return {"route_calls": len(log),
            "rows": sorted({S for S, _, _, _ in log}),
            "capacities": sorted({C for _, C, _, _ in log}),
            "slots_routed": total, "slots_kept": kept,
            "dropped_share": 1.0 - kept / total if total else 0.0}


def _moe_split(torch, ex):
    """One decode step's MoE FFNs at the serve's shape (max_batch tokens,
    one a slot), device time from CUDA-graph replays over every layer in
    turn (each layer's codes, 604 MB at psi8, come from HBM): the three
    expert blocks' one-pass dequantize to bf16 (and the plain
    ``QuantizedTensor.dequantize``: three passes through f32, bit-equal),
    the three expert GEMMs on
    dequantized blocks (C = 1), and the whole moe_ffn (routing, dispatch,
    dequantize, GEMMs, combine); each summed over the layers, beside the
    bytes the dequantize and the GEMMs move and their bound."""
    from repro_torch.models import moe
    cfg = ex.model.cfg
    layers = [p["moe"] for p in ex.params["layers"]]
    L, B, dev = len(layers), ex.max_batch, ex.device
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    bw = card_rates(torch.cuda.get_device_name(0))[0]
    names = ("w_gate", "w_up", "w_down")
    x = torch.randn(B, 1, d, device=dev).to(bf16)
    xe = torch.randn(E, B, d, device=dev).to(bf16)
    he = torch.randn(E, B, f, device=dev).to(bf16)
    deq = lambda i: [moe._dequantize_bf16(layers[i][n]) for n in names]
    plain = lambda i: [layers[i][n].dequantize(bf16) for n in names]
    w = deq(0)
    gemm = lambda i: (moe._expert_bmm(xe, w[0]), moe._expert_bmm(xe, w[1]),
                      moe._expert_bmm(he, w[2]))
    with torch.inference_mode():
        t_deq = _graph_ms(torch, deq, L, iters=L, reps=3) * L
        t_plain = _graph_ms(torch, plain, L, iters=L, reps=3) * L
        t_gemm = _graph_ms(torch, gemm, 1, iters=L, reps=3) * L
        t_ffn = _graph_ms(torch, lambda i: moe.moe_ffn(layers[i], x, cfg),
                          L, iters=L, reps=3) * L
    del w
    n = 3 * E * d * f                       # expert weights a layer
    codes = sum(layers[0][k].data.numel() * layers[0][k].data.element_size()
                + layers[0][k].scale.numel() * 4 for k in names)
    deq_bytes = L * (codes + 2 * n)         # read codes, write bf16
    gemm_bytes = L * 2 * n                  # read the bf16 blocks
    return {"layers": L, "tokens": B, "dequantize_ms_per_step": t_deq,
            "plain_dequantize_ms_per_step": t_plain,
            "expert_gemm_ms_per_step": t_gemm,
            "moe_ffn_ms_per_step": t_ffn,
            "routing_dispatch_combine_ms_per_step": t_ffn - t_deq - t_gemm,
            "dequantize_bytes": deq_bytes, "expert_gemm_bytes": gemm_bytes,
            "dequantize_bound_ms": deq_bytes / bw * 1e3,
            "expert_gemm_bound_ms": gemm_bytes / bw * 1e3,
            "codes_read_once_ms": L * codes / bw * 1e3}


def _rec_split(torch, ex, rows=ARCH_PREFILL_ROWS):
    """The hybrid's rec blocks, device time from CUDA-graph replays over
    every rec layer in turn (each layer's codes come from HBM), summed over
    the rec layers: a decode step's block at the serve's shape (max_batch
    tokens; ``rglru_decode_step``, the freeze of inactive rows and the
    state's copy back, as ``apply_block_decode`` runs them) against its
    five PSI matmuls alone, the difference being the conv, the gates, the
    recurrence and the freeze; and one ``rows``-row prefill's block
    (``rglru_block``) against its five matmuls alone, the difference being
    the conv, the gates and the scan, and the scan alone."""
    from repro_torch.kernels import ops
    from repro_torch.models import rglru, transformer
    cfg = ex.model.cfg
    kinds = transformer.layer_kinds(cfg)
    recs = [p["rec"] for p, k in zip(ex.params["layers"], kinds)
            if k == "rec"]
    L, B, dev, dt = len(recs), ex.max_batch, ex.device, ex.model.dtype
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(B, 1, d, generator=g, device=dev).to(dt)
    xr = torch.randn(B, 1, dr, generator=g, device=dev).to(dt)
    state = rglru.init_rglru_state(cfg, B, dev)
    state["h"].normal_(generator=g)
    out_state = {k: v.clone() for k, v in state.items()}
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[-1] = False

    def step(i):
        _, new = rglru.rglru_decode_step(recs[i], x, cfg, state)
        for k, t in transformer._freeze_inactive_state(new, state,
                                                       active).items():
            out_state[k].copy_(t)

    def matmuls(xa, xb):
        def run(i):
            p = recs[i]
            for w, v in (("w_in_gate", xa), ("w_in_rec", xa),
                         ("rglru_wa", xb), ("rglru_wx", xb), ("w_out", xb)):
                ops.psi_matmul(v, p[w])
        return run

    xp = torch.randn(1, rows, d, generator=g, device=dev).to(dt)
    xpr = torch.randn(1, rows, dr, generator=g, device=dev).to(dt)
    a = torch.rand(1, rows, dr, generator=g, device=dev)
    b = torch.randn(1, rows, dr, generator=g, device=dev)
    h0 = torch.zeros(1, dr, device=dev)
    with torch.inference_mode():
        t_step = _graph_ms(torch, step, L, iters=L, reps=3) * L
        t_mm = _graph_ms(torch, matmuls(x, xr), L, iters=L, reps=3) * L
        t_pre = _graph_ms(torch, lambda i: rglru.rglru_block(recs[i], xp,
                                                             cfg),
                          L, iters=L, reps=3) * L
        t_pre_mm = _graph_ms(torch, matmuls(xp, xpr), L, iters=L,
                             reps=3) * L
        t_scan = _graph_ms(torch, lambda i: rglru._scan(a, b, h0), 1,
                           iters=L, reps=3) * L
    return {"rec_layers": L, "decode_tokens": B,
            "decode_rec_block_ms_per_step": t_step,
            "decode_rec_psi_ms_per_step": t_mm,
            "decode_rec_non_psi_ms_per_step": t_step - t_mm,
            "prefill_rows": rows, "prefill_rec_block_ms": t_pre,
            "prefill_rec_psi_ms": t_pre_mm,
            "prefill_rec_non_psi_ms": t_pre - t_pre_mm,
            "prefill_scan_ms": t_scan}


def _mamba_split(torch, ex, pserver, rows=ARCH_PREFILL_ROWS):
    """The SSM's mamba blocks, device time from CUDA-graph replays over
    every layer in turn (each layer's codes come from HBM), summed over
    the layers: a decode step's block at the serve's shape (max_batch
    tokens; ``mamba_decode_step``, the freeze of inactive rows and the
    state's copy back, as ``apply_block_decode`` runs them) against its
    four PSI matmuls alone (bf16 rows), the difference being the conv,
    the discretization, the update and the freeze; one ``rows``-row
    prefill's block (``mamba_block``) against its four matmuls alone
    (x_proj and dt_proj_w on f32 rows, as the prefill runs them), and the
    chunked selective scan alone (discretization, doubling scan, C
    contraction); and the peak memory one ``rows``-row prefill forward
    (``pserver``'s) adds over what was allocated before it."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, transformer
    cfg = ex.model.cfg
    mambas = [p["mamba"] for p in ex.params["layers"]]
    L, B, dev, dt = len(mambas), ex.max_batch, ex.device, ex.model.dtype
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = cfg.resolved_dt_rank
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(B, 1, d, generator=g, device=dev).to(dt)
    state = ssm.init_mamba_state(cfg, B, dev)
    state["ssm"].normal_(generator=g)
    state["conv"].normal_(generator=g)
    out_state = {k: v.clone() for k, v in state.items()}
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[-1] = False

    def step(i):
        _, new = ssm.mamba_decode_step(mambas[i], x, cfg, state)
        for k, t in transformer._freeze_inactive_state(new, state,
                                                       active).items():
            out_state[k].copy_(t)

    def matmuls(M, xdt):
        xa = torch.randn(M, d, generator=g, device=dev).to(dt)
        xc = torch.randn(M, di, generator=g, device=dev).to(xdt)
        xr = torch.randn(M, r, generator=g, device=dev).to(xdt)
        xy = torch.randn(M, di, generator=g, device=dev).to(dt)

        def run(i):
            p = mambas[i]
            for w, v in (("in_proj", xa), ("x_proj", xc), ("dt_proj_w", xr),
                         ("out_proj", xy)):
                ops.psi_matmul(v, p[w])
        return run

    xp = torch.randn(1, rows, d, generator=g, device=dev).to(dt)
    dts = torch.rand(1, rows, di, generator=g, device=dev) * 0.1
    xcs = torch.randn(1, rows, di, generator=g, device=dev)
    bms = torch.randn(1, rows, N, generator=g, device=dev)
    cms = torch.randn(1, rows, N, generator=g, device=dev)
    h0 = torch.zeros(1, di, N, device=dev)
    with torch.inference_mode():
        t_step = _graph_ms(torch, step, L, iters=L, reps=3) * L
        t_mm = _graph_ms(torch, matmuls(B, dt), L, iters=L, reps=3) * L
        t_pre = _graph_ms(torch, lambda i: ssm.mamba_block(mambas[i], xp,
                                                           cfg),
                          L, iters=L, reps=3) * L
        t_pre_mm = _graph_ms(torch, matmuls(rows, torch.float32), L,
                             iters=L, reps=3) * L
        t_scan = _graph_ms(torch, lambda i: ssm._selective_scan(
            mambas[i], dts, xcs, bms, cms, h0), L, iters=L, reps=3) * L
    # one prefill forward of ``rows`` tokens, its peak over what it found
    import numpy as np
    pex = pserver.executor
    cache = pex.init_cache()
    toks = (np.arange(rows, dtype=np.int32) % cfg.vocab_size)[None]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pex.prefill_insert(toks, np.asarray([rows], np.int32), cache, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    chunk = min(rows, ssm.CHUNK)
    return {"mamba_layers": L, "decode_tokens": B,
            "decode_mamba_block_ms_per_step": t_step,
            "decode_mamba_psi_ms_per_step": t_mm,
            "decode_mamba_non_psi_ms_per_step": t_step - t_mm,
            "prefill_rows": rows, "prefill_mamba_block_ms": t_pre,
            "prefill_mamba_psi_ms": t_pre_mm,
            "prefill_mamba_non_psi_ms": t_pre - t_pre_mm,
            "prefill_scan_ms": t_scan,
            "prefill_peak_extra_bytes": peak,
            "scan_chunk_tensor_bytes": 4 * chunk * di * N,
            "prefill_forward_bytes_before": base}


def _xattn_split(torch, ex, pserver, rows=ARCH_PREFILL_ROWS):
    """whisper's cross attention and encoder, device time from CUDA-graph
    replays: per decode step (max_batch slots), the cross K/V projection
    of every slot's whole ``enc_out`` in each decoder layer (two PSI
    matmuls at max_batch x enc_frames rows a layer) and the whole cross
    half (norm_x, that projection, the cross attention read, wq and wo),
    summed over the layers; and a prefill's encoder (frames plus their
    sinusoidal table, the encoder stack, enc_norm_f) over one row of zero
    frames, against one ``rows``-token prefill forward of ``pserver``'s
    whole, timed the same way."""
    from repro_torch.models import attention, transformer
    cfg = ex.model.cfg
    xl = ex.params["layers"]
    L, B, dev, dt = len(xl), ex.max_batch, ex.device, ex.model.dtype
    g = torch.Generator(device=dev).manual_seed(7)
    enc = torch.randn(B, cfg.enc_frames, cfg.d_model, generator=g,
                      device=dev).to(dt)
    x = torch.randn(B, 1, cfg.d_model, generator=g, device=dev).to(dt)
    frames = torch.zeros(1, cfg.enc_frames, cfg.d_model, dtype=dt,
                         device=dev)
    toks = (torch.arange(rows, device=dev) % cfg.vocab_size)[None]
    model, params = ex.model, ex.params
    with torch.inference_mode():
        t_kv = _graph_ms(torch, lambda i: attention.project_enc_kv(
            xl[i]["xattn"], enc, cfg), L, iters=L, reps=3) * L
        t_cross = _graph_ms(torch, lambda i: transformer._cross(
            xl[i], x, cfg, enc), L, iters=L, reps=3) * L
        t_enc = _graph_ms(torch, lambda i: model._encode(params, frames), 1,
                          iters=3, reps=3)
        t_fwd = _graph_ms(torch, lambda i: model.forward(params, toks), 1,
                          iters=3, reps=3)
    return {"decoder_layers": L, "decode_slots": B,
            "cross_kv_rows": B * cfg.enc_frames,
            "cross_kv_ms_per_step": t_kv,
            "cross_half_ms_per_step": t_cross,
            "encoder_frames": cfg.enc_frames, "encoder_ms": t_enc,
            "prefill_rows": rows, "prefill_forward_ms": t_fwd,
            "encoder_share_of_prefill": t_enc / t_fwd}


def _tied_head_times(torch, ex):
    """The tied lm-head at the decode shape (max_batch rows), device time
    from CUDA-graph replays: through the head the executor built once, and
    with the (V, D) table transposed again on every call (before that
    head existed); the head's bytes; its logits equal the per-call
    transpose's bit for bit."""
    from repro_torch.quant import tied_logits
    emb, head = ex.params["embed"], ex.params["tied_head"]
    x = torch.randn(ex.max_batch, 1, ex.model.cfg.d_model,
                    device=ex.device).to(ex.model.dtype)
    with torch.inference_mode():
        check(torch.equal(tied_logits(emb, x, head=head),
                          tied_logits(emb, x)),
              "tied head: logits differ from the per-call transpose's")
        prebuilt = _graph_ms(torch, lambda i: tied_logits(emb, x, head=head),
                             1, iters=10, reps=3)
        per_call = _graph_ms(torch, lambda i: tied_logits(emb, x), 1,
                             iters=2, reps=3)
    return {"rows": ex.max_batch, "prebuilt_head_ms": prebuilt,
            "per_call_transpose_ms": per_call,
            "head_bytes": head.data.numel() * head.data.element_size()
            + head.scale.numel() * 4}


def _burst_window(torch, server, lens=(64, 72, 66, 80), calls=3):
    """One burst prefill forward of four prompts (buckets 64, 80, 80, 80)
    against the same four prefilled alone, one forward each: each row's
    first token and cache rows bit-identical to its prefill alone, and the
    wall and device time of both ways (ms per call: the burst's one
    forward, or all four alone)."""
    import numpy as np
    ex = server.executor
    rng = np.random.default_rng(4)
    buckets = [server._bucket_len(n) for n in lens]
    toks = np.zeros((len(lens), max(buckets)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, server.cfg.vocab_size, size=n)
    tl = np.asarray(lens, np.int32)
    first, burst = ex.prefill(toks, tl, row_lens=buckets)
    for i, sb in enumerate(buckets):
        alone_first, alone = ex.prefill(toks[i:i + 1, :sb], tl[i:i + 1])
        check(int(alone_first[0]) == int(first[i]),
              f"burst row {i}: first token {int(first[i])} != "
              f"{int(alone_first[0])} alone")
        for lb, la in zip(burst.kv, alone.kv):
            for k in la:
                check(torch.equal(lb[k][i, :sb], la[k][0, :sb]),
                      f"burst row {i}: cache {k} differs from its prefill "
                      f"alone")
    del burst, alone

    def alone_all():
        for i, sb in enumerate(buckets):
            ex.prefill(toks[i:i + 1, :sb], tl[i:i + 1])
    return {"prompts": list(lens), "buckets": buckets,
            "rows_bit_identical": True,
            "burst": _window(torch, lambda: ex.prefill(
                toks, tl, row_lens=buckets), 1, calls),
            "alone_x4": _window(torch, alone_all, 1, calls)}


def phase_serve_mesh(torch, dev, paged_server, args, cfg, paged_tokens,
                     launches, keep):
    """serve_psi8_mesh: the psi8 trace of phase_serve (qwen3-8b, all 36
    layers) through a Server on a (1, 1) ("data", "model") DeviceMesh of a
    world-1 NCCL process group (a FileStore in a temporary directory;
    NCCL cannot hold two ranks on one card), over the same params:
    continuous mode, tokens identical to phase 3's; slot_shards 1; the
    collectives it issued (the token all-gather of every step and
    admission) above 0; 253 PSI launches a forward and step and 36
    attention calls a step, added to the kernels line.  Prints the
    serve's macs_per_token, mfu and tokens_per_joule at the card's power
    limit, and the roofline terms of qwen3-8b's decode_32k cell on one
    H100 (``perf.roofline_model``)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.perf import roofline_model as roof
    from repro_torch.runtime import parallel
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "a process group is already up")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        server = serve.Server(cfg, paged_server.executor.params,
                              max_batch=args.max_batch,
                              max_seq=paged_server.max_seq,
                              eos_id=args.eos_id, device=dev, mesh=mesh)
        ex = server.executor
        check(ex.mesh_size == 1 and ex.n_slot_shards == 1
              and ex.local_batch == args.max_batch,
              "serve_psi8_mesh: not the (1, 1) mesh's whole batch")
        server.warmup(serve.trace_from_args(args, cfg))
        ops.reset_launch_counts()                     # the main path starts
        parallel.reset_collective_counts()
        done, st = server.serve(serve.trace_from_args(args, cfg),
                                continuous=True, warmup=False)
        torch.cuda.synchronize()
        got = ops.launch_counts()                     # ... and ends here
        colls = parallel.collective_counts()
        toks = {r.rid: r.tokens for r in done}
        check(toks == paged_tokens, "serve_psi8_mesh: tokens differ from "
                                    "serve_psi8's")
        check(st["slot_shards"] == 1, f"serve_psi8_mesh: slot_shards "
                                      f"{st['slot_shards']}")
        check(sum(colls.values()) > 0 and colls["all_gather"]
              >= st["decode_steps"],
              f"serve_psi8_mesh: collectives {colls} for "
              f"{st['decode_steps']} decode steps")
        check(st["decode_compiles"] == 1, "serve_psi8_mesh: want one "
                                          "decode graph")
        check(st["blocks_free_end"] == st["n_blocks"],
              "serve_psi8_mesh: blocks leaked")
        per_fwd, per_step = counts_per_step(cfg)
        want = {"psi_matmul_codes": matmul_launches(
                    cfg, st["decode_steps"], st["prefill_forwards"]),
                "psi_matmul_packed": 0,
                "paged_attention": per_step * st["decode_steps"]}
        check(got == want, f"serve_psi8_mesh launch counts {got} != {want}")
        for k in ("psi_matmul_codes", "paged_attention"):
            launches[k] = launches.get(k, 0) + got[k]
        check(st["mfu"] > 0 and st["macs_per_token"] > 0
              and st["watts"] > 0 and st["tokens_per_joule"] > 0,
              f"serve_psi8_mesh: roofline stats {st['mfu']} "
              f"{st['macs_per_token']} {st['tokens_per_joule']}")
        # the mesh's cost: the plain and the mesh Server serve the trace in
        # alternating pairs (plain, mesh, then mesh, plain, ...), tok/s
        # and tokens read from each serve's stats
        tps = {"plain": [], "mesh": []}
        for i in range(MESH_PAIRS):
            for which in (("plain", "mesh") if i % 2 == 0
                          else ("mesh", "plain")):
                srv = paged_server if which == "plain" else server
                d2, s2 = srv.serve(serve.trace_from_args(args, cfg),
                                   continuous=True, warmup=False)
                check({r.rid: r.tokens for r in d2} == paged_tokens,
                      f"serve_psi8_mesh: a {which} repeat changed tokens")
                tps[which].append(s2["tok_per_s"])
        ratios = [m / p for p, m in zip(tps["plain"], tps["mesh"])]
        pairs = {"n": MESH_PAIRS, "order": "plain,mesh | mesh,plain | ...",
                 "tok_per_s": tps,
                 "median": {k: statistics.median(v) for k, v in tps.items()},
                 "quartiles": {k: statistics.quantiles(v, n=4)
                               for k, v in tps.items()},
                 "min": {k: min(v) for k, v in tps.items()},
                 "max": {k: max(v) for k, v in tps.items()},
                 "mesh_over_plain": ratios,
                 "mesh_over_plain_median": statistics.median(ratios)}
        cell = roof.analytic_cell("qwen3-8b", "decode_32k", "psi8", chips=1,
                                  mesh_model=1)
        terms = roof.roofline_terms(cell, chips=1)
        emit({"phase": "serve_psi8_mesh", "mesh": [1, 1],
              "backend": str(dist.get_backend()),
              "continuous": {k: st[k] for k in keep if k in st},
              "tokens_identical_to_serve_psi8": True,
              "slot_shards": st["slot_shards"], "collectives": colls,
              "launches": got,
              "macs_per_token": st["macs_per_token"], "mfu": st["mfu"],
              "watts": st["watts"],
              "tokens_per_joule": st["tokens_per_joule"],
              "alternating_pairs": pairs,
              "roofline_decode_32k_1xH100": {
                  "peak_flops": roof.PEAK_FLOPS, "hbm_bw": roof.HBM_BW,
                  "link_bw": roof.LINK_BW, "flops": cell.flops,
                  "hbm_bytes": cell.hbm_bytes, **terms},
              "phase_wall_s": time.perf_counter() - t_phase})
        del server, ex
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)


def phase_serve_dense(torch, dev, paged_server, args, cfg, paged_done,
                      launches, keep, paged_window):
    """The psi8 trace of phase_serve (qwen3-8b, all 36 layers, bf16) on
    the dense layout (--cache-layout dense: one slab of max_seq = 112
    positions a slot and layer, plain reads, no block table), on the same
    params: continuous and static at horizon 1, then continuous at
    horizon 8.  Tokens identical across the three, and identical to phase
    3's paged tokens or diverging only under the token rule (kernel 3 and
    the plain read round differently); 253 PSI launches per forward and
    decode step, none of kernel 3; one decode graph, one round graph; one
    prefill forward per admission event.  Then the decode window (eager,
    graph, horizon-8 round) and the plain read alone at the step's shape
    (CUDA-graph replays over slab copies that stream from HBM)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    dcfg = dataclasses.replace(cfg, cache_layout="dense")
    params = paged_server.executor.params
    servers = {h: serve.Server(dcfg, params, max_batch=args.max_batch,
                               max_seq=paged_server.max_seq,
                               eos_id=args.eos_id, device=dev,
                               decode_horizon=h) for h in (1, HORIZON)}
    ex = servers[1].executor
    check(not servers[1].paged and ex.max_seq == 112,
          f"serve_psi8_dense: want a dense server at max_seq 112, got "
          f"paged={servers[1].paged} max_seq={ex.max_seq}")
    trace = lambda: serve.trace_from_args(args, cfg)
    per_fwd, per_step = counts_per_step(cfg)
    runs, report = {}, {}
    for horizon, modes in ((1, ("continuous", "static")),
                           (HORIZON, ("continuous",))):
        server = servers[horizon]
        server.warmup(trace())
        rows, undo_rows = _record_prefill_rows(server.executor)
        ops.reset_launch_counts()                     # the main path starts
        out, admitted = {}, {}
        try:
            for mode in modes:
                admitted[mode], undo_admits = _admissions(server)
                try:
                    done, stats = server.serve(
                        trace(), continuous=(mode == "continuous"),
                        warmup=False)
                finally:
                    undo_admits()
                out[mode] = (done, stats)
        finally:
            undo_rows()
        torch.cuda.synchronize()
        got = ops.launch_counts()                     # ... and ends here
        label = f"horizon_{horizon}"
        report[f"{label}_prefill_rows_held_here"] = _check_prefill_rows(
            torch, rows, f"serve_psi8_dense {label}", params)
        _check_bursts(f"serve_psi8_dense {label}",
                      {m: out[m][1] for m in out}, admitted)
        steps = sum(st["decode_steps"] for _, st in out.values())
        fwd = sum(st["prefill_forwards"] for _, st in out.values())
        want = {"psi_matmul_codes": per_fwd * (steps + fwd),
                "psi_matmul_packed": 0, "paged_attention": 0}
        check(got == want, f"serve_psi8_dense {label} launch counts {got} "
                           f"!= expected {want} ({per_fwd} per forward and "
                           f"step, no paged attention)")
        check(server.executor.graph_counts() == {
            "decode": int(horizon == 1), "decode_multi": int(horizon > 1),
            "draft": 0, "verify": 0},
            f"serve_psi8_dense {label}: graphs "
            f"{server.executor.graph_counts()}")
        for mode, (done, st) in out.items():
            check(st["cache_layout"] == "dense" and st["decode_compiles"] == 1
                  and all(len(r.tokens) == r.max_new for r in done),
                  f"serve_psi8_dense {label} {mode}: layout "
                  f"{st['cache_layout']}, {st['decode_compiles']} graphs, "
                  f"or a request short of its max_new")
            runs[(horizon, mode)] = done
            report[f"{label}_{mode}"] = dict(
                {k: st[k] for k in keep if k in st}, admissions=admitted[mode],
                **({"decode_rounds": st["decode_rounds"]} if horizon > 1
                   else {}))
        for k in got:
            launches[k] = launches.get(k, 0) + got[k]
        report[f"{label}_launches"] = got
    toks = {key: {r.rid: r.tokens for r in done}
            for key, done in runs.items()}
    base = toks[(1, "continuous")]
    check(all(t == base for t in toks.values()),
          f"serve_psi8_dense: tokens differ across modes and horizons "
          f"{sorted(k for k, t in toks.items() if t != base)}")
    rule = _token_rule(torch, (paged_server, servers[1]), paged_done,
                       runs[(1, "continuous")], ([], []),
                       "serve_psi8_dense vs paged")
    window = _decode_window(torch, servers[1], servers[HORIZON])
    read = _dense_read(torch, dcfg, ex)
    dense_dev = window["graph"].get("device_ms_per_step")
    paged_dev = paged_window["graph"].get("device_ms_per_step")
    emit({"phase": "serve_psi8_dense", "layers": cfg.n_layers,
          "cache_layout": "dense", "max_seq": ex.max_seq,
          "slab_bytes": sum(t.numel() * t.element_size()
                            for layer in ex.init_cache().kv
                            for t in layer.values()),
          "runs": report, "tokens_identical_across_runs": True,
          "tokens_vs_paged": "identical" if not rule else rule,
          "margin_factor": MARGIN_FACTOR,
          "decode_window": window, "dense_read": read,
          "paged_attention_ms_per_step_paged_graph": paged_window[
              "graph"].get("paged_attn_ms_per_step", "not measured"),
          "graph_step_device_ms_dense_minus_paged": (
              dense_dev - paged_dev
              if isinstance(dense_dev, float) and isinstance(paged_dev, float)
              else "not measured"),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "phase_wall_s": time.perf_counter() - t_phase})
    del servers, ex, runs


def _dense_read(torch, cfg, ex, n_pos=72):
    """The dense decode read alone (``attention.sdpa`` over one layer's
    slab: all slots at position ``n_pos``, the slab's max_seq keys masked
    by k_pos) at the serve's shape, bf16: device ms a layer from CUDA-graph
    replays over slab copies that stream from HBM, times the depth for a
    step, against the bytes bound of reading K and V (each slab entry
    once) over the card's memory rate."""
    from repro_torch.models import attention
    B, C = ex.max_batch, ex.max_seq
    hq, hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, 1, hq, D), generator=g, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((2, B, C, hkv, D), generator=g, device="cuda").to(
        torch.bfloat16)
    k_pos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    k_pos[:, :n_pos + 1] = torch.arange(n_pos + 1, device="cuda")
    pos = torch.full((B, 1), n_pos, dtype=torch.int32, device="cuda")
    copies = _copies(kv, kv.numel() * kv.element_size())
    layer_ms = _graph_ms(torch, lambda i: attention.sdpa(
        q, copies[i][0], copies[i][1], pos, k_pos, causal=True),
        len(copies), iters=len(copies))
    slab = kv.numel() * kv.element_size()
    bw = card_rates(torch.cuda.get_device_name(0))[0]
    return {"slots": B, "slab_len": C, "position": n_pos,
            "device_ms_per_layer": layer_ms,
            "device_ms_per_step": layer_ms * cfg.n_layers,
            "bound_ms_per_step": slab * cfg.n_layers / bw * 1e3}


def phase_serve_horizon(torch, server, args, cfg, want_tokens, launches,
                        keep, name="serve_psi8_horizon",
                        modes=("continuous", "static")):
    """The trace of phase_serve served at horizon 8 (in ``modes``) on a
    server whose warmup captured its round graph: tokens identical to
    horizon 1, the config's matmul launches per forward (253 for
    qwen3-8b) and attention launches per decode step (36) under replay
    (decode_steps = 8 x rounds), one captured decode graph."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()                         # the main path starts
    runs = {}
    for mode in modes:
        done, stats = server.serve(serve.trace_from_args(args, cfg),
                                   continuous=(mode == "continuous"),
                                   warmup=False)
        runs[mode] = ({r.rid: r.tokens for r in done}, stats)
    torch.cuda.synchronize()
    got = ops.launch_counts()                         # ... and ends here
    check(all(t == want_tokens for t, _ in runs.values()),
          f"{name}: tokens differ from horizon 1")
    stats = [st for _, st in runs.values()]
    steps = sum(st["decode_steps"] for st in stats)
    rounds = sum(st["decode_rounds"] for st in stats)
    fwd = sum(st["prefill_forwards"] for st in stats)
    check(steps == HORIZON * rounds, "decode steps != horizon x rounds")
    per_fwd, per_step = counts_per_step(cfg)
    want = {"psi_matmul_codes": matmul_launches(cfg, steps, fwd),
            "psi_matmul_packed": 0, "paged_attention": per_step * steps}
    check(got == want, f"horizon {HORIZON} launch counts {got} != expected "
                       f"{want} ({per_fwd} per forward, {per_step} "
                       f"attention per step)")
    check(all(st["decode_compiles"] == 1 for st in stats)
          and server.executor.graph_counts() == {
              "decode": 0, "decode_multi": 1, "draft": 0, "verify": 0},
          f"{name}: want exactly one captured round graph, got "
          f"{server.executor.graph_counts()}")
    for k in got:
        launches[k] = launches.get(k, 0) + got[k]
    emit({"phase": name, "decode_horizon": HORIZON,
          "layers": cfg.n_layers, "requests": args.requests,
          **{mode: {k: st[k] for k in keep + ("decode_rounds", "loop_iters")
                    if k in st}
             for mode, (_, st) in runs.items()},
          "tokens_identical_to_horizon_1": True, "launches": got})


def phase_serve_spec(torch, dev, launches):
    """Self-speculative serving of full-width qwen3-8b (36 layers, bf16,
    seed 0) at psi5 with --qat-precondition 3: the same trace (8 requests,
    prompts 64 +- 8, 16-32 new tokens, 4 slots, 16-position blocks) served
    plain and with --speculative SPEC_BITS:SPEC_K (built by build_server,
    the CLI's path; the plain server shares its params and max_seq),
    continuous then static.

    Checks: every spec run's tokens equal the plain run's of its mode, or
    differ only under the token rule (:func:`_token_rule`, each run
    replayed: decode steps for the plain one, the logged verify windows
    for the speculative one); plain continuous equals static; exactly one
    draft and one verify graph and no plain decode graph; launch counts
    exact (a round is k draft steps and one verify: 253 (k + 1)
    psi_matmul_packed and 36 (k + 1) paged-attention calls, plus 253 a
    prefill forward); no leaked block; mean accepted drafts above 0.
    Then a profiled window: one draft graph, one verify graph and one plain
    psi5 decode step (4 slots at 72 positions)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    args = _serve_args(quant="psi5", qat_precondition=3, max_new=32,
                       min_new=16, speculative=f"{SPEC_BITS}:{SPEC_K}")
    t0 = time.perf_counter()
    spec_server, cfg = serve.build_server(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check_full(cfg, MAIN_ARCH)
    per_fwd, per_step = counts_per_step(cfg)
    ex = spec_server.executor
    check(spec_server.spec == (SPEC_BITS, SPEC_K)
          and ex.draft_params["layers"][0]["attn"]["wq"].fmt.bits == SPEC_BITS
          and ex.draft_params["lm_head"].packed,
          "the speculative server has no packed psi3 draft")
    plain_server = serve.Server(cfg, ex.params, max_batch=args.max_batch,
                                max_seq=spec_server.max_seq,
                                eos_id=args.eos_id, device=dev)
    trace = lambda: serve.trace_from_args(args, cfg)
    keep = ("tok_per_s", "wall_s", "tokens", "p50_latency_s",
            "p99_latency_s", "p50_ttft_s", "p50_itl_s", "p99_itl_s",
            "decode_steps", "prefill_forwards", "host_syncs",
            "host_syncs_per_token", "accepted_per_step", "draft_overhead_s",
            "blocks_free_end", "n_blocks", "macs_per_token", "mfu", "watts",
            "tokens_per_joule")
    runs = {}
    for label, server in (("plain", plain_server), ("spec", spec_server)):
        server.warmup(trace())
        out, rows = {}, []
        ops.reset_launch_counts()                     # the main path starts
        for mode in ("continuous", "static"):
            log, undo = _fill_log(server, serve)
            got_rows, undo_rows = _record_prefill_rows(server.executor)
            try:
                done, stats = server.serve(trace(),
                                           continuous=(mode == "continuous"),
                                           warmup=False)
            finally:
                undo_rows()
                undo()
            out[mode] = (done, stats, log)
            rows += got_rows
        torch.cuda.synchronize()
        got = ops.launch_counts()                     # ... and ends here
        held = _check_prefill_rows(torch, rows, f"{label} psi5 spec phase",
                                   server.executor.params)
        steps = sum(out[m][1]["decode_steps"] for m in out)
        fwd = sum(out[m][1]["prefill_forwards"] for m in out)
        per = SPEC_K + 1 if label == "spec" else 1
        want = {"psi_matmul_codes": 0,
                "psi_matmul_packed": per_fwd * (per * steps + fwd),
                "paged_attention": per_step * per * steps}
        check(got == want, f"{label} psi5: launch counts {got} != expected "
                           f"{want} (a {'round' if per > 1 else 'step'} is "
                           f"{per} decode-shaped passes of {per_fwd} "
                           f"matmuls and {per_step} attention calls; "
                           f"{per_fwd} a prefill)")
        for mode, (done, stats, _) in out.items():
            leaked = stats["n_blocks"] - stats["blocks_free_end"]
            check(not leaked, f"{label} {mode}: {leaked} blocks leaked")
            check(all(len(r.tokens) == r.max_new for r in done)
                  and all(0 <= t < cfg.vocab_size for r in done
                          for t in r.tokens),
                  f"{label} {mode}: a request's tokens are short or out of "
                  f"the vocabulary")
            if label == "spec":
                sp = stats["speculative"]
                check(sp["spec_compiles"] == {"draft": 1, "verify": 1,
                                              "decode": 0},
                      f"spec {mode}: graph counts {sp['spec_compiles']}, "
                      f"want one draft and one verify graph, no decode graph")
                check(sp["mean_accepted"] > 0,
                      f"spec {mode}: no draft token was accepted")
            else:
                check(stats["decode_compiles"] == 1,
                      f"plain {mode}: want one captured decode graph")
        for k in got:
            launches[k] = launches.get(k, 0) + got[k]
        runs[label] = (out, got, held)
    plain_out, spec_out = runs["plain"][0], runs["spec"][0]
    check({r.rid: r.tokens for r in plain_out["continuous"][0]}
          == {r.rid: r.tokens for r in plain_out["static"][0]},
          "plain psi5: continuous and static modes emitted different tokens")
    rules = {}
    for mode in ("continuous", "static"):
        rules[mode] = _token_rule(
            torch, (plain_server, spec_server), plain_out[mode][0],
            spec_out[mode][0], (plain_out[mode][2], spec_out[mode][2]),
            f"spec {mode} vs plain")
    window = _spec_window(torch, spec_server, plain_server)
    report = {}
    for label, (out, got, _) in runs.items():
        report[label] = {m: {k: out[m][1][k] for k in keep} for m in out}
        report[label]["launches"] = got
        report[label]["prefill_rows_held_here"] = runs[label][2]
    for m, (_, stats, _) in spec_out.items():
        report["spec"][m].update(stats["speculative"])
    emit({"phase": "serve_psi5_spec", "layers": cfg.n_layers,
          "draft_bits": SPEC_BITS, "k": SPEC_K, "qat_precondition": 3,
          "requests": args.requests, "max_batch": args.max_batch,
          "prompt_len": f"{args.prompt_len}+-{args.prompt_jitter}",
          "max_new": f"{args.min_new}-{args.max_new}",
          "max_seq": spec_server.max_seq, "init_quantize_draft_s": init_s,
          "param_bytes": _param_bytes(ex.params),
          "draft_param_bytes": _param_bytes(ex.draft_params),
          "runs": report,
          "tokens_vs_plain": {m: "identical" if not r else r
                              for m, r in rules.items()},
          "margin_factor": MARGIN_FACTOR, "window": window,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "phase_wall_s": time.perf_counter() - t_phase})
    del spec_server, plain_server, ex, runs, plain_out, spec_out
    torch.cuda.empty_cache()


def _spec_window(torch, spec_server, plain_server, calls=5):
    """Wall and device time, by kernel, of one draft graph (SPEC_K draft
    steps), one verify graph and one plain decode step (graph), all slots
    active at 72 positions over a full table."""
    import numpy as np
    ex, pex = spec_server.executor, plain_server.executor
    B = spec_server.max_batch
    table = np.arange(B * ex.n_bt, dtype=np.int32).reshape(B, ex.n_bt)
    tok = np.arange(B, dtype=np.int32)[:, None]
    pos = np.full((B, 1), 72, np.int32)
    act = np.ones((B,), bool)
    cache, pcache = ex.init_cache(), pex.init_cache()
    drafts, _ = ex.draft(tok, pos, act, cache, table)
    return {
        "draft_graph": _window(torch, lambda: ex.draft(
            tok, pos, act, cache, table), 1, calls),
        "verify_graph": _window(torch, lambda: ex.verify(
            tok, drafts, pos, act, cache, table), 1, calls),
        "plain_step_graph": _window(torch, lambda: pex.decode(
            tok, pos, act, pcache, table), 1, calls)}


def _record_prefill_rows(ex):
    """Wrap ``ex.prefill`` (which ``prefill_insert`` calls too) to record
    the rows of each prefill forward, a burst's B x Sb included (the M of
    all its matmuls, the lm-head's included); returns (rows, undo)."""
    rows = []
    prefill = ex.prefill

    def recorded(tokens, *a, **kw):
        rows.append(int(tokens.shape[0]) * int(tokens.shape[1]))
        return prefill(tokens, *a, **kw)

    ex.prefill = recorded

    def undo():
        del ex.prefill
    return rows, undo


def _admissions(server):
    """Wrap ``server._prefill_admits`` to record each admission event (the
    requests one loop iteration admitted: one prefill forward for the
    burst, unless it falls back to one by one) as its prompt lengths;
    returns (events, undo)."""
    sizes = []
    admit = server._prefill_admits
    depth = [0]

    def logged(cache, admits, *a, **kw):
        if not depth[0]:
            sizes.append([len(r.prompt) for _, r in admits])
        depth[0] += 1
        try:
            return admit(cache, admits, *a, **kw)
        finally:
            depth[0] -= 1

    server._prefill_admits = logged

    def undo():
        del server._prefill_admits
    return sizes, undo


def _check_prefill_rows(torch, rows, label, params, checked=PREFILL_MS):
    """Every prefill row count a serve ran is one where kernels 1 and 2
    were held against their plain versions: phase_kernels held them at
    ``checked`` (PREFILL_MS at qwen3-8b's shapes, ARCH_MS at the other
    configs'); a burst's B x Sb rows past those (they follow the
    admissions' timing), and the recurrent configs' exact prompt lengths,
    are held here on the served weights (the PSI matrices of the first
    layer of each kind: attention, cross attention, rec, mamba and MLP;
    the lm-head or the tied head), in the dtype the prefill runs them in
    (bf16, within one bf16 ulp of the output; the SSM's x_proj and
    dt_proj_w f32, within 1e-5 relative).  Whisper's encoder and cross
    K/V rows (B x 1500) are the kernel phase's (_extra_ms).  Returns
    {rows: max abs err} of the rows held here."""
    from repro_torch.core.psi import QuantizedTensor
    from repro_torch.kernels import ops, ref
    new = sorted(set(rows) - set(checked))
    f32 = ("x_proj", "dt_proj_w")           # the SSM's f32 prefill route
    firsts = {}
    for p in params["layers"]:
        for sub, leaf in p.items():
            # an MoE layer's experts are dequantized blocks, no PSI matmul
            if sub != "moe" and isinstance(leaf, dict):
                firsts.setdefault(sub, leaf)
    leaves = [(qt, torch.float32 if n in f32 else torch.bfloat16)
              for sub in sorted(firsts)
              for n, qt in sorted(firsts[sub].items())
              if isinstance(qt, QuantizedTensor)]
    leaves += [(params[n], torch.bfloat16) for n in ("lm_head", "tied_head")
               if n in params]
    dev = leaves[0][0].data.device
    gen = torch.Generator(device=dev).manual_seed(len(rows))
    held = {}
    for M in new:
        worst = 0.0
        for qt, dtype in leaves:
            if qt.packed:
                plain = lambda x, q=qt: ref.psi_matmul_packed_ref(
                    x, q.data, q.scale, q.fmt.bits)
            else:
                plain = lambda x, q=qt: ref.psi_matmul_codes_ref(
                    x, q.data, q.scale)
            err, ratio = _gemm_errors(torch, ops, ref, qt, plain, (M,),
                                      dtype, gen, dev)
            check(ratio <= 1.0, f"{label}: a PSI kernel at a prefill's {M} "
                                f"rows ({dtype}) is {err} off its plain "
                                f"version (over its tolerance)")
            worst = max(worst, err)
        held[M] = worst
    return held


def _fill_log(server, serve_mod):
    """Record each fill of ``server`` (rid, pos0, len(full_seq)), each
    burst admission (its size; then a whole-prompt fill of each of its
    requests, "bfill"), each preemption (rid, covered) and, on a
    speculative server, each round of each active request (rid, its feed
    position) for the chunk and forward counts that :func:`_fills_expect`
    works out and for the replays of :func:`_token_rule`; returns (log,
    undo)."""
    log = []
    bs = server.block_size
    begin = server._begin_fill
    spec_round = server._spec_round

    def logged_round(sched, cache, tok, pos, act, bt, now_fn):
        for slot, req in sched.running.items():
            if act[slot]:
                log.append(("round", req.rid, int(pos[slot, 0])))
        return spec_round(sched, cache, tok, pos, act, bt, now_fn)

    def logged_begin(cache, slot, req, sched, bt, chunking):
        log.append(("fill", req.rid, len(req.prefix_blocks) * bs,
                    len(req.full_seq)))
        return begin(cache, slot, req, sched, bt, chunking)

    class LoggedScheduler(serve_mod.Scheduler):
        def preempt(self, slot, now, covered=None):
            log.append(("cut", self.running[slot].rid, covered))
            return super().preempt(slot, now, covered=covered)

    admit = server._prefill_admits

    def logged_admits(cache, admits, *a, **kw):
        if not server._ctx_serving:
            # one forward for the admission event, whole prompts from 0
            log.append(("burst", -1, len(admits)))
            log.extend(("bfill", req.rid, 0, len(req.full_seq))
                       for _, req in admits)
        return admit(cache, admits, *a, **kw)

    server._begin_fill = logged_begin
    server._spec_round = logged_round
    server._prefill_admits = logged_admits
    plain = serve_mod.Scheduler
    serve_mod.Scheduler = LoggedScheduler

    def undo():
        serve_mod.Scheduler = plain
        del server._begin_fill, server._spec_round, server._prefill_admits
    return log, undo


def _fills_expect(log, chunk):
    """(prefill forwards, of them without the lm-head, chunk pieces) that
    the logged fills must have run.  A fill longer than one chunk runs
    ceil((L - pos0) / chunk) pieces, the last with the lm-head, unless a
    preemption cut it while chunking (covered < L): then it ran (covered -
    pos0) / chunk pieces, none with the head.  A shorter fill is one
    forward with the head and no chunk; a burst admission (outside context
    serving) is one forward for all its requests."""
    fwd = headless = chunks = 0
    open_fill = {}
    for ev in log:
        if ev[0] == "burst":
            fwd += 1
        elif ev[0] == "fill":
            _, rid, pos0, L = ev
            open_fill[rid] = (pos0, L)
            if not (chunk and L - pos0 > chunk):
                fwd += 1
                continue
            n = -(-(L - pos0) // chunk)
            fwd, headless, chunks = fwd + n, headless + n - 1, chunks + n
        elif ev[0] == "cut":
            _, rid, covered = ev
            pos0, L = open_fill[rid]
            if chunk and L - pos0 > chunk and covered < L:
                # cut while chunking: take back the pieces it never ran
                n = -(-(L - pos0) // chunk)
                ran = (covered - pos0) // chunk
                fwd -= n - ran
                headless -= n - 1 - ran
                chunks -= n - ran
    return fwd, headless, chunks


def _replay(torch, server, seq, P, events, last):
    """One request's computation in a served run, replayed on the model
    alone and teacher-forced on ``seq`` (its prompt and baseline tokens):
    each fill as the server ran it (pieces of ``prefill_chunk``, the last
    bucketed, over the context KV already in the pool; a fill cut by a
    preemption stops at the KV it covered) and a decode step for every
    other row, or, for a speculative run, a verify of the k-token window
    from each round's feed position (its rows hold the teacher-forced
    tokens up to ``last``; later ones cannot reach those rows).  Returns
    {absolute row: logits} up to row ``last``; row r predicts the token at
    r + 1.  ``events``: ("fill", pos0, L), ("cut", covered) and ("round",
    pos) in run order.  A dense server's run is replayed on a dense slab
    (whole-prompt fills and decode steps only: no context serving or
    speculation there)."""
    from repro_torch.models.kvcache import KVCache
    ex = server.executor
    model, params, dev = ex.model, ex.params, ex.device
    bs, chunk = server.block_size, server.prefill_chunk
    if server.paged:
        cache = model.init_cache(1, ex.n_bt * bs, device=dev,
                                 n_blocks=ex.n_bt, layout="paged")
        table = torch.arange(ex.n_bt, dtype=torch.int64, device=dev)
    else:
        cache = model.init_cache(1, server.max_seq, device=dev,
                                 layout="dense")
        table = None
    x = torch.as_tensor(seq, device=dev)
    rows = {}

    def forward(cur, end, record=True):
        """Prefill seq[cur:end] as the server's pieces, over [0, cur)."""
        if not server.paged:
            check(cur == 0 and not chunk, "a dense replay has no context")
            n = server._bucket_len(end)
            toks = torch.zeros((1, n), dtype=torch.int32, device=dev)
            toks[0, :end] = x[:end]
            logits, _ = model.forward(params, toks)
            _, seq_cache = model.prefill(
                params, toks, cache_len=server.max_seq,
                true_lens=torch.tensor([end], device=dev))
            model.insert_cache(cache, seq_cache, 0)
            if record:
                for i in range(end):
                    rows[i] = logits[0, i]
            return
        while cur < end:
            rem = end - cur
            final = not (chunk and rem > chunk)
            n = server._bucket_len(rem) if final else chunk
            take = rem if final else n
            toks = torch.zeros((1, n), dtype=torch.int32, device=dev)
            toks[0, :take] = x[cur:cur + take]
            ctx = (model.gather_prefix_ctx(cache, table[:cur // bs])
                   if cur else None)
            logits, states = model.forward(params, toks, pos0=cur,
                                           ctx_kv=ctx)
            model.insert_cache(cache, KVCache([{"k": st["k"], "v": st["v"]}
                                               for st in states]),
                               0, table[cur // bs:])
            if record:
                for i in range(take):
                    rows[cur + i] = logits[0, i]
            cur += take

    with torch.inference_mode():
        if events[0][1]:            # a prefix hit: KV another request wrote
            forward(0, events[0][1], record=False)
        row, ei = P - 1, 0
        while row <= last:
            ev = events[ei] if ei < len(events) else None
            if ev and ev[0] == "cut":
                ei += 1                 # a decode victim: its restore follows
            elif ev and ev[0] == "round":
                p0, k = ev[1], server.spec_k
                window = torch.zeros((1, k), dtype=torch.int32, device=dev)
                take = min(k, len(seq) - p0)
                window[0, :take] = x[p0:p0 + take]
                logits, _ = model.verify_step(params, {
                    "tokens": window,
                    "pos0": torch.tensor([[p0]], dtype=torch.int32,
                                         device=dev),
                    "active": torch.ones((1,), dtype=torch.bool, device=dev),
                    "block_table": table[None].to(torch.int32)}, cache)
                for i in range(k):
                    rows[p0 + i] = logits[0, i]
                ei += 1
                nxt = events[ei] if ei < len(events) else None
                row = nxt[1] if nxt and nxt[0] == "round" else p0 + k
            elif ev and ev[2] == row + 1:
                end = ev[2]
                nxt = events[ei + 1] if ei + 1 < len(events) else None
                cut = nxt and nxt[0] == "cut" and nxt[1] < ev[2]
                if cut:
                    end = nxt[1]        # cut while chunking: [pos0, covered)
                forward(ev[1], end)
                ei += 2 if cut else 1
                if not cut:
                    row += 1
            else:
                batch = {"token": x[row].view(1, 1).to(torch.int32),
                         "pos": torch.tensor([[row]], dtype=torch.int32,
                                             device=dev),
                         "active": torch.ones((1,), dtype=torch.bool,
                                              device=dev)}
                if table is not None:
                    batch["block_table"] = table[None].to(torch.int32)
                logits, _ = model.decode_step(params, batch, cache)
                rows[row] = logits[0]
                row += 1
    return rows


def _token_rule(torch, servers, base, other, logs, label):
    """Tokens of run ``other`` against the baseline run ``base`` (finished
    requests of one trace; ``servers`` and ``logs`` their servers and fill
    logs).  Identical passes.  Otherwise each request that differs is
    replayed both ways (:func:`_replay`) up to its first differing token
    j: the baseline's top-2 logit margin at the row predicting j must be
    below MARGIN_FACTOR x the largest logit difference of the two replays
    on the rows before it, or 0 (an exact tie: the top two logits are
    equal and argmax takes the lower index, so any difference in the
    row's rounding flips it, even where the rows before it agree, as a
    first decode step after a shared prefill does), and each replay must
    pick its own run's token there.  Returns the divergences found."""
    import numpy as np
    got = {r.rid: r.tokens for r in other}
    out = []
    for r in sorted(base, key=lambda r: r.rid):
        mine = got[r.rid]
        check(len(mine) == len(r.tokens), f"{label}: request {r.rid} emitted "
                                          f"{len(mine)} tokens, baseline "
                                          f"{len(r.tokens)}")
        j = next((i for i, (a, b) in enumerate(zip(r.tokens, mine))
                  if a != b), None)
        if j is None:
            continue
        P = len(r.prompt)
        seq = np.concatenate([r.prompt, np.asarray(r.tokens[:j], np.int32)])
        last = P - 1 + j
        reps = []
        for server, log in zip(servers, logs):
            events = [ev[0:1] + ev[2:] for ev in log if ev[1] == r.rid]
            reps.append(_replay(torch, server, seq, P,
                                events or [("fill", 0, P)], last))
        a, b = reps
        before = [k for k in a if k in b and k < last]
        delta = max((float((a[k].float() - b[k].float()).abs().max())
                     for k in before), default=0.0)
        top2 = torch.topk(a[last].float(), 2)
        margin = float(top2.values[0] - top2.values[1])
        picked = [int(a[last].argmax()), int(b[last].argmax())]
        out.append({"rid": r.rid, "token": j, "baseline": r.tokens[j],
                    "other": mine[j], "margin": margin,
                    "max_logit_diff_before": delta, "rows_before": len(before),
                    "bound": MARGIN_FACTOR * delta,
                    "replayed_argmax": picked})
        check(picked == [int(r.tokens[j]), int(mine[j])],
              f"{label}: request {r.rid} diverged at token {j} "
              f"({r.tokens[j]} vs {mine[j]}), but the replays of the two "
              f"runs pick {picked}: the divergence does not come from the "
              f"computation the replays model")
        check(margin < MARGIN_FACTOR * delta or margin == 0.0,
              f"{label}: request {r.rid} diverged at token {j} where the "
              f"baseline's top-2 margin {margin} is not below "
              f"{MARGIN_FACTOR} x {delta} (the largest logit difference of "
              f"the two runs' replays before it)")
        del reps, a, b
    return out


def phase_serve_ctx(torch, dev, launches):
    """Context serving on full-width qwen3-8b psi8 (all 36 layers, 4
    slots, 16-position blocks), four continuous runs:

      (a) a shared-prefix trace (a 256-token prefix, 32 +- 8-token tails,
          8 requests, 8-16 new tokens), prefix cache off;
      (b) the same with the prefix cache on;
      (c) a bursty heavy-tail trace (12 requests in bursts of 4, long
          448-token prompts with 24 new tokens, short 32 with 8) under FIFO
          on a pool of CTX_CACHE_BLOCKS;
      (d) the same trace and pool under --slo default@reserve=0.1 with
          --prefill-chunk 128 at horizon 4.

    Checks: (b) reuses prefix tokens and prefills exactly that many fewer
    than (a); (d) preempts, and its chunk pieces and forwards are those
    its fills work out to; every run leaks no block, captures one decode
    graph and launches exactly 253 matmuls per forward (252 for a chunk
    that skips the lm-head) and 36 attention reads per decode step; (b)
    against (a) and (d) against (c) under the token rule
    (:func:`_token_rule`)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.slo import bursty_heavy_tail_trace
    t_phase = time.perf_counter()
    args = _serve_args(prompt_len=32, prompt_jitter=8, shared_prefix_len=256,
                       max_new=16, min_new=8, prefix_cache="off")
    server_a, cfg = serve.build_server(args)
    check_full(cfg, MAIN_ARCH)
    per_fwd, per_step = counts_per_step(cfg)
    params = server_a.executor.params
    cfg_on = dataclasses.replace(cfg, prefix_cache=True)
    server_b = serve.Server(cfg_on, params, max_batch=args.max_batch,
                            max_seq=server_a.max_seq, device=dev)
    bursty = lambda: bursty_heavy_tail_trace(
        12, vocab_size=cfg.vocab_size, seed=CTX_SEED, burst_size=4,
        long_prompt=448, short_prompt=32, long_new=24, short_new=8)
    long_seq = CTX_LONG_SEQ                              # as build_server
    server_c = serve.Server(cfg, params, max_batch=args.max_batch,
                            max_seq=long_seq, device=dev,
                            n_blocks=CTX_CACHE_BLOCKS)
    server_d = serve.Server(cfg, params, max_batch=args.max_batch,
                            max_seq=long_seq, device=dev,
                            n_blocks=CTX_CACHE_BLOCKS,
                            prefill_chunk=CTX_CHUNK,
                            slo=serve.parse_slo_spec("default@reserve=0.1"),
                            decode_horizon=CTX_HORIZON)
    runs = {}
    keep = ("tok_per_s", "wall_s", "tokens", "p50_ttft_s", "p99_ttft_s",
            "p50_itl_s", "p99_itl_s", "p50_latency_s", "p99_latency_s",
            "decode_steps", "decode_rounds", "prefill_forwards",
            "prefill_forwards_headless", "prefilled_tokens",
            "prefix_tokens_reused", "preemptions", "peak_concurrency",
            "host_syncs_per_token", "decode_compiles", "blocks_free_end",
            "n_blocks", "macs_per_token", "mfu", "watts", "tokens_per_joule")
    for label, server, trace in (
            ("a", server_a, lambda: serve.trace_from_args(args, cfg)),
            ("b", server_b, lambda: serve.trace_from_args(args, cfg)),
            ("c", server_c, bursty), ("d", server_d, bursty)):
        server.warmup(trace())
        log, undo = _fill_log(server, serve)
        rows, undo_rows = _record_prefill_rows(server.executor)
        ops.reset_launch_counts()                     # the main path starts
        try:
            done, stats = server.serve(trace(), continuous=True,
                                       warmup=False)
        finally:
            undo_rows()
            undo()
        torch.cuda.synchronize()
        got = ops.launch_counts()                     # ... and ends here
        held = _check_prefill_rows(torch, rows, f"ctx ({label})", params)
        fwd, headless, chunks = _fills_expect(log, server.prefill_chunk)
        check((stats["prefill_forwards"],
               stats["prefill_forwards_headless"],
               stats.get("prefill_chunks", 0)) == (fwd, headless, chunks),
              f"ctx ({label}): forwards / headless / chunks "
              f"{stats['prefill_forwards']} / "
              f"{stats['prefill_forwards_headless']} / "
              f"{stats.get('prefill_chunks', 0)} != {fwd} / {headless} "
              f"/ {chunks} worked out from the fills")
        steps = stats["decode_steps"]
        want = {"psi_matmul_codes": per_fwd * (steps
                                               + stats["prefill_forwards"])
                - stats["prefill_forwards_headless"],
                "psi_matmul_packed": 0, "paged_attention": per_step * steps}
        check(got == want, f"ctx ({label}): launch counts {got} != expected "
                           f"{want} ({per_fwd} per forward, one fewer for a "
                           f"chunk without the lm-head, {per_step} "
                           f"attention per step)")
        check(stats["decode_compiles"] == 1,
              f"ctx ({label}): want one captured decode graph, got "
              f"{stats['decode_compiles']}")
        check(stats["blocks_free_end"] == stats["n_blocks"],
              f"ctx ({label}): {stats['n_blocks'] - stats['blocks_free_end']}"
              f" blocks leaked")
        check(all(len(r.tokens) == r.max_new for r in done)
              and all(0 <= t < cfg.vocab_size for r in done
                      for t in r.tokens),
              f"ctx ({label}): a request's tokens are short or out of the "
              f"vocabulary")
        for k in got:
            launches[k] = launches.get(k, 0) + got[k]
        row = {k: stats.get(k) for k in keep}
        row["prefill_chunks"] = stats.get("prefill_chunks", 0)
        row["prefix_cache"] = stats.get("prefix_cache")
        row["fills"] = sum(1 for ev in log if ev[0] in ("fill", "bfill"))
        row["bursts"] = [ev[2] for ev in log if ev[0] == "burst"]
        row["launches"] = got
        row["prefill_rows"] = sorted(set(rows))
        row["prefill_rows_held_here"] = held
        runs[label] = (done, stats, row, log)
    sa, sb, sd = runs["a"][1], runs["b"][1], runs["d"][1]
    check(sb["prefix_tokens_reused"] > 0, "ctx (b): no prefix token reused")
    check(sa["prefilled_tokens"] - sb["prefilled_tokens"]
          == sb["prefix_tokens_reused"],
          f"ctx: prefilled (a) {sa['prefilled_tokens']} - (b) "
          f"{sb['prefilled_tokens']} != reused {sb['prefix_tokens_reused']}")
    check(sd["preemptions"] > 0, "ctx (d): the tight pool preempted nothing")
    rule_b = _token_rule(torch, (server_a, server_b), runs["a"][0],
                         runs["b"][0], (runs["a"][3], runs["b"][3]),
                         "ctx (b) vs (a)")
    rule_d = _token_rule(torch, (server_c, server_d), runs["c"][0],
                         runs["d"][0], (runs["c"][3], runs["d"][3]),
                         "ctx (d) vs (c)")
    prefill = _prefill_window(torch, server_d)
    emit({"phase": "serve_psi8_ctx", "layers": cfg.n_layers,
          "max_batch": args.max_batch, "block_size": server_a.block_size,
          "a_b": "shared prefix 256, tails 32+-8, 8 requests, 8-16 new; "
                 "prefix cache off / on",
          "c_d": f"bursty seed {CTX_SEED}: 12 requests, bursts of 4, long "
                 f"448+24 / short 32+8; FIFO / --slo default@reserve=0.1 "
                 f"--prefill-chunk {CTX_CHUNK} --decode-horizon "
                 f"{CTX_HORIZON}, --cache-blocks {CTX_CACHE_BLOCKS}",
          "runs": {k: v[2] for k, v in runs.items()},
          "tokens_b_vs_a": "identical" if not rule_b else rule_b,
          "tokens_d_vs_c": "identical" if not rule_d else rule_d,
          "margin_factor": MARGIN_FACTOR,
          "prefill_window": prefill,
          "phase_wall_s": time.perf_counter() - t_phase})
    del server_a, server_b, server_c, server_d, params, runs
    torch.cuda.empty_cache()


def _prefill_window(torch, server, rows=(32, 128, 288, 448), calls=3):
    """Wall and device time of one eager prefill forward (with the
    lm-head) plus its scatter, by rows: what an admission, a suffix or a
    chunk costs (written to the slot's scratch block; the server's table
    must cover the largest row count)."""
    import numpy as np
    ex = server.executor
    cache = ex.init_cache()
    brow = np.full((ex.n_bt,), -1, np.int32) if ex.paged else None
    out = {}
    for M in rows:
        toks = (np.arange(M, dtype=np.int32) % server.cfg.vocab_size)[None]
        out[M] = _window(torch, lambda: ex.prefill_insert(
            toks, np.asarray([M], np.int32), cache, 0, brow), 1, calls)
    return out


def _decode_window(torch, server, multi=None, steps=5):
    """Where a steady decode step's time goes, three ways: the model's
    decode_step called eagerly, the horizon-1 graph (Executor.decode) and,
    with ``multi``, its horizon-M round graph (Executor.decode_multi), per
    step (a round's time over M).  Wall time per step on the host clock
    (synchronized at the end of the window), against device time by kernel
    from a torch.profiler trace of the same window (all slots active at 72
    positions: a full table, or a dense slab holding positions 0-71; a
    round rebuilt from host arrays each time).  Device numbers are "not
    measured" when the profiler records no device time."""
    import numpy as np
    ex = server.executor
    B = server.max_batch
    dev = ex.device
    tok = np.arange(B, dtype=np.int32)[:, None]
    pos = np.full((B, 1), 72, np.int32)
    act = np.ones((B,), bool)
    batch = {"token": torch.from_numpy(tok).to(dev),
             "pos": torch.from_numpy(pos).to(dev),
             "active": torch.from_numpy(act).to(dev)}

    def slab(executor):
        cache = executor.init_cache()
        if not executor.paged:
            for layer in cache.kv:
                if "k_pos" in layer:          # a rec layer's state stays 0
                    layer["k_pos"][:, :72] = torch.arange(72, device=dev)
        return cache

    cache = slab(ex)
    table = None
    if ex.paged:
        table = np.arange(B * ex.n_bt, dtype=np.int32).reshape(B, ex.n_bt)
        batch["block_table"] = torch.from_numpy(table).to(dev)

    def eager():
        with torch.inference_mode():
            ex.model.decode_step(ex.params, batch, cache)

    modes = {"eager": (eager, 1),
             "graph": (lambda: ex.decode(tok, pos, act, cache, table), 1)}
    if multi is not None:
        mex = multi.executor
        mcache = slab(mex)
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


def _step_weight_bytes(params):
    """Bytes of the weights one decode step streams: every PSI matmul
    weight's codes or planes and scales (the embedding is a row gather;
    whisper's encoder runs at prefill only)."""
    from repro_torch.core.psi import QuantizedTensor
    total = 0

    def walk(node, name=""):
        nonlocal total
        if isinstance(node, QuantizedTensor):
            if name != "embed":
                total += (node.data.numel() * node.data.element_size()
                          + node.scale.numel() * 4)
        elif isinstance(node, dict):
            for k, v in node.items():
                if k != "encoder":
                    walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)
    walk(params)
    return total


def _param_bytes(params):
    from repro_torch.core.quantizer import quantized_bytes
    return quantized_bytes(params)


# ---------------------------------------------------------------------------
# Phase 5: the card against the CPU.
# ---------------------------------------------------------------------------
def phase_card_vs_cpu(torch, dev):
    from repro_torch.configs import get_config, reduced_config
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
    suffix = _suffix_vs_full(torch, dev, model, params)
    check(suffix["max_abs_err"] <= tol, f"suffix prefill vs full prefill "
                                        f"logits differ by "
                                        f"{suffix['max_abs_err']} > {tol}")
    check(suffix["tokens_full"] == suffix["tokens_suffix"],
          f"suffix prefill tokens {suffix['tokens_suffix']} != full "
          f"prefill tokens {suffix['tokens_full']}")
    spec = _spec_card_vs_cpu(torch, dev, cfg, model)
    del params, model
    archs = {arch: _arch_card_vs_cpu(torch, dev, arch,
                                     CARD_VS_CPU_LAYERS.get(arch, 2))
             for arch in ARCHS}
    vision = _vision_card_vs_cpu(torch, dev)
    swa = _swa_card_vs_cpu(torch, dev, get_config(
        MAIN_ARCH, n_layers=2, dtype="float32", quant_mode="psi8",
        attn_type="swa", window=16))
    mixtral = _swa_card_vs_cpu(torch, dev, reduced_config(
        get_config("mixtral-8x22b"), quant_mode="psi8", window=16))
    # the hybrid at 5 layers (one group and a tail of two rec layers) on
    # its reduced 32-position ring: prompts of six lengths past the
    # window, so every prefill is alone (exact lengths) and rolls the ring
    hybrid = _swa_card_vs_cpu(torch, dev, reduced_config(
        get_config("recurrentgemma-9b"), quant_mode="psi8", n_layers=5),
        lens=(30, 34, 28, 27, 29, 26), static_forwards=6)
    # the reduced SSM on prompts of 1 and 2 tokens, shorter than the conv's
    # cw - 1 = 3 rows of state (the tail padded with zeros in front); two
    # admission events of unequal lengths: six forwards in static mode
    mamba_short = _swa_card_vs_cpu(torch, dev, reduced_config(
        get_config("falcon-mamba-7b"), quant_mode="psi8"),
        lens=(1, 2, 2, 1, 2, 1), static_forwards=6)
    emit({"phase": "card_vs_cpu", "layers": cfg.n_layers, "dtype": "float32",
          "steps": "prefill(16) + 8 decode", "max_abs_err": err,
          "max_abs_logit": amax, "tolerance": tol,
          "argmax_agree": f"{agree}/{len(card)}",
          "suffix_vs_full": suffix, "speculative": spec,
          "archs": archs, "qwen2vl_vision_prefill": vision, "swa_ring": swa,
          "mixtral_reduced_swa_ring": mixtral,
          "recurrentgemma_reduced_5_layer_ring": hybrid,
          "falconmamba_reduced_short_prompts": mamba_short, "ok": True})


def _vision_card_vs_cpu(torch, dev, P=8, S=24):
    """qwen2-vl-2b at full width cut to 2 layers, float32 psi8 (seed 1):
    one prefill of S tokens whose first P embeddings are spliced vision
    patches, with distinct (t, h, w) streams (the patches on a 2 x 4 grid
    at t = 0, the text after them on all three), on the card and on the
    CPU: logits within the phase's 1e-3 (scaled), the splice and the
    streams moving them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.executor import params_to
    t0 = time.perf_counter()
    cfg = get_config("qwen2-vl-2b", n_layers=2, dtype="float32",
                     quant_mode="psi8")
    model = build_model(cfg)
    params = model.init(seed=1, device=dev, bits=8)
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g)
    vis = torch.randn(1, P, cfg.d_model, generator=g) * 0.5
    pos = torch.zeros(1, 3, S, dtype=torch.int32)
    pos[0, 1, :P] = torch.arange(P) // 4
    pos[0, 2, :P] = torch.arange(P) % 4
    pos[0, :, P:] = torch.arange(S - P, dtype=torch.int32) + 4
    out = {}
    for device, p in (("cpu", params_to(params, "cpu")), ("cuda", params)):
        with torch.inference_mode():
            out[device] = [model.prefill(p, toks.to(device), **kw)[0]
                           .float().cpu()
                           for kw in ({"positions": pos.to(device),
                                       "vision_embeds": vis.to(device)},
                                      {})]
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    amax = float(out["cpu"][0].abs().max())
    tol = 1e-3 * max(1.0, amax / 10.0)
    check(err <= tol, f"qwen2-vl vision prefill card vs CPU logits differ "
                      f"by {err} > {tol}")
    check(not torch.equal(out["cuda"][0], out["cuda"][1]),
          "qwen2-vl: the vision splice and streams left the logits as they "
          "were")
    del params, model
    _free(torch)
    return {"layers": cfg.n_layers, "patches": P, "tokens": S,
            "max_abs_err": err, "max_abs_logit": amax, "tolerance": tol,
            "wall_s": time.perf_counter() - t0}


def _swa_card_vs_cpu(torch, dev, cfg, lens=(20, 23, 18, 10, 14, 12),
                     static_forwards=4):
    """An SWA config (qwen3-8b at full width cut to 2 layers under
    attn_type="swa", reduced mixtral-8x22b, or the reduced hybrid; float32
    psi8, seed 1) on the dense layout's ring, or the reduced SSM (no ring:
    its state), served on the CPU and on the card, continuous then static: 6 requests arriving at once on 3 slots,
    7-9 new tokens each, so every ring wraps while decoding.  At the
    default ``lens`` and a 16-position ring: first three prompts of 18-23
    tokens (past the window: exact lengths that differ, so their burst
    prefills one by one and each prompt rolls the ring), then three of
    10-14 (one bucket of 16: one burst forward), so static runs 3 + 1
    forwards (``static_forwards``; the hybrid prefills every prompt of
    its own length alone).  Tokens identical on the card and the CPU; on
    the card exact launch counts (none of kernel 3) and one decode
    graph."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import scheduler, serve
    from repro_torch.models import build_model
    from repro_torch.runtime.executor import params_to
    t0 = time.perf_counter()
    n_layers, window = cfg.n_layers, cfg.window
    params = build_model(cfg).init(seed=1, device=dev, bits=8)

    def trace():
        rng = np.random.default_rng(6)
        return [scheduler.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new=7 + i % 3) for i, n in enumerate(lens)]

    check(all(n + 7 > window for n in lens), "a ring that never wraps")
    per_fwd, per_step = counts_per_step(cfg)
    toks, out = {}, {}
    for device, p in (("cpu", params_to(params, "cpu")), ("cuda", params)):
        server = serve.Server(cfg, p, max_batch=3, max_seq=48, device=device)
        check(not server.paged, "the SWA config resolved to paged")
        if device == "cuda":
            server.warmup(trace())
        for mode in ("continuous", "static"):
            ops.reset_launch_counts()
            done, stats = server.serve(trace(),
                                       continuous=(mode == "continuous"),
                                       warmup=False)
            got = ops.launch_counts()
            toks[(device, mode)] = {r.rid: r.tokens for r in done}
            out[f"{device}_{mode}"] = {
                k: stats[k] for k in ("decode_steps", "prefill_forwards",
                                      "decode_compiles", "cache_bytes")}
            if device == "cuda":
                want = {"psi_matmul_codes": per_fwd * (
                    stats["decode_steps"] + stats["prefill_forwards"]),
                    "psi_matmul_packed": 0, "paged_attention": 0}
                check(got == want, f"swa card vs CPU {mode}: card launch "
                                   f"counts {got} != {want}")
                check(stats["decode_compiles"] == 1,
                      f"swa card vs CPU {mode}: want one decode graph")
            if mode == "static":
                check(stats["prefill_forwards"] == static_forwards,
                      f"swa card vs CPU ({device}): static ran "
                      f"{stats['prefill_forwards']} forwards, want "
                      f"{static_forwards} (the pad_safe fallback)")
        del server, p
    for mode in ("continuous", "static"):
        check(toks[("cuda", mode)] == toks[("cpu", mode)],
              f"swa card vs CPU {mode}: tokens differ: card "
              f"{toks[('cuda', mode)]}, CPU {toks[('cpu', mode)]}")
    del params
    _free(torch)
    return {"arch": cfg.name, "layers": n_layers, "d_model": cfg.d_model,
            "window": window, "prompts": list(lens), "tokens": "identical",
            "runs": out, "wall_s": time.perf_counter() - t0}


def _arch_card_vs_cpu(torch, dev, arch, n_layers=2):
    """A serve of ``arch`` at full width, cut to ``n_layers`` layers (and
    whisper to CARD_VS_CPU_ENC_LAYERS encoder layers over its 1500
    frames), float32 psi8 (random weights, seed 1), on the CPU and on the
    card: 2 requests, 16-token prompts, 6 new tokens each, 2 slots.  Tokens must
    be identical; on the card exact launch counts and one decode graph;
    no leaked block on either.  An MoE config also cuts its experts to
    MOE_CARD_VS_CPU_EXPERTS (the cut is on the line) and adds a
    --speculative 3:MOE_SPEC_K serve, whose verifies drop tokens (C = 1
    at S = k)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import scheduler, serve
    from repro_torch.models import build_model
    from repro_torch.runtime.executor import params_to
    t0 = time.perf_counter()
    family = get_config(arch).family
    cut = ({"n_experts": MOE_CARD_VS_CPU_EXPERTS} if family == "moe"
           else {"n_enc_layers": CARD_VS_CPU_ENC_LAYERS}
           if family == "encdec" else {})
    cfg = get_config(arch, n_layers=n_layers, dtype="float32",
                     quant_mode="psi8", **cut)
    params = build_model(cfg).init(seed=1, device=dev, bits=8)
    trace = lambda: scheduler.poisson_trace(
        2, rate_rps=1e9, prompt_len=16, max_new=6, min_new=6,
        vocab_size=cfg.vocab_size, seed=2)
    toks, out = {}, {}
    for device, p in (("cpu", params_to(params, "cpu")), ("cuda", params)):
        server = serve.Server(cfg, p, max_batch=2, max_seq=32, device=device)
        if device == "cuda":
            server.warmup(trace())
        ops.reset_launch_counts()
        done, stats = server.serve(trace(), warmup=False)
        got = ops.launch_counts()
        check("n_blocks" not in stats
              or stats["blocks_free_end"] == stats["n_blocks"],
              f"{arch} card vs CPU ({device}): a block leaked")
        toks[device] = {r.rid: r.tokens for r in done}
        out[device] = {"decode_steps": stats["decode_steps"],
                       "prefill_forwards": stats["prefill_forwards"],
                       "decode_compiles": stats["decode_compiles"]}
        del server, p
    per_fwd, per_step = counts_per_step(cfg)
    want = {"psi_matmul_codes": matmul_launches(cfg, stats["decode_steps"],
                                                stats["prefill_forwards"]),
            "psi_matmul_packed": 0,
            "paged_attention": per_step * stats["decode_steps"]}
    check(got == want, f"{arch} card vs CPU: card launch counts {got} != "
                       f"{want}")
    check(stats["decode_compiles"] == 1,
          f"{arch} card vs CPU: want one decode graph on the card")
    check(toks["cuda"] == toks["cpu"],
          f"{arch} card vs CPU: tokens differ: card {toks['cuda']}, CPU "
          f"{toks['cpu']}")
    del params
    spec = None
    if family == "moe":
        spec = _spec_card_vs_cpu(torch, dev, cfg, build_model(cfg),
                                 k=MOE_SPEC_K)
        check(spec["cpu_routing"]["verify"]["slots_kept"]
              < spec["cpu_routing"]["verify"]["slots_routed"],
              f"{arch} card vs CPU: no token dropped in a verify "
              f"{spec['cpu_routing']}")
    _free(torch)
    return {"layers": n_layers, "cut": cut, "tokens": "identical",
            "runs": out, "launches": got, "speculative": spec,
            "wall_s": time.perf_counter() - t0}


def _spec_card_vs_cpu(torch, dev, cfg, model, k=SPEC_K):
    """A speculative serve (--speculative SPEC_BITS:k over psi8 codes
    with the QAT precondition at SPEC_BITS, so drafts are accepted) of the
    2-layer float32 model on the CPU and on the card: the same tokens, or a
    divergence only under the token rule; one draft and one verify graph
    on the card; no leaked block on either.  For MoE the CPU run's routing
    is logged (cpu_routing: prefills, and verifies at S = k)."""
    from repro_torch.launch import scheduler, serve
    from repro_torch.runtime.executor import params_to
    params = model.init(seed=1, device=dev, bits=8,
                        qat_precondition=SPEC_BITS)
    trace = lambda: scheduler.poisson_trace(
        2, rate_rps=1e9, prompt_len=16, max_new=8, min_new=8,
        vocab_size=cfg.vocab_size, seed=2)
    t0 = time.perf_counter()
    servers, done, logs, out = [], [], [], {}
    for device, p in (("cpu", params_to(params, "cpu")), ("cuda", params)):
        server = serve.Server(cfg, p, max_batch=2, max_seq=48, device=device,
                              speculative=(SPEC_BITS, k))
        log, undo = _fill_log(server, serve)
        routed, undo_route = (_route_log() if cfg.family == "moe"
                              and device == "cpu" else (None, lambda: None))
        try:
            # the CPU has no graph to capture: its warmup would only repeat
            # full-width eager work
            reqs, stats = server.serve(trace(), warmup=device == "cuda")
        finally:
            undo()
            undo_route()
        if routed is not None:
            out["cpu_routing"] = {
                "prefill": _drops([r for r in routed if r[0] > k]),
                "verify": _drops([r for r in routed if r[0] == k])}
        check(stats["blocks_free_end"] == stats["n_blocks"],
              f"spec card vs CPU ({device}): a block leaked")
        sp = stats["speculative"]
        out[device] = {"rounds": sp["rounds"],
                       "accepted_draft_tokens": sp["accepted_draft_tokens"],
                       "spec_compiles": sp["spec_compiles"]}
        servers.append(server)
        done.append(reqs)
        logs.append(log)
    check(out["cuda"]["spec_compiles"] == {"draft": 1, "verify": 1,
                                           "decode": 0},
          f"spec card vs CPU: card graph counts "
          f"{out['cuda']['spec_compiles']}")
    rule = _token_rule(torch, servers, done[0], done[1], logs,
                       "spec card vs CPU")
    out["tokens"] = "identical" if not rule else rule
    out["wall_s"] = time.perf_counter() - t0
    return out


def _suffix_vs_full(torch, dev, model, params, P=40, split=32, steps=8):
    """On the card: a P-token prompt prefilled whole, against its first
    ``split`` tokens prefilled and scattered into the pool, then the rest
    as a suffix prefill over that context (gathered from the pool) — the
    prefix cache's path; each then decodes ``steps`` greedy tokens.
    Returns the largest logit difference and both token streams."""
    prompt = torch.randint(0, model.cfg.vocab_size, (1, P),
                           generator=torch.Generator().manual_seed(9)).to(dev)
    bs = model.cfg.cache_block_size
    nctx = split // bs

    def decode(cache, table, logits):
        outs, toks = [logits.float()], []
        for i in range(steps + 1):
            tok = int(logits.argmax(-1)[0])
            toks.append(tok)
            if i == steps:
                break
            batch = {"token": torch.tensor([[tok]], device=dev),
                     "pos": torch.tensor([[P + i]], dtype=torch.int32,
                                         device=dev),
                     "active": torch.tensor([True], device=dev),
                     "block_table": table}
            logits, cache = model.decode_step(params, batch, cache)
            outs.append(logits.float())
        return outs, toks

    with torch.inference_mode():
        row = torch.arange(4, dtype=torch.int32, device=dev)
        cache = model.init_cache(1, 64, device=dev, n_blocks=8)
        logits, seq = model.prefill(params, prompt)
        model.insert_cache(cache, seq, 0, row.long())
        full, toks_full = decode(cache, row[None], logits)
        row = torch.arange(4, 8, dtype=torch.int32, device=dev)
        cache = model.init_cache(1, 64, device=dev, n_blocks=8)
        _, seq = model.prefill(params, prompt[:, :split])
        model.insert_cache(cache, seq, 0, row.long())
        ctx = model.gather_prefix_ctx(cache, row[:nctx])
        logits, seq = model.prefill(params, prompt[:, split:], pos0=split,
                                    ctx_kv=ctx)
        model.insert_cache(cache, seq, 0, row[nctx:].long())
        part, toks_suffix = decode(cache, row[None], logits)
    return {"prompt": P, "split": split, "decode_steps": steps,
            "max_abs_err": max(float((a - b).abs().max())
                               for a, b in zip(full, part)),
            "tokens_full": toks_full, "tokens_suffix": toks_suffix}


# --------------------------------------------------------------- training
def _full_width(cfg, arch):
    """``cfg`` has every width of ``arch``'s published config (the depth
    may be cut)."""
    from repro_torch.configs import get_config
    want = get_config(arch)
    keys = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
            "head_dim", "act", "rope", "qk_norm", "norm", "tie_embeddings")
    check(all(getattr(cfg, k) == getattr(want, k) for k in keys),
          f"{arch}: not full width")


def _step_rows(torch, steps):
    return [{"step": s["step"], "loss": s["loss"],
             "device_ms": round(s["device_ms"], 3),
             "wall_ms": round(s["wall_ms"], 3),
             "max_mem_gb": round(s["max_mem_gb"], 3)} for s in steps]


def phase_train(torch, dev, launches):
    """qwen3-8b at full width on TRAIN_LAYERS layers, qat8: TRAIN_STEPS
    steps of ``launch.train.train`` (AdamW, the cosine schedule, batch 8
    x 128 from TokenStream) on the card, each step's loss, device ms (CUDA
    events), wall ms and peak memory; the losses finite and the last below
    the first; TRAIN_COMPRESS_STEPS more with --compress-grads, finite.
    Then the trained weights quantized to psi8: their forward against the
    QAT forward's logits on GEN_PROMPTS prompts (QAT_PSI8_RMS /
    QAT_PSI8_MAX, top-1 agreement printed) and a Server generating
    GEN_NEW tokens for each on the paged pool: kernel 1 runs every
    projection, kernel 3 every decode step, exact launch counts (they
    join the kernels line), each first token the argmax of the prompt's
    psi8 forward alone (or a near tie, GEN_TIE)."""
    from repro_torch.configs import get_config
    from repro_torch.core import quantizer
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import scheduler, serve
    from repro_torch.launch import train as tr
    from repro_torch.models import build_model
    from repro_torch.core.quantizer import tree_leaves, tree_map
    t_phase = time.perf_counter()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MAIN_ARCH), quant_mode="qat8",
                              n_layers=TRAIN_LAYERS)
    _full_width(cfg, MAIN_ARCH)
    steps, csteps = [], []

    def logger(out):
        def on_step(info):
            torch.cuda.synchronize()
            out.append(dict(info,
                            max_mem_gb=torch.cuda.max_memory_allocated()
                            / 1e9))
        return on_step

    params, hist = tr.train(cfg, TRAIN_STEPS, batch_size=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ, device=dev,
                            on_step=logger(steps), log_every=TRAIN_STEPS)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(all(math.isfinite(h) for h in hist), f"train losses {hist}")
    check(hist[-1] < hist[0], f"train: the loss did not fall {hist}")
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, chist = tr.train(cfg, TRAIN_COMPRESS_STEPS, compress=True,
                             batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             device=dev, params=params,
                             on_step=logger(csteps),
                             log_every=TRAIN_COMPRESS_STEPS)
    check(all(math.isfinite(h) for h in chist),
          f"compressed train losses {chist}")
    peak_c = torch.cuda.max_memory_allocated()
    split = _train_split(torch, cfg, params, dev)
    params = tree_map(lambda t: t.detach().requires_grad_(False), params)
    _free(torch)

    # the trained weights: QAT forward, then psi8
    prompts = next(TokenStream(cfg.vocab_size, GEN_PROMPT_LEN, GEN_PROMPTS,
                               seed=1))
    tok = torch.as_tensor(prompts, device=dev)
    with torch.inference_mode():
        qat = build_model(cfg).forward(params, tok)[0].float()
    qp = quantizer.quantize_param_tree(params, 8)
    del params
    _free(torch)
    cfg8 = dataclasses.replace(cfg, quant_mode="psi8")
    m8 = build_model(cfg8)
    with torch.inference_mode():
        psi = m8.forward(qp, tok)[0].float()
        alone = torch.cat([m8.forward(qp, tok[i:i + 1])[0][:, -1].float()
                           for i in range(GEN_PROMPTS)])
    d = psi - qat
    rms = float(d.square().mean().sqrt() / qat.square().mean().sqrt())
    mx = float(d.abs().max() / qat.abs().max())
    top1 = float((psi.argmax(-1) == qat.argmax(-1)).float().mean())
    check(bool(torch.isfinite(psi).all()), "psi8 logits not finite")
    check(rms <= QAT_PSI8_RMS and mx <= QAT_PSI8_MAX,
          f"psi8 vs QAT logits: rms {rms}, max {mx} (bounds "
          f"{QAT_PSI8_RMS}, {QAT_PSI8_MAX})")
    del qat, psi, d

    # generation on the paged pool through kernels 1 and 3
    max_seq = -(-(GEN_PROMPT_LEN + GEN_NEW + 8) // 16) * 16
    server = serve.Server(cfg8, qp, max_batch=GEN_PROMPTS, max_seq=max_seq,
                          device=dev)

    def trace():
        return [scheduler.Request(rid=i, prompt=prompts[i], max_new=GEN_NEW)
                for i in range(GEN_PROMPTS)]

    server.warmup(trace())
    rows, undo = _record_prefill_rows(server.executor)
    ops.reset_launch_counts()                         # the main path starts
    try:
        done, stats = server.serve(trace(), warmup=False)
    finally:
        undo()
    torch.cuda.synchronize()
    got = ops.launch_counts()                         # ... and ends here
    held = _check_prefill_rows(torch, rows, "train_qwen3_8b_psi8",
                               server.executor.params)
    per_fwd, per_step = counts_per_step(cfg8)
    want = {"psi_matmul_codes": matmul_launches(
                cfg8, stats["decode_steps"], stats["prefill_forwards"]),
            "psi_matmul_packed": 0,
            "paged_attention": per_step * stats["decode_steps"]}
    check(got == want, f"train_qwen3_8b generation launch counts {got} != "
                       f"{want}")
    check(stats["decode_compiles"] == 1, "generation: want one decode graph")
    check(all(len(r.tokens) == GEN_NEW and all(0 <= t < cfg8.vocab_size
                                               for t in r.tokens)
              for r in done), "generation: short or out-of-vocab tokens")
    first = {r.rid: r.tokens[0] for r in done}
    ties = 0
    for i in range(GEN_PROMPTS):
        top2 = alone[i].topk(2).values
        if first[i] != int(alone[i].argmax()):
            margin = float(top2[0] - top2[1])
            check(margin <= GEN_TIE * float(alone[i].abs().max()),
                  f"generation: request {i}'s first token {first[i]} is "
                  f"not its forward's argmax (margin {margin})")
            ties += 1
    for k in ("psi_matmul_codes", "paged_attention"):
        launches[k] = launches.get(k, 0) + got[k]
    emit({"phase": "train_qwen3_8b", "layers": TRAIN_LAYERS,
          "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "quant": "qat8", "steps": _step_rows(torch, steps),
          "peak_mem_gb": round(peak / 1e9, 3),
          "compress_steps": _step_rows(torch, csteps),
          "peak_mem_compress_gb": round(peak_c / 1e9, 3),
          "step_split_ms": split,
          "psi8_vs_qat": {"rms_rel": rms, "max_rel": mx,
                          "top1_agreement": top1, "positions":
                          GEN_PROMPTS * GEN_PROMPT_LEN},
          "generation": {"tokens": {r.rid: r.tokens for r in done},
                         "first_token_near_ties": ties,
                         "launches": got, "prefill_rows": sorted(set(rows)),
                         "prefill_rows_held": held,
                         "decode_steps": stats["decode_steps"],
                         "prefill_forwards": stats["prefill_forwards"]},
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    del server, qp
    _free(torch)


def _train_split(torch, cfg, params, dev, reps=3):
    """Device ms of a train step's parts on the trained params (CUDA
    events, the median of ``reps``): the loss forward, its backward
    (``torch.autograd.grad``), the AdamW update, and compress +
    decompress of the gradients."""
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, compress_gradients
    from repro_torch.optim import decompress_gradients
    from repro_torch.core.quantizer import tree_leaves, tree_map
    model = build_model(cfg)
    opt = adamw(lr=0.0)             # every operation, no change to params
    state = opt.init(params)
    leaves = tree_leaves(params)
    batch = {"tokens": torch.as_tensor(next(TokenStream(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=2)), device=dev)}
    parts = {"forward": [], "backward": [], "adamw": [], "compress": []}

    def timed(name, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        parts[name].append(ev[0].elapsed_time(ev[1]))
        return out

    for _ in range(reps):
        loss, _ = timed("forward", lambda: model.loss(params, batch))
        got = timed("backward", lambda: torch.autograd.grad(loss, leaves))
        del loss
        it = iter(got)
        grads = tree_map(lambda _: next(it), params)
        del got
        timed("compress", lambda: decompress_gradients(
            compress_gradients(grads)[0]))
        timed("adamw", lambda: opt.update(grads, state, params))
        del grads
    del state
    _free(torch)
    return {k: round(statistics.median(v), 3) for k, v in parts.items()}


def _plain_vs_sharded(torch, dev, model, opt, mesh, batches, timed,
                      label):
    """``len(batches)`` plain steps (``make_train_step``), then as many
    sharded steps (``make_sharded_train_step`` on ``mesh``) from the same
    params (``Model.init`` seed 0, drawn twice); the plain run's params, m
    and v wait on the host.  Fails unless the losses (the MoE
    load-balancing loss inside) and every leaf of params, m and v are
    bit-equal; returns each step's loss, aux, gradient norm and device ms,
    the peaks, the collectives, and the sharded run's state (``local``,
    ``st``, the last ``lb``)."""
    from repro_torch.core.quantizer import tree_leaves, tree_map
    from repro_torch.launch import train as tr
    from repro_torch.runtime import parallel
    from repro_torch.runtime.fsdp import TrainShare

    def record(met, ms):
        return {"loss": float(met["loss"]), "aux": float(met["aux"]),
                "grad_norm": float(met["grad_norm"]),
                "device_ms": round(ms, 3)}

    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    st = opt.init(params)
    step = tr.make_train_step(model, opt)
    plain = []
    for b in batches:
        (params, st, _, met), ms = timed(step, params, st, {}, b)
        plain.append(record(met, ms))
    peak_plain = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = tree_map(lambda t: t.detach().cpu(),
                    {"params": params, "m": st.m, "v": st.v})
    d2h_s = time.perf_counter() - t0
    del params, st, step, met
    _free(torch)

    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, dev)
    share = TrainShare(model.cfg, mesh, params)
    local = share.place(params)
    del params
    st = opt.init(local)
    step = tr.make_sharded_train_step(model, opt, share)
    parallel.reset_collective_counts()
    sharded = []
    for b in batches:
        lb = share.local_batch(b)
        (local, st, met), ms = timed(step, local, st, lb)
        sharded.append(record(met, ms))
    colls = parallel.collective_counts()
    peak_mesh = torch.cuda.max_memory_allocated()
    del met, step

    # bit for bit against the plain step
    got = {"params": local, "m": st.m, "v": st.v}
    t0 = time.perf_counter()
    diff, n_diff = 0.0, 0
    for kind in ("params", "m", "v"):
        for g, w in zip(tree_leaves(got[kind]), tree_leaves(want[kind])):
            w = w.to(dev)
            if not torch.equal(g.detach(), w):
                n_diff += 1
                diff = max(diff, float((g.detach() - w).abs().max()))
            del w
    cmp_s = time.perf_counter() - t0
    del want
    same_loss = ([(r["loss"], r["aux"]) for r in sharded]
                 == [(r["loss"], r["aux"]) for r in plain])
    check(same_loss and n_diff == 0,
          f"{label}: the (1, 1) sharded step differs from the plain one: "
          f"losses {[r['loss'] for r in sharded]} vs "
          f"{[r['loss'] for r in plain]}, {n_diff} leaves differ, largest "
          f"difference {diff}")
    return {"params": n_params, "plain": plain, "sharded": sharded,
            "bit_equal": True, "collectives": colls,
            "peak_mem_plain_gb": round(peak_plain / 1e9, 3),
            "peak_mem_sharded_gb": round(peak_mesh / 1e9, 3),
            "host_copy_s": round(d2h_s, 3), "compare_s": round(cmp_s, 3),
            "local": local, "st": st, "lb": lb}


def phase_train_mesh(torch, dev):
    """train_mesh: the sharded train step (``runtime.fsdp.TrainShare``,
    ``launch.train.make_sharded_train_step``: params, m and v on the
    training specs, gathered on use, gradients reduce-scattered back) on a
    (1, 1) ("data", "model") mesh of a world-1 NCCL group, against the
    plain ``make_train_step``: qwen3-8b at full width on TRAIN_LAYERS
    layers, qat8, batch TRAIN_BATCH x TRAIN_SEQ, MESH_TRAIN_STEPS steps
    each from the same params (``Model.init`` seed 0, drawn twice) and
    batches, under deterministic algorithms (the embedding's backward
    would otherwise add with atomics).  Every collective of a one-rank
    group is a copy, so the losses and every leaf of params, m and v must
    be equal bit for bit; otherwise the largest difference is printed and
    the phase fails.  Prints each step's device ms (CUDA events) beside
    the plain step's, the peak memory of each run and the collectives the
    sharded steps issued; the dry run's resident bytes of this cell on an
    ``AxisMesh((1, 1))`` (f32 params, as the trainer holds them) against
    the bytes the phase's params, m, v and batch hold; ``pipeline_apply``
    on a one-stage mesh on the card against the plain layer loop; and the
    dry run of qwen3-8b's four shapes on the (16, 16) production mesh
    (host only).  Then the same pair for the MoE family: qwen3-moe-30b-a3b
    at full width on MOE_TRAIN_LAYERS layers (its load-balancing loss in
    the loss; on one row shard the router's sums are the single
    process's), bit-equal losses (aux included), params, m and v."""
    import shutil
    import tempfile
    import warnings
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.core.quantizer import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import parallel, sharding as shr
    from repro_torch.runtime.pipeline_par import pipeline_apply
    t_phase = time.perf_counter()
    _free(torch)
    cfg = dataclasses.replace(get_config(MAIN_ARCH), quant_mode="qat8",
                              n_layers=TRAIN_LAYERS)
    _full_width(cfg, MAIN_ARCH)
    model = build_model(cfg)
    opt = adamw(lr=3e-4)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{"tokens": torch.as_tensor(next(stream), device=dev)}
               for _ in range(MESH_TRAIN_STEPS)]

    def timed(fn, *args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args)
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])

    det = torch.are_deterministic_algorithms_enabled()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    check(not dist.is_initialized(), "a process group is already up")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            dist.init_process_group("nccl",
                                    store=dist.FileStore(f"{tmp}/store", 1),
                                    rank=0, world_size=1)
            backend = str(dist.get_backend())
            mesh = make_mesh((1, 1), ("data", "model"))
            pair = _plain_vs_sharded(torch, dev, model, opt, mesh, batches,
                                     timed, "train_mesh")
            plain, sharded = pair["plain"], pair["sharded"]
            local, st, lb = pair.pop("local"), pair.pop("st"), pair.pop("lb")
            n_params, colls = pair["params"], pair["collectives"]
            # what a one-rank NCCL collective costs: the GB/s of an
            # all-gather and a reduce-scatter of the largest leaf (the
            # embedding table) against a clone of it
            emb = local["embed"].detach()
            rates = {}
            for name, fn in (
                    ("clone", lambda: emb.clone()),
                    ("all_gather", lambda: parallel.all_gather(
                        emb, mesh.flat_group)),
                    ("reduce_scatter", lambda: parallel.reduce_scatter(
                        torch.empty_like(emb), [emb], mesh.flat_group))):
                fn()
                _, ms = timed(fn)
                rates[name] = round(2 * emb.numel() * emb.element_size()
                                    / (ms * 1e-3) / 1e9, 1)
            del emb

            # the dry run of this cell against the bytes its tensors hold
            held = {"params": sum(t.numel() * t.element_size()
                                  for t in tree_leaves(local)),
                    "opt": sum(t.numel() * t.element_size()
                               for t in tree_leaves(st.m)
                               + tree_leaves(st.v)),
                    "batch": sum(t.numel() * t.element_size()
                                 for t in lb.values())}
            cell = ShapeConfig("train_8x128", TRAIN_SEQ, TRAIN_BATCH, "train")
            amesh = shr.AxisMesh((1, 1), ("data", "model"))
            report = dryrun.resident_bytes(dryrun.place_cell(
                cfg, cell, amesh, param_dtype=torch.float32), amesh)
            check(report == held, f"train_mesh: dry-run bytes {report} != "
                                  f"the tensors' {held}")
            del local, st, lb
            _free(torch)

            # MoE: full-width qwen3-moe on MOE_TRAIN_LAYERS layers, the
            # load-balancing loss included (one row shard: the router's
            # sums are the single process's)
            mcfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                                       quant_mode="qat8",
                                       n_layers=MOE_TRAIN_LAYERS)
            _full_width(mcfg, MOE_TRAIN_ARCH)
            mstream = TokenStream(mcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0)
            mbatches = [{"tokens": torch.as_tensor(next(mstream),
                                                   device=dev)}
                        for _ in range(MESH_TRAIN_STEPS)]
            moe_pair = _plain_vs_sharded(torch, dev, build_model(mcfg),
                                         adamw(lr=3e-4), mesh, mbatches,
                                         timed, "train_mesh moe")
            del moe_pair["local"], moe_pair["st"], moe_pair["lb"]
            _free(torch)

            # pipeline_apply on a one-stage mesh against the layer loop
            smesh = make_mesh((1,), ("stage",))
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            ws = torch.randn((PIPE_L, PIPE_D, PIPE_D), generator=gen,
                             device=dev) * PIPE_D ** -0.5
            xs = torch.randn((PIPE_M, PIPE_MB, PIPE_D), generator=gen,
                             device=dev)
            layer = lambda w, x: torch.tanh(x @ w)
            parallel.reset_collective_counts()
            (pipe, pipe_ms) = timed(pipeline_apply, layer, ws, xs, smesh)
            pipe_colls = sum(parallel.collective_counts().values())
            # the layer loop a microbatch at a time (a (M x mb)-row product
            # would take another GEMM algorithm and round otherwise)
            loop = []
            for x in xs:
                for w in ws:
                    x = torch.tanh(x @ w)
                loop.append(x)
            loop = torch.stack(loop)
            pipe_err = float((pipe - loop).abs().max())
            check(pipe_err == 0.0 and pipe_colls == 0,
                  f"train_mesh: one-stage pipeline differs from the layer "
                  f"loop by {pipe_err} ({pipe_colls} collectives)")
            del ws, xs, pipe, loop
        finally:
            torch.use_deterministic_algorithms(det)
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)

    # the production mesh's report for qwen3-8b (meta tensors, host only)
    prod = {}
    for name in SHAPES:
        r = dryrun.run_cell(MAIN_ARCH, name, verbose=False)
        prod[name] = r if "skipped" in r else {
            k: r[k] for k in ("resident_bytes_per_dev",
                              "memory_per_device_bytes", "fits_hbm_80g",
                              "bottleneck", "bound_s", "place_s")}
    emit({"phase": "train_mesh", "mesh": [1, 1],
          "backend": backend, "layers": TRAIN_LAYERS, "params": n_params,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "quant": "qat8",
          "plain_steps": plain, "sharded_steps": sharded,
          "bit_equal": True, "collectives": colls,
          "peak_mem_plain_gb": pair["peak_mem_plain_gb"],
          "peak_mem_sharded_gb": pair["peak_mem_sharded_gb"],
          "one_rank_copy_gb_per_s": rates,
          "host_copy_s": pair["host_copy_s"],
          "compare_s": pair["compare_s"],
          "moe": {"arch": MOE_TRAIN_ARCH, "layers": MOE_TRAIN_LAYERS,
                  **moe_pair},
          "dryrun_cell_bytes": report, "tensor_bytes": held,
          "pipeline_one_stage": {"layers": PIPE_L, "microbatches": PIPE_M,
                                 "rows": PIPE_MB, "width": PIPE_D,
                                 "device_ms": round(pipe_ms, 3),
                                 "max_abs_err": pipe_err},
          "dryrun_qwen3_8b_16x16": prod,
          "phase_s": round(time.perf_counter() - t_phase, 3)})


def phase_train_resume(torch, dev):
    """Reduced qwen3-8b, qat8, batch 8 x 128, on the card: 6 steps in one
    run (checkpoints at 3 and 6) against a fresh trainer resumed from the
    step-3 checkpoint for steps 4-6, under deterministic algorithms (the
    embedding's backward would otherwise accumulate with atomics): the
    losses agree (RESUME_RTOL; whether bit for bit is printed); the run's
    losses against the port's on the CPU from the same initial params."""
    import shutil
    import tempfile
    import warnings
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train as tr
    from repro_torch.models import build_model
    from repro_torch.core.quantizer import tree_map
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = reduced_config(get_config(MAIN_ARCH), quant_mode="qat8")
    init = build_model(cfg).init(0, "cpu")
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, save_every=3,
              log_every=100)
    fresh = lambda d: tree_map(lambda t: t.clone().to(d), init)
    det = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(), tempfile.TemporaryDirectory() as ck:
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, full = tr.train(cfg, 6, ckpt_dir=ck, device=dev,
                               params=fresh(dev), **kw)
            shutil.rmtree(os.path.join(ck, "step_0000000006"))
            _, resumed = tr.train(cfg, 6, ckpt_dir=ck, device=dev,
                                  params=fresh(dev), **kw)
        finally:
            torch.use_deterministic_algorithms(det)
    _, cpu = tr.train(cfg, 6, device="cpu", params=fresh("cpu"),
                      batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      log_every=100)
    check(len(resumed) == 3 and all(math.isfinite(h) for h in full),
          f"resume: {full} / {resumed}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[3:]))
    check(rel <= RESUME_RTOL, f"resumed losses {resumed} != {full[3:]}")
    rel_cpu = max(abs(a - b) / abs(b) for a, b in zip(full, cpu))
    check(rel_cpu <= RESUME_RTOL, f"card losses {full} != CPU {cpu}")
    emit({"phase": "train_resume", "losses": full, "resumed": resumed,
          "bit_equal": resumed == full[3:], "max_rel": rel,
          "cpu_losses": cpu, "card_vs_cpu_max_rel": rel_cpu,
          "first3_card_vs_cpu_max_rel": max(
              abs(a - b) / abs(b) for a, b in zip(full[:3], cpu[:3])),
          "phase_s": round(time.perf_counter() - t_phase, 3)})


def _cnn_train(torch, cnn, cfg, params, batch_at, steps, opt):
    """``steps`` steps of ``opt`` on ``cnn_loss``; returns (params, the
    losses)."""
    from repro_torch.core.quantizer import tree_leaves, tree_map
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    state, losses = opt.init(params), []
    for i in range(steps):
        loss, _ = cnn.cnn_loss(params, batch_at(i), cfg)
        it = iter(torch.autograd.grad(loss, leaves))
        params, state, _ = opt.update(tree_map(lambda _: next(it), params),
                                      state, params)
        losses.append(loss.detach())
    return params, [float(v) for v in losses]


def phase_cnn(torch, dev):
    """The paper's networks on the card.  AlexNet at batch 4: the forward
    at fp32, psi8 and psi5 (``quantize_cnn`` codes, dequantized to f32)
    against the port on the CPU (CNN_REL), and its ms; 3 qat5 SGD steps
    on a fixed random batch, the loss falling at each.  LeNet-5 with the
    recipe of examples/train_lenet_qat.py (plain SGD lr 0.05, batch 128,
    300 steps on synthetic_mnist(4096, 1); test on synthetic_mnist(2048,
    2)) at fp32 and qat8 (tested at psi8, as the recipe does), on the
    card and on the CPU from the same init: accuracies within LENET_PP
    points."""
    from repro_torch.data import synthetic_mnist
    from repro_torch.models import cnn
    from repro_torch.optim import sgd
    from repro_torch.core.quantizer import tree_map
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    _free(torch)

    def to(tree, d):
        return tree_map(lambda t: t.to(d), tree)

    init = cnn.init_cnn(cnn.ALEXNET, 0, "cpu")
    x = torch.randn((ALEXNET_BATCH,) + cnn.ALEXNET.in_shape,
                    generator=torch.Generator().manual_seed(7))
    y = torch.randint(0, cnn.ALEXNET.n_classes, (ALEXNET_BATCH,),
                      generator=torch.Generator().manual_seed(8))
    xd = x.to(dev)
    fwd = {}
    for mode, bits in (("none", None), ("psi8", 8), ("psi5", 5)):
        cfg = dataclasses.replace(cnn.ALEXNET, quant_mode=mode)
        pc = init if bits is None else cnn.quantize_cnn(init, bits)
        pd = to(pc, dev)
        if bits is not None:
            on_card = cnn.quantize_cnn(to(init, dev), bits)
            check(all(torch.equal(on_card[k]["convk" if "conv" in k
                                              else "w"].data.cpu(),
                                  pc[k]["convk" if "conv" in k
                                        else "w"].data)
                      for k in pc), f"alexnet psi{bits} codes differ")
        with torch.inference_mode():
            want = cnn.cnn_forward(pc, x, cfg)
            got = cnn.cnn_forward(pd, xd, cfg).cpu()
            err = float((got - want).abs().max())
            check(err <= CNN_REL * float(want.abs().max()),
                  f"alexnet {mode}: card vs CPU {err}")
            ms = _median_ms(torch, lambda i: cnn.cnn_forward(pd, xd, cfg),
                            1)
        fwd[mode] = {"max_abs_err": err, "max_abs_logit":
                     float(want.abs().max()), "ms": round(ms, 4)}
    cfg = dataclasses.replace(cnn.ALEXNET, quant_mode="qat5")
    batch = {"images": xd, "labels": y.to(dev)}
    t0 = time.perf_counter()
    p, alex = _cnn_train(torch, cnn, cfg, to(init, dev), lambda i: batch,
                         3, sgd(lr=ALEXNET_LR, momentum=0.9))
    with torch.no_grad():
        alex.append(float(cnn.cnn_loss(p, batch, cfg)[0]))
    torch.cuda.synchronize()
    alex_s = time.perf_counter() - t0
    check(all(b < a for a, b in zip(alex, alex[1:])),
          f"alexnet qat5: the loss did not fall at every step {alex}")
    del p, init, pd, pc

    xs, ys = synthetic_mnist(4096, seed=1)
    xt, yt = synthetic_mnist(2048, seed=2)
    lenet = {}
    for mode in ("none", "qat8"):
        cfg = dataclasses.replace(cnn.LENET5, quant_mode=mode)
        ecfg = dataclasses.replace(cnn.LENET5, quant_mode="psi8"
                                   if mode == "qat8" else "none")
        start = cnn.init_cnn(cnn.LENET5, 0, "cpu")
        for d in (dev, torch.device("cpu")):
            data = (torch.from_numpy(xs).to(d), torch.from_numpy(ys).to(d))

            def batch_at(i, data=data):
                lo = (i * LENET_BATCH) % (len(xs) - LENET_BATCH)
                return {"images": data[0][lo:lo + LENET_BATCH],
                        "labels": data[1][lo:lo + LENET_BATCH]}
            t0 = time.perf_counter()
            p, losses = _cnn_train(torch, cnn, cfg, to(start, d), batch_at,
                                   LENET_STEPS,
                                   sgd(lr=LENET_LR, momentum=0.0))
            p = tree_map(lambda t: t.detach(), p)
            if mode == "qat8":
                p = cnn.quantize_cnn(p, 8)
            with torch.no_grad():
                test = {"images": torch.from_numpy(xt).to(d),
                        "labels": torch.from_numpy(yt).to(d)}
                _, met = cnn.cnn_loss(p, test, ecfg)
            lenet[(mode, d.type)] = {"acc": float(met["acc"]),
                                     "last_loss": losses[-1],
                                     "s": round(time.perf_counter() - t0, 3)}
        a, b = lenet[(mode, "cuda")]["acc"], lenet[(mode, "cpu")]["acc"]
        check(abs(a - b) * 100 <= LENET_PP,
              f"lenet5 {mode}: card accuracy {a} vs CPU {b}")
    emit({"phase": "cnn", "alexnet_batch": ALEXNET_BATCH,
          "alexnet_forward": fwd, "alexnet_qat5_sgd_losses": alex,
          "alexnet_qat5_sgd_s": round(alex_s, 3),
          "lenet5": {f"{m}_{d}": v for (m, d), v in lenet.items()},
          "phase_s": round(time.perf_counter() - t_phase, 3)})


if __name__ == "__main__":
    sys.exit(main())
