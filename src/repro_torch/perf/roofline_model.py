"""Analytic roofline model per (arch x shape x mesh) cell, with the
constants of the NVIDIA H100 SXM5 80GB.

The counts are exact per-layer GEMM, attention and recurrence terms,
multiplied out over the layers, per training or serving STEP, globally;
:func:`roofline_terms` divides them by the card count and the card's
rates.  Bytes honour the weight format (bf16 2 B, PSI-INT8 1 B, PSI-INT5
0.625 B a weight: the paper's technique moves the memory term directly).
Every count function keeps the JAX package's order of operations, so the
counts agree with it bit for bit; only the rates are the card's.

The serving engine reads :func:`decode_macs_per_token` and
:data:`PEAK_FLOPS` for its ``macs_per_token`` / ``mfu`` stats.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import SHAPES, get_config

# NVIDIA H100 SXM5 80GB data sheet (roofline denominators), per GPU.
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (989.4 TFLOPS)
HBM_BW = 3.35e12             # HBM3 bytes/s (3.35 TB/s)
# NVLink 4: 900 GB/s a GPU over its 18 links, both directions together,
# so 450 GB/s a direction PER GPU (not per link, as a TPU's ICI figure
# is): the collective term divides a card's own collective bytes by it.
LINK_BW = 4.5e11             # 450 GB/s


def _weight_bytes(quant: str) -> float:
    """Serving bytes/param for a quant mode: bf16 for "none", else the
    registered PsiFormat's packed footprint (psi8 1 B, psi5 0.625 B,
    psi4 0.5 B, ...)."""
    if quant in ("", "none", None):
        return 2.0
    from repro_torch.core.psi import get_format
    try:
        return get_format(quant).bytes_per_weight(packed=True)
    except ValueError:
        return 2.0


ACT_B = 2            # bf16 activations
TRAIN_GEMM_FACTOR = 4.0    # fwd + remat-fwd + 2x bwd
TRAIN_WEIGHT_IO = 28.0     # bytes/param/step: 3 bf16 reads + grad + adam m,v
SERVE_ACT_RW = 8           # residual-stream reads+writes per layer (fused est)
TRAIN_ACT_RW = 20


@dataclasses.dataclass
class CellModel:
    flops: float                 # global FLOPs / step
    hbm_bytes: float             # global device-memory bytes / step
    coll_bytes_per_dev: float    # collective bytes / card / step
    notes: str = ""


def _attn_kv_len(cfg, S):
    if cfg.attn_type == "swa" and cfg.window:
        return min(cfg.window, S)
    return S


def _layer_gemm_flops(cfg, T):
    """Forward FLOPs of one mamba block (the other blocks' terms are in
    :func:`forward_flops`)."""
    d = cfg.d_model
    fl = 0.0
    if cfg.family == "ssm":
        di, r, N = cfg.d_inner, cfg.resolved_dt_rank, cfg.ssm_state
        fl += 2 * T * d * 2 * di          # in_proj
        fl += 2 * T * cfg.ssm_conv * di   # depthwise conv
        fl += 2 * T * di * (r + 2 * N)    # x_proj
        fl += 2 * T * r * di              # dt_proj
        fl += 8 * T * di * N              # recurrence + y readout
        fl += 2 * T * di * d              # out_proj
        return fl
    return fl


def _attn_flops(cfg, T, S_ctx, causal=True):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    fl = 2 * T * d * (hq + 2 * hkv) * hd      # qkv proj
    fl += 2 * T * hq * hd * d                 # out proj
    eff = (S_ctx + 1) / 2 if (causal and T > 1) else S_ctx
    fl += 2 * 2 * T * hq * hd * eff           # scores + values
    return fl


def _mlp_flops(cfg, T, d_ff=None):
    f = d_ff or cfg.d_ff
    n_mat = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * T * cfg.d_model * f * n_mat


def _moe_flops(cfg, T):
    fl = 2 * T * cfg.d_model * cfg.n_experts           # router
    fl += cfg.top_k * _mlp_flops(cfg, T)               # top-k experts
    return fl


def _rec_flops(cfg, T):
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    fl = 2 * T * d * dr * 2          # in_rec + in_gate
    fl += 2 * T * cfg.ssm_conv * dr  # conv
    fl += 2 * T * dr * dr * 2        # rglru gates (wa, wx)
    fl += 10 * T * dr                # recurrence elementwise
    fl += 2 * T * dr * d             # out
    return fl


def forward_flops(cfg, B, S, kind):
    """Global forward FLOPs for one step of this shape."""
    T = B * S if kind != "decode" else B
    S_ctx = _attn_kv_len(cfg, S)
    total = 0.0
    kinds = _layer_kind_list(cfg)
    for k in kinds:
        if k == "attn":
            total += _attn_flops(cfg, T, S_ctx if kind == "decode" else
                                 min(S_ctx, S))
            total += (_mlp_flops(cfg, T) if cfg.family != "moe"
                      else _moe_flops(cfg, T))
        elif k == "xattn":
            total += _attn_flops(cfg, T, S_ctx if kind == "decode" else S)
            # cross attention: kv from enc_frames
            d, hd = cfg.d_model, cfg.resolved_head_dim
            total += 2 * T * d * cfg.n_heads * hd * 2
            total += 2 * 2 * T * cfg.n_heads * hd * cfg.enc_frames
            total += _mlp_flops(cfg, T)
        elif k == "rec":
            total += _rec_flops(cfg, T)
            total += _mlp_flops(cfg, T)
        elif k == "mamba":
            total += _layer_gemm_flops(cfg, T)
    # encoder (whisper): full enc stack on frames, every step
    if cfg.family == "encdec":
        Te = B * cfg.enc_frames
        for _ in range(cfg.n_enc_layers):
            total += _attn_flops(cfg, Te, cfg.enc_frames, causal=False)
            total += _mlp_flops(cfg, Te)
    total += 2 * T * cfg.d_model * cfg.vocab_size      # lm head
    return total


def decode_macs_per_token(cfg, ctx_len: int) -> float:
    """Roofline MACs to emit ONE token at context length ``ctx_len``: the
    per-token work term of the paper's MACs/W figure of merit, and the
    numerator of the serving stats' MFU and tokens-per-joule::

        MFU              = macs*2 * tok_per_s / (PEAK_FLOPS * n_devices)
        tokens_per_joule = tok_per_s / watts

    One decode step for one slot is ``forward_flops(cfg, B=1, S=ctx,
    kind="decode")``; a MAC is 2 FLOPs."""
    return forward_flops(cfg, 1, max(int(ctx_len), 1), "decode") / 2.0


def _layer_kind_list(cfg):
    from repro_torch.models.transformer import layer_kinds
    return layer_kinds(cfg)


def _tp_ars_per_layer(cfg) -> float:
    """Average full-activation TP collectives per layer, fwd+bwd (train).
    Dense/MoE block: attn-out AR + mlp-out AR, x2 for backward = 4.
    Mamba: out_proj AR only, x2 = 2.  Hybrid: weighted by pattern."""
    kinds = _layer_kind_list(cfg)
    per = {"attn": 4.0, "xattn": 6.0, "rec": 4.0, "mamba": 2.0}
    return sum(per[k] for k in kinds) / max(len(kinds), 1)


def weight_bytes_total(cfg, quant: str) -> float:
    """Serving-format parameter bytes (quant applies to GEMM weights only;
    norms/scales stay f32 — a ~0.1 % correction, ignored)."""
    n = cfg.param_count()
    return n * _weight_bytes(quant)


def active_weight_bytes(cfg, quant: str) -> float:
    return cfg.active_param_count() * _weight_bytes(quant)


def kv_cache_bytes(cfg, B, S, kv_quant: str = "") -> float:
    C = _attn_kv_len(cfg, S)
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for k in _layer_kind_list(cfg) if k in ("attn", "xattn"))
    # int8 KV: 1 byte/elem + f32 scale per (slot, head) entry
    kv_b = (1 + 4 / hd) if kv_quant == "int8" else ACT_B
    kv = 2 * B * C * cfg.n_kv_heads * hd * kv_b * n_attn
    if cfg.family == "ssm":
        kv += B * cfg.d_inner * cfg.ssm_state * 4 * cfg.n_layers
    if cfg.family == "hybrid":
        n_rec = sum(1 for k in _layer_kind_list(cfg) if k == "rec")
        kv += B * cfg.resolved_d_rnn * 4 * n_rec
    return kv


def analytic_cell(arch: str, shape_name: str, quant: str = "psi8",
                  chips: int = 256, mesh_model: int = 16,
                  tp_on=None, kv_quant: str = "") -> CellModel:
    from repro_torch.runtime.sharding import tp_enabled
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    tp = tp_enabled(cfg) if tp_on is None else tp_on
    T = B * S if kind != "decode" else B

    fwd = forward_flops(cfg, B, S, kind)
    if kind == "train":
        flops = fwd * TRAIN_GEMM_FACTOR
        hbm = (cfg.param_count() * TRAIN_WEIGHT_IO
               + TRAIN_ACT_RW * T * cfg.d_model * ACT_B * cfg.n_layers
               + 3 * T * cfg.vocab_size * ACT_B)          # logits fwd+bwd
        # FSDP param all-gather + grad reduce-scatter over the data axes
        data_ways = chips // mesh_model
        pbytes = 2.0 * cfg.param_count()                  # bf16
        coll_dev = 2 * pbytes / mesh_model if tp else 2 * pbytes / chips
        # TP collectives per layer on (T/data_ways, d) activations, fwd+bwd.
        # Elementwise-recurrent blocks (mamba, rg-lru) keep the channel dim
        # sharded through the scan: fewer boundary collectives.
        if tp:
            act = (T / data_ways) * cfg.d_model * ACT_B
            coll_dev += _tp_ars_per_layer(cfg) * act * cfg.n_layers
        notes = "train: 4x-fwd GEMMs (remat), FSDP gather+scatter, TP ARs"
    elif kind == "prefill":
        flops = fwd
        hbm = (active_weight_bytes(cfg, quant)
               + SERVE_ACT_RW * T * cfg.d_model * ACT_B * cfg.n_layers
               + kv_cache_bytes(cfg, B, S))               # cache write
        data_ways = chips // mesh_model
        coll_dev = 0.0
        if tp:
            act = (T / data_ways) * cfg.d_model * ACT_B
            coll_dev += (_tp_ars_per_layer(cfg) / 2) * act * cfg.n_layers
        notes = "prefill: weights once + cache write + TP ARs"
    else:  # decode
        flops = fwd
        hbm = (active_weight_bytes(cfg, quant)
               + kv_cache_bytes(cfg, B, S, kv_quant)      # cache read
               + SERVE_ACT_RW * T * cfg.d_model * ACT_B * cfg.n_layers)
        coll_dev = 0.0
        if tp:
            act = max(T / (chips // mesh_model), 1) * cfg.d_model * ACT_B
            coll_dev += (_tp_ars_per_layer(cfg) / 2) * act * cfg.n_layers
        notes = "decode: weights + full KV read per token"
    return CellModel(flops=flops, hbm_bytes=hbm,
                     coll_bytes_per_dev=coll_dev, notes=notes)


def roofline_terms(cell: CellModel, chips: int = 256) -> dict:
    """The three roofline times of a cell on ``chips`` H100s, the one that
    bounds the step, and the compute share of that bound."""
    t_c = cell.flops / (chips * PEAK_FLOPS)
    t_m = cell.hbm_bytes / (chips * HBM_BW)
    t_x = cell.coll_bytes_per_dev / LINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    bound = terms[dom]
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "bound_s": bound,
            "roofline_fraction": t_c / bound if bound > 0 else 0.0}
