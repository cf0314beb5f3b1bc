"""Attention for the dense family: GQA with qk-norm and RoPE, plain
prefill attention, and single-token decode against the paged block pool.

Prefill attention has no hand kernel (the JAX package leaves it to XLA):
it is plain PyTorch here, processed in query chunks of ``Q_CHUNK`` so the
live score tensor stays (B, H, Q_CHUNK, S).  The decode read side goes
through ``kernels.ops.paged_decode_attention`` — the CUDA flash-decode
kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.quant import linear

Q_CHUNK = 512
NEG_INF = -1e30


def _grouped_scores(q, k):
    """q (B, Sq, Hq, D), k (B, Skv, Hkv, D) -> (B, Hq, Sq, Skv) f32."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(B, Hq, Sq, k.shape[1]) * (D ** -0.5)


def _weighted_values(probs, v, Hq):
    """probs (B, Hq, Sq, Skv) f32, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    B, _, Sq, Skv = probs.shape
    Hkv, D = v.shape[2], v.shape[3]
    pg = probs.reshape(B, Hkv, Hq // Hkv, Sq, Skv)
    o = torch.einsum("bhgqk,bkhd->bqhgd",
                     pg.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.reshape(B, Sq, Hq, D).to(v.dtype)


def _mask(q_pos, k_pos, causal):
    """(B, Sq, Skv) validity from absolute positions (k_pos -1 = empty)."""
    m = (k_pos[:, None, :] >= 0).expand(q_pos.shape[0], q_pos.shape[1],
                                        k_pos.shape[1])
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    return m


def sdpa(q, k, v, q_pos, k_pos, *, causal=True, q_chunk=Q_CHUNK):
    """Chunked attention.  q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); q_pos (B,Sq),
    k_pos (B,Skv) absolute positions."""
    Hq = q.shape[2]
    outs = []
    for c0 in range(0, q.shape[1], q_chunk):
        q_c, qp_c = q[:, c0:c0 + q_chunk], q_pos[:, c0:c0 + q_chunk]
        s = _grouped_scores(q_c, k)
        m = _mask(qp_c, k_pos, causal)[:, None]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
        outs.append(_weighted_values(torch.softmax(s, dim=-1), v, Hq))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm = cfg.quant_mode
    q = linear(p["wq"], x, qm).reshape(B, S, hq, hd)
    k = linear(p["wk"], x, qm).reshape(B, S, hkv, hd)
    v = linear(p["wv"], x, qm).reshape(B, S, hkv, hd)
    if "q_norm_scale" in p:
        q = layers.rms_head_norm(p["q_norm_scale"], q, cfg.norm_eps)
        k = layers.rms_head_norm(p["k_norm_scale"], k, cfg.norm_eps)
    return (layers.apply_rope(q, positions, cfg),
            layers.apply_rope(k, positions, cfg), v)


def attention_block(p, x, cfg, positions):
    """Prefill self-attention.  Returns (y, (k, v, k_pos))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, positions, positions, causal=True)
    B, S = x.shape[:2]
    y = linear(p["wo"], o.reshape(B, S, -1), cfg.quant_mode)
    return y, (k, v, positions)


def _kv_quantize(t):
    """(..., D) -> int8 codes + per-entry scale (..., 1) f32."""
    tf = t.to(torch.float32)
    amax = torch.clamp_min(tf.abs().amax(dim=-1, keepdim=True), 1e-8)
    scale = amax / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def paged_decode_attention_block(p, x, cfg, positions, cache, block_tables,
                                 active=None):
    """Single-token decode against a paged block pool.

    cache: {"k", "v": (N, bs, Hkv, D)} (+ "k_scale"/"v_scale"
    (N, bs, Hkv, 1) f32 for kv_quant="int8"), the last B blocks being
    per-slot scratch.  The new token's KV goes to (block_tables[b, pos//bs],
    pos % bs); inactive, table-less or table-overflowing slots write to
    their own scratch block instead.  The pools are updated IN PLACE (the
    JAX package donated them); the same dict is returned.
    """
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    B = x.shape[0]
    N, bs = cache["k"].shape[0], cache["k"].shape[1]
    n_bt = block_tables.shape[1]
    pos = positions[:, 0]
    li = pos // bs
    off = (pos % bs).long()
    # past the table's extent must NOT clamp into the last logical block
    # (another token's block): overflow routes to scratch like pb < 0
    in_range = li < n_bt
    pb = torch.gather(block_tables, 1,
                      torch.clamp(li, max=n_bt - 1)[:, None].long())[:, 0]
    ok = (pb >= 0) & in_range
    if active is not None:
        ok = ok & active
    scratch = N - B + torch.arange(B, dtype=pb.dtype, device=pb.device)
    dest = torch.where(ok, pb, scratch).long()
    if "k_scale" in cache:
        kq, ks = _kv_quantize(k_new[:, 0])
        vq, vs = _kv_quantize(v_new[:, 0])
        cache["k"][dest, off] = kq
        cache["v"][dest, off] = vq
        cache["k_scale"][dest, off] = ks
        cache["v_scale"][dest, off] = vs
    else:
        cache["k"][dest, off] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][dest, off] = v_new[:, 0].to(cache["v"].dtype)
    o = ops.paged_decode_attention(
        q[:, 0].contiguous(), cache["k"], cache["v"], block_tables,
        pos.to(torch.int32).contiguous(),
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    y = linear(p["wo"], o.reshape(B, 1, -1), cfg.quant_mode)
    return y, cache


def init_paged_kv_cache(cfg, n_total, block_size, dtype=torch.bfloat16,
                        device=None):
    """Block-pool KV storage for one layer: ``n_total`` blocks of
    ``block_size`` positions (the tail ``max_batch`` blocks are scratch),
    on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (n_total, block_size, hkv, hd)
    if cfg.kv_quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
