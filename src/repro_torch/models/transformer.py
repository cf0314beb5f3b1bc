"""The decoder stack: a Python loop over per-layer parameter dicts (the JAX
package scans over stacked layers and groups; eager PyTorch needs no
scan), and whisper's encoder stack.  A layer is an attention block, an
RG-LRU ``rec`` block (the hybrid's pattern), a ``mamba`` block (the SSM:
a norm and the mixer, no FFN half) or an ``xattn`` block (whisper's
decoder: self attention, then cross attention over the encoder output);
see :func:`layer_kinds`.  The FFN half is the ``mlp`` or, for MoE, the
``moe`` experts, whose load-balancing auxiliary loss
:func:`apply_decoder_stack` sums over the layers (the training loss adds
it; serving drops it).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.quant import linear


def layer_kinds(cfg):
    """Per-layer block kind: the hybrid's pattern repeated (every scanned
    group's b0, b1, ... in order, then the tail the JAX package unrolls),
    "mamba" for the SSM, "xattn" for the encoder-decoder, "attn" for every
    other family."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return ["mamba"] * cfg.n_layers
    if cfg.family == "encdec":
        return ["xattn"] * cfg.n_layers
    return ["attn"] * cfg.n_layers


def _ffn(p, x, cfg):
    """The FFN half of a block over (B, S, d), normed input ``x``, and its
    auxiliary loss (MoE's load balance; None for an MLP)."""
    if cfg.family == "moe":
        return moe.moe_ffn(p["moe"], x, cfg)
    return layers.apply_mlp(p["mlp"], x, cfg), None


def _cross(p, x, cfg, enc_out):
    """An xattn block's cross-attention half: x + cross attention of its
    normed input over K/V projected from ``enc_out``."""
    hx = layers.apply_norm(p["norm_x"], x, cfg)
    ekv = attention.project_enc_kv(p["xattn"], enc_out, cfg)
    return x + attention.cross_attention_block(p["xattn"], hx, cfg, ekv)


def apply_block(p, x, cfg, kind, positions, ctx=None, row_lens=None,
                enc_out=None):
    """Prefill block (``ctx``: the layer's context KV; ``row_lens``: a
    burst's per-row attention extents; see
    :func:`attention.attention_block`; ``enc_out``: the encoder output an
    xattn block attends over).  Returns (x, state): {"k", "v", "k_pos"}
    of an attention or xattn block, {"h", "conv"} of a rec block and
    {"ssm", "conv"} of a mamba block (recurrent bursts' rows all have one
    length: the engine never pads them)."""
    return _apply_block_aux(p, x, cfg, kind, positions, ctx, row_lens,
                            enc_out)[:2]


def _apply_block_aux(p, x, cfg, kind, positions, ctx=None, row_lens=None,
                     enc_out=None):
    """:func:`apply_block` and the block's auxiliary loss (None but for
    an MoE FFN)."""
    h = layers.apply_norm(p["norm1"], x, cfg)
    if kind == "mamba":
        y, state = ssm.mamba_block(p["mamba"], h, cfg)
        return x + y, state, None
    if kind == "rec":
        y, state = rglru.rglru_block(p["rec"], h, cfg)
    else:
        y, (k, v, k_pos) = attention.attention_block(
            p["attn"], h, cfg, positions, ctx=ctx, row_lens=row_lens)
        state = {"k": k, "v": v, "k_pos": k_pos}
    x = x + y
    if kind == "xattn":
        x = _cross(p, x, cfg, enc_out)
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    y2, aux = _ffn(p, h2, cfg)
    return x + y2, state, aux


def _freeze_inactive_state(new_state, old_state, active):
    """Recurrent state rows kept as they were where ``active`` is False:
    the masked-decode contract for continuous batching.  State leaves carry
    batch on axis 0.  ``torch.where`` on the device, so a decode graph
    captures it."""
    if active is None:
        return new_state
    out = {}
    for name, n in new_state.items():
        mask = active.reshape(active.shape[0], *([1] * (n.ndim - 1)))
        out[name] = torch.where(mask, n, old_state[name])
    return out


def apply_block_decode(p, x, cfg, kind, positions, cache, block_tables=None,
                       active=None, enc_out=None):
    """One-token decode block against the layer's pool, its dense slab
    when ``block_tables`` is None, or (``kind`` "rec" / "mamba") its
    recurrent state; the cache is updated in place.  An xattn block
    re-projects K/V from the whole ``enc_out`` at every step, as the
    reference does."""
    h = layers.apply_norm(p["norm1"], x, cfg)
    if kind in ("rec", "mamba"):
        step = (rglru.rglru_decode_step if kind == "rec"
                else ssm.mamba_decode_step)
        y, new = step(p[kind], h, cfg, cache)
        for name, t in _freeze_inactive_state(new, cache, active).items():
            cache[name].copy_(t)
        if kind == "mamba":
            return x + y, cache
    elif block_tables is None:
        y, cache = attention.decode_attention_block(
            p["attn"], h, cfg, positions, cache, active=active)
    else:
        y, cache = attention.paged_decode_attention_block(
            p["attn"], h, cfg, positions, cache, block_tables, active=active)
    x = x + y
    if kind == "xattn":
        x = _cross(p, x, cfg, enc_out)
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    return x + _ffn(p, h2, cfg)[0], cache


def apply_block_verify(p, x, cfg, positions, cache, block_tables,
                       active=None):
    """k-token verify block: the attention half through
    :func:`attention.paged_verify_attention_block`; norms and the FFN are
    shape-generic over (B, k, d) (an MoE FFN routes the k tokens as one
    row: capacity from S = k)."""
    h = layers.apply_norm(p["norm1"], x, cfg)
    y, cache = attention.paged_verify_attention_block(
        p["attn"], h, cfg, positions, cache, block_tables, active=active)
    x = x + y
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    return x + _ffn(p, h2, cfg)[0], cache


def apply_decoder_stack(layer_params, x, cfg, positions, ctx_kv=None,
                        row_lens=None, enc_out=None):
    """Returns (x, per-layer states, aux): ``aux`` the f32 scalar sum of
    the layers' auxiliary losses in layer order (0 without MoE).
    ``ctx_kv``: one context dict per layer (:func:`gather_paged_ctx`), or
    None; ``row_lens``: a burst's per-row attention extents, or None;
    ``enc_out``: the encoder output (encoder-decoder only)."""
    states = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, kind) in enumerate(zip(layer_params, layer_kinds(cfg))):
        x, st, a = _apply_block_aux(
            p, x, cfg, kind, positions,
            ctx=None if ctx_kv is None else ctx_kv[i], row_lens=row_lens,
            enc_out=enc_out)
        states.append(st)
        if a is not None:
            aux = aux + a
    return x, states, aux


def apply_decoder_stack_decode(layer_params, x, cfg, positions, pools,
                               block_tables=None, active=None, enc_out=None):
    """Every attention layer indexes its own pool through the same block
    table, or (``block_tables`` None) reads and writes its own dense slab;
    a rec or mamba layer updates its own state; an xattn layer also
    attends over ``enc_out``."""
    for p, kind, pool in zip(layer_params, layer_kinds(cfg), pools):
        x, _ = apply_block_decode(p, x, cfg, kind, positions, pool,
                                  block_tables, active=active,
                                  enc_out=enc_out)
    return x, pools


def apply_decoder_stack_verify(layer_params, x, cfg, positions, pools,
                               block_tables, active=None):
    """The speculative verify over every layer: x (B, k, d), each layer
    writing and reading its own pool through the same block table."""
    for p, pool in zip(layer_params, pools):
        x, _ = apply_block_verify(p, x, cfg, positions, pool, block_tables,
                                  active=active)
    return x, pools


def apply_encoder_stack(enc_layers, x, cfg):
    """whisper's encoder over frame embeddings x (B, F, d): per layer,
    non-causal self attention (each row alone: see
    :func:`attention.rowwise_sdpa`) and the GELU MLP, both pre-norm with
    residuals.  ``enc_layers``: one dict per layer."""
    B, S, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm = cfg.quant_mode
    for bp in enc_layers:
        h = layers.apply_norm(bp["norm1"], x, cfg)
        q = linear(bp["attn"]["wq"], h, qm).reshape(B, S, hq, hd)
        k = linear(bp["attn"]["wk"], h, qm).reshape(B, S, hkv, hd)
        v = linear(bp["attn"]["wv"], h, qm).reshape(B, S, hkv, hd)
        o = attention.rowwise_sdpa(q, k, v, causal=False)
        x = x + linear(bp["attn"]["wo"], o.reshape(B, S, -1), qm)
        h2 = layers.apply_norm(bp["norm2"], x, cfg)
        x = x + layers.apply_mlp(bp["mlp"], h2, cfg)
    return x


def gather_paged_ctx(pools, ctx_ids, dtype):
    """The context KV of a suffix prefill, gathered out of the pools.

    ``ctx_ids`` (nctx,) are physical block ids covering absolute positions
    ``[0, nctx * block_size)`` in logical order.  Returns one
    ``{"k", "v": (1, nctx * bs, Hkv, D)}`` dict per layer; int8 pools are
    dequantized into ``dtype``.  Advanced indexing copies, so the context
    is a snapshot: the insert that follows may write the pools freely."""
    ids = ctx_ids.long()

    def gather(pool):
        got = pool[ids]                               # (nctx, bs, Hkv, ·)
        return got.reshape(1, got.shape[0] * got.shape[1], *got.shape[2:])

    out = []
    for pool in pools:
        if "k_scale" in pool:
            out.append({
                "k": attention._kv_dequantize(gather(pool["k"]),
                                              gather(pool["k_scale"]), dtype),
                "v": attention._kv_dequantize(gather(pool["v"]),
                                              gather(pool["v_scale"]),
                                              dtype)})
        else:
            out.append({"k": gather(pool["k"]), "v": gather(pool["v"])})
    return out


def slice_stack_cache(kv, row):
    """Batch row ``row`` of a batched dense cache as a batch-1 cache (views,
    no copy); every leaf, KV or recurrent state, has batch on axis 0."""
    return [{name: t[row:row + 1] for name, t in layer.items()}
            for layer in kv]


def insert_stack_cache(kv, seq_kv, slot):
    """Write a batch-1 dense cache into row ``slot`` of the engine's dense
    slabs, in place: every leaf (``k_pos`` and recurrent state included)
    of the slot's row."""
    for big, small in zip(kv, seq_kv):
        for name, buf in big.items():
            buf[slot] = small[name][0].to(buf.dtype)
    return kv


def insert_paged_stack_cache(pools, seq_kv, block_row, scratch_block):
    """Scatter one prefilled sequence into its pool blocks, in place.

    ``seq_kv`` is the batch-1 dense prefill cache (rows [0, C) in position
    order); ``block_row`` names the physical block of each logical block
    from the sequence's first row on (a suffix prefill passes the table
    row past its context blocks), and -1 entries (pad-only rows past the
    request's allocation) route to ``scratch_block``, whose contents are
    never read."""
    for pool, seq in zip(pools, seq_kv):
        for name, buf in pool.items():
            rows = seq[name][0]                       # (C, Hkv, ·)
            bs = buf.shape[1]
            C = rows.shape[0]
            nb = -(-C // bs)
            if nb * bs != C:
                pad = rows.new_zeros((nb * bs - C,) + tuple(rows.shape[1:]))
                rows = torch.cat([rows, pad], dim=0)
            rows = rows.reshape(nb, bs, *rows.shape[1:])
            ids = block_row[:nb]
            dest = torch.where(ids >= 0, ids,
                               torch.full_like(ids, scratch_block)).long()
            buf[dest] = rows.to(buf.dtype)
    return pools
