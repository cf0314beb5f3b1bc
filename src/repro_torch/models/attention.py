"""Attention for the attention layers of every ported family: GQA with
qk-norm and RoPE (M-RoPE's (B, 3, S) streams included: its temporal
stream drives cache slots and masks), causal and sliding-window masks,
plain prefill attention, single-token decode against the paged block
pool or the dense per-slot slab (a ring buffer of ``window`` positions
for SWA), and whisper's cross attention over the encoder output.

Prefill attention and the dense decode read have no hand kernel (the JAX
package leaves both to XLA): they are plain PyTorch here, processed in
query chunks of ``Q_CHUNK`` so the live score tensor stays (B, H, Q_CHUNK,
S).  The paged decode read side goes through
``kernels.ops.paged_decode_attention`` — the CUDA flash-decode kernel for
a CUDA tensor.
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


def _mask(q_pos, k_pos, causal, window=0):
    """(B, Sq, Skv) validity from absolute positions (k_pos -1 = empty);
    ``window`` > 0 keeps only keys less than ``window`` positions back."""
    m = (k_pos[:, None, :] >= 0).expand(q_pos.shape[0], q_pos.shape[1],
                                        k_pos.shape[1])
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        m = m & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return m


def sdpa(q, k, v, q_pos, k_pos, *, causal=True, window=0, q_chunk=Q_CHUNK):
    """Chunked attention.  q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); q_pos (B,Sq),
    k_pos (B,Skv) absolute positions (they drive the causal and window
    masks, so a ring-buffer layout needs nothing else)."""
    Hq = q.shape[2]
    outs = []
    for c0 in range(0, q.shape[1], q_chunk):
        q_c, qp_c = q[:, c0:c0 + q_chunk], q_pos[:, c0:c0 + q_chunk]
        s = _grouped_scores(q_c, k)
        m = _mask(qp_c, k_pos, causal, window)[:, None]
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


def _window(cfg) -> int:
    return cfg.window if cfg.attn_type == "swa" else 0


def cache_extent(cfg, seq_len: int) -> int:
    """A dense slab's extent for ``seq_len`` positions: the whole length,
    or the window for SWA if that is less (the ring)."""
    return min(seq_len, cfg.window) if _window(cfg) else seq_len


def _rowwise_sdpa(q, k, v, positions, row_lens, window):
    """A burst's attention, row by row: row i attends over its first
    ``row_lens[i]`` positions (its bucketed prompt), exactly the shapes its
    prefill has alone, so its outputs round the same whatever the burst's
    longest row.  Outputs past a row's length (burst padding) are zeros."""
    o = torch.zeros_like(q)
    for i, n in enumerate(row_lens):
        pos = positions[i:i + 1, :n]
        o[i:i + 1, :n] = sdpa(q[i:i + 1, :n].contiguous(),
                              k[i:i + 1, :n].contiguous(),
                              v[i:i + 1, :n].contiguous(), pos, pos,
                              causal=True, window=window)
    return o


def attention_block(p, x, cfg, positions, ctx=None, row_lens=None):
    """Prefill self-attention.  Returns (y, (k, v, k_pos)).

    ``ctx`` (the suffix prefill of the prefix cache and of chunked
    prefill): ``{"k", "v": (B, P, Hkv, D)}`` of already-rotated context KV
    at absolute positions ``[0, P)``, gathered from the pool.
    ``positions`` then start at ``P``; queries attend over the context
    keys followed by the fresh ones (RoPE and the causal mask are driven
    by absolute positions), and the returned state covers the fresh
    suffix only.

    ``row_lens`` (a burst prefill, no ``ctx``): per-row attention extents,
    see :func:`_rowwise_sdpa`; the projections still run over the whole
    burst."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    positions = layers.positions_1d(positions)
    if row_lens is not None:
        o = _rowwise_sdpa(q, k, v, positions, row_lens, _window(cfg))
        B, S = x.shape[:2]
        y = linear(p["wo"], o.reshape(B, S, -1), cfg.quant_mode)
        return y, (k, v, positions)
    k_all, v_all, kpos_all = k, v, positions
    if ctx is not None:
        ck, cv = ctx["k"], ctx["v"]
        cpos = torch.arange(ck.shape[1], dtype=positions.dtype,
                            device=positions.device)[None].expand(
            x.shape[0], ck.shape[1])
        k_all = torch.cat([ck.to(k.dtype), k], dim=1)
        v_all = torch.cat([cv.to(v.dtype), v], dim=1)
        kpos_all = torch.cat([cpos, positions], dim=1)
    o = sdpa(q, k_all, v_all, positions, kpos_all, causal=True,
             window=_window(cfg))
    B, S = x.shape[:2]
    y = linear(p["wo"], o.reshape(B, S, -1), cfg.quant_mode)
    return y, (k, v, positions)


def rowwise_sdpa(q, k, v, causal):
    """Plain attention of each batch row alone over all its keys
    (positions 0, ..., S-1 of q and k): a prefill row's outputs then do
    not depend on the batch it runs in (a burst or alone)."""
    qp = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)[None]
    kp = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)[None]
    outs = [sdpa(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp, kp, causal=causal)
            for i in range(q.shape[0])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


def project_enc_kv(p, enc_out, cfg):
    """Cross attention's K and V, (B, F, Hkv, D) each, from the encoder
    output (B, F, d): two PSI matmuls over all B x F rows."""
    B, S, _ = enc_out.shape
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    k = linear(p["wk"], enc_out, cfg.quant_mode).reshape(B, S, hkv, hd)
    v = linear(p["wv"], enc_out, cfg.quant_mode).reshape(B, S, hkv, hd)
    return k, v


def cross_attention_block(p, x, cfg, enc_kv):
    """Encoder-decoder cross attention (whisper): queries from x (B, S, d)
    over ``enc_kv`` = (k, v) of :func:`project_enc_kv`, with no rotation
    and no mask (every frame visible; no qk-norm).  A prefill (S > 1)
    attends row by row, a decode step over the whole batch."""
    B, S, _ = x.shape
    hd, hq = cfg.resolved_head_dim, cfg.n_heads
    q = linear(p["wq"], x, cfg.quant_mode).reshape(B, S, hq, hd)
    k, v = enc_kv
    if S > 1:
        o = rowwise_sdpa(q, k, v, causal=False)
    else:
        o = sdpa(q, k, v, torch.zeros((B, S), dtype=torch.int32,
                                      device=x.device),
                 torch.zeros((B, k.shape[1]), dtype=torch.int32,
                             device=x.device), causal=False)
    return linear(p["wo"], o.reshape(B, S, -1), cfg.quant_mode)


def _kv_quantize(t):
    """(..., D) -> int8 codes + per-entry scale (..., 1) f32."""
    tf = t.to(torch.float32)
    amax = torch.clamp_min(tf.abs().amax(dim=-1, keepdim=True), 1e-8)
    scale = amax / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _masked_row_write(buf, bidx, slot, new_val, active):
    """``buf[b, slot[b]] = new_val[b]`` in place, only where ``active[b]``
    (inactive slots run through the step but their rows stay as they
    are)."""
    new_val = new_val.to(buf.dtype)
    if active is not None:
        mask = active.reshape(-1, *([1] * (new_val.ndim - 1)))
        new_val = torch.where(mask, new_val, buf[bidx, slot])
    buf[bidx, slot] = new_val


def decode_attention_block(p, x, cfg, positions, cache, active=None):
    """Single-token decode against the dense per-slot slab, a ring buffer
    when the extent is below the position (SWA).

    cache: {"k", "v": (B, C, Hkv, D), "k_pos": (B, C) int32 (-1 = empty)}
    (+ int8 codes with "k_scale"/"v_scale" (B, C, Hkv, 1) f32 under
    kv_quant="int8").  The new token's KV goes to ring slot ``pos % C`` of
    its row, for active rows only.  The read is the plain ``sdpa`` over the
    whole slab, masked by ``k_pos`` (and the window).  The slab is updated
    IN PLACE (the JAX package donated it); the same dict is returned."""
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    positions = layers.positions_1d(positions)
    B = x.shape[0]
    pos = positions[:, 0]
    slot = (pos % cache["k"].shape[1]).long()
    bidx = torch.arange(B, device=x.device)
    _masked_row_write(cache["k_pos"], bidx, slot, pos, active)
    if "k_scale" in cache:
        kq, ks = _kv_quantize(k_new[:, 0])
        vq, vs = _kv_quantize(v_new[:, 0])
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _masked_row_write(cache[name], bidx, slot, val, active)
        k = _kv_dequantize(cache["k"], cache["k_scale"], x.dtype)
        v = _kv_dequantize(cache["v"], cache["v_scale"], x.dtype)
    else:
        _masked_row_write(cache["k"], bidx, slot, k_new[:, 0], active)
        _masked_row_write(cache["v"], bidx, slot, v_new[:, 0], active)
        k, v = cache["k"], cache["v"]
    o = sdpa(q, k, v, positions, cache["k_pos"], causal=True,
             window=_window(cfg))
    y = linear(p["wo"], o.reshape(B, 1, -1), cfg.quant_mode)
    return y, cache


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
    pos = layers.positions_1d(positions)[:, 0]
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


def paged_verify_attention_block(p, x, cfg, positions, cache, block_tables,
                                 active=None):
    """The k-token speculative verify against the paged pool.

    ``x`` (B, k, d) holds the round's feed token and the first k-1 drafts;
    ``positions`` (B, k) their consecutive absolute positions.  All k new
    KV entries scatter first, over what the draft pass wrote there (the
    target owns those entries from now on; a rejected tail is overwritten
    before any later query reads it), with the decode block's routing:
    inactive, table-less or table-overflowing entries go to the row's
    scratch block.  The read then flattens the queries to (B*k) rows
    through the same kernel as decode, each row with its own position and
    its slot's table (repeated in ``jnp.repeat``'s row order).  k <= the
    block size keeps the k writes of a row at distinct offsets.  The pools
    are updated in place."""
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    B, S = x.shape[:2]
    N, bs = cache["k"].shape[0], cache["k"].shape[1]
    n_bt = block_tables.shape[1]
    assert S <= bs, (f"verify width k={S} > block_size={bs}: consecutive "
                     f"positions would collide in one block's offsets")
    li = positions // bs                                           # (B, k)
    off = (positions % bs).long().reshape(-1)
    in_range = li < n_bt
    pb = torch.gather(block_tables, 1, torch.clamp(li, max=n_bt - 1).long())
    ok = (pb >= 0) & in_range
    if active is not None:
        ok = ok & active[:, None]
    scratch = N - B + torch.arange(B, dtype=pb.dtype,
                                   device=pb.device)[:, None]
    dest = torch.where(ok, pb, scratch).long().reshape(-1)         # (B*k,)

    def scatter(pool, vals):                                       # (B,k,H,·)
        pool[dest, off] = vals.reshape(B * S, *vals.shape[2:]).to(pool.dtype)

    if "k_scale" in cache:
        kq, ks = _kv_quantize(k_new)
        vq, vs = _kv_quantize(v_new)
        for name, vals in (("k", kq), ("v", vq), ("k_scale", ks),
                           ("v_scale", vs)):
            scatter(cache[name], vals)
    else:
        scatter(cache["k"], k_new)
        scatter(cache["v"], v_new)
    tables = block_tables[:, None, :].expand(B, S, n_bt).reshape(B * S, n_bt)
    o = ops.paged_decode_attention(
        q.reshape(B * S, *q.shape[2:]).contiguous(), cache["k"], cache["v"],
        tables, positions.reshape(-1).to(torch.int32).contiguous(),
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    y = linear(p["wo"], o.reshape(B, S, -1), cfg.quant_mode)
    return y, cache


def init_kv_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device=None):
    """Dense slab KV storage for one layer on ``device`` (CUDA unless the
    caller names another): extent ``seq_len``, or ``min(seq_len, window)``
    for SWA; every ``k_pos`` -1 (empty)."""
    device = resolve_device(device)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (batch, cache_extent(cfg, seq_len), hkv, hd)
    cache = {"k_pos": torch.full(shape[:2], -1, dtype=torch.int32,
                                 device=device)}
    if cfg.kv_quant == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(
                shape[:3] + (1,), dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


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
