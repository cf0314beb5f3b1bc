"""The dense decoder stack: a Python loop over per-layer parameter dicts
(the JAX package scans over stacked layers; eager PyTorch needs no scan).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers


def apply_block(p, x, cfg, positions):
    """Prefill block.  Returns (x, {"k", "v", "k_pos"})."""
    h = layers.apply_norm(p["norm1"], x, cfg)
    y, (k, v, k_pos) = attention.attention_block(p["attn"], h, cfg, positions)
    x = x + y
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    return x + layers.apply_mlp(p["mlp"], h2, cfg), {"k": k, "v": v,
                                                     "k_pos": k_pos}


def apply_block_decode(p, x, cfg, positions, cache, block_tables,
                       active=None):
    """One-token decode block against the layer's pool (updated in place)."""
    h = layers.apply_norm(p["norm1"], x, cfg)
    y, cache = attention.paged_decode_attention_block(
        p["attn"], h, cfg, positions, cache, block_tables, active=active)
    x = x + y
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    return x + layers.apply_mlp(p["mlp"], h2, cfg), cache


def apply_decoder_stack(layer_params, x, cfg, positions):
    """Returns (x, per-layer states)."""
    states = []
    for p in layer_params:
        x, st = apply_block(p, x, cfg, positions)
        states.append(st)
    return x, states


def apply_decoder_stack_decode(layer_params, x, cfg, positions, pools,
                               block_tables, active=None):
    """Every layer indexes its own pool through the same block table."""
    for p, pool in zip(layer_params, pools):
        x, _ = apply_block_decode(p, x, cfg, positions, pool, block_tables,
                                  active=active)
    return x, pools


def insert_paged_stack_cache(pools, seq_kv, block_row, scratch_block):
    """Scatter one prefilled sequence into its pool blocks, in place.

    ``seq_kv`` is the batch-1 dense prefill cache (rows [0, C) in position
    order); ``block_row`` (n_bt,) names the physical block of each logical
    block, and -1 entries (pad-only rows past the request's allocation)
    route to ``scratch_block``, whose contents are never read."""
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
