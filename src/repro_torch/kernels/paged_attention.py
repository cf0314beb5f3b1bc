"""Paged-decode attention over the block-pool KV cache.

``paged_attention_ref`` is the plain PyTorch version — the exact math of
the JAX package's ``paged_attention_ref`` (gather, synthesized key
positions, masked softmax, the same dtype casts) — and what a CPU tensor
runs.  ``paged_attention_cuda`` wraps the hand-written kernel in
``csrc/paged_attention.cu``, which replaces the Pallas
``paged_attention_pallas``.

Rows with no visible key: the kernel returns exact zeros (as the Pallas
kernel does); the plain version returns the unmasked softmax average over
garbage.  Serving discards those rows, so comparisons cover rows with at
least one visible key.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _gather(pool, block_tables):
    """pool (N, bs, ...) indexed by (B, n_bt) tables -> (B, n_bt*bs, ...);
    -1 entries clamp to block 0 (masked by the synthesized positions)."""
    B, n_bt = block_tables.shape
    g = pool[block_tables.clamp_min(0).long()]
    return g.reshape(B, n_bt * pool.shape[1], *pool.shape[2:])


def synth_positions(block_tables, block_size):
    """(B, n_bt) tables -> (B, n_bt*bs) absolute key positions; -1 entries
    and every offset in them are invalid (-1)."""
    B, n_bt = block_tables.shape
    dev = block_tables.device
    base = (torch.arange(n_bt, dtype=torch.int32, device=dev)[None, :, None]
            * block_size
            + torch.arange(block_size, dtype=torch.int32,
                           device=dev)[None, None, :])
    return torch.where(block_tables[:, :, None] >= 0, base,
                       torch.full_like(base, -1)).reshape(B, n_bt * block_size)


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos,
                        k_scale=None, v_scale=None):
    """q (B, Hq, D); pools (N, bs, Hkv, D); block_tables (B, n_bt) int32
    (-1 = unallocated); pos (B,); optional per-entry scales (N, bs, Hkv, 1)
    f32 for int8 pools.  Returns (B, Hq, D)."""
    B, Hq, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = Hq // Hkv
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    if k_scale is not None:
        k = (k.to(torch.float32)
             * _gather(k_scale, block_tables)).to(q.dtype)
        v = (v.to(torch.float32)
             * _gather(v_scale, block_tables)).to(q.dtype)
    k_pos = synth_positions(block_tables, bs)                   # (B, S)
    S = k_pos.shape[1]
    qg = q.reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    s = s.reshape(B, Hq, 1, S) * (D ** -0.5)
    m = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :]
                                    <= pos.reshape(B, 1, 1))
    s = torch.where(m[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(B, Hkv, G, 1, S)
    o = torch.einsum("bhgqk,bkhd->bqhgd",
                     pg.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.reshape(B, 1, Hq, D).to(v.dtype)[:, 0]


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.paged_attention.argtypes = [_P] * 9 + [_I] * 10 + [_P]
        lib.paged_attention.restype = _I
        lib._argtypes_set = True
    return lib


# the kernel's limits (csrc/paged_attention.cu, which checks them and
# returns an error past them): a split's table entries sit in a shared list
# of MAX_CHUNK; a lane holds 8 elements of a row, so D <= 256; a block takes
# 1, 2, 4 or 8 query heads of one kv head
MAX_CHUNK = 512
MAX_D = 256
MAX_HEADS = 8
MIN_SPLIT_ROWS = 128           # key rows per split: 2 steps of 8 warps


def heads_per_block(G):
    """Query heads a block takes of the G that share its kv head: 1, 2, 4
    or 8.  The kernel is told this number; it does not choose its own."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else MAX_HEADS


def head_groups(G):
    """Blocks per kv head (the grid's head_groups)."""
    return -(-G // heads_per_block(G))


def split_plan(B, Hkv, G, n_bt, block_size, n_sm=132):
    """(chunk, n_split): table entries per split and the number of splits.
    Chosen from the shapes alone, never from ``pos`` (a device sync): as
    many splits as one wave of B*Hkv*head_groups*n_split blocks holds on
    ``n_sm`` SMs (one 8-warp block fills an SM: its registers on the
    CUDA-core path, its shared ring on the tensor-core path; a second wave
    or a merge costs more than the splits gain), none shorter than
    MIN_SPLIT_ROWS key rows, none longer than MAX_CHUNK entries."""
    blocks = B * Hkv * head_groups(G)
    want = max(1, n_sm // blocks)
    min_chunk = -(-MIN_SPLIT_ROWS // block_size)
    chunk = min(MAX_CHUNK, n_bt, max(min_chunk, -(-n_bt // want)))
    return chunk, -(-n_bt // chunk)


def paged_attention_cuda(q, k_pool, v_pool, block_tables, pos,
                         k_scale=None, v_scale=None):
    """The CUDA split-KV flash-decode kernel; same signature as the plain
    version.  Takes contiguous CUDA tensors only and raises on anything
    else.  One call is one kernel launch, or two (split, then merge) when
    the table is split; ``launches`` counts calls."""
    if not q.is_cuda:
        raise ValueError("the CUDA paged attention takes CUDA tensors; a "
                         "CPU tensor goes to paged_attention_ref")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"want q (B, Hq, D) and pools (N, bs, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, D = q.shape
    N, bs, Hkv, Dk = k_pool.shape
    quant = k_scale is not None
    if (Dk != D or v_pool.shape != k_pool.shape or Hq % Hkv
            or Hq // Hkv > 128 or D > MAX_D):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"(D <= {MAX_D})")
    if q.dtype not in _Q_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("scaled pools must hold int8 codes")
        for s in (k_scale, v_scale):
            if (s is None or s.dtype != torch.float32
                    or tuple(s.shape) != (N, bs, Hkv, 1)):
                raise ValueError("int8 pools need float32 (N, bs, Hkv, 1) "
                                 "k_scale and v_scale")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"a float pool must match q's dtype {q.dtype}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != B):
        raise ValueError("block_tables must be int32 (B, n_bt)")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError("pos must be int32 (B,)")
    tensors = [q, k_pool, v_pool, block_tables, pos]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("every input must be contiguous and on "
                             f"{q.device}")
    n_bt = block_tables.shape[1]
    chunk, n_split = split_plan(B, Hkv, Hq // Hkv, n_bt, bs,
                                _build.sm_count(q.device.index or 0))
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    # the splits' partial (m, l, acc) rows, merged by a second kernel
    part = (torch.empty((B, Hq, n_split, D + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    err = _lib().paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, Hq, Hkv, D, n_bt, bs, chunk, heads_per_block(Hq // Hkv),
        _Q_CODE[q.dtype],
        _KV_CODE[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# Traffic model.
# ---------------------------------------------------------------------------
def gathered_bytes(B, n_bt, bs, n_kv, head_dim, *, quantized, act_bytes=2):
    """Bytes of dense temporaries a gather read path materializes per decode
    step per layer — what the paged kernel avoids."""
    entries = B * n_bt * bs * n_kv
    pool_bytes = 1 if quantized else act_bytes
    total = 2 * entries * head_dim * pool_bytes
    if quantized:
        total += 2 * entries * 4
        total += 2 * entries * head_dim * act_bytes
    return total


def streamed_bytes(n_valid_entries, bs, n_kv, head_dim, *, quantized,
                   act_bytes=2):
    """Pool bytes the kernel streams: each valid block-table entry's K and V
    block (plus scales when quantized), read once."""
    per_entry = bs * n_kv * head_dim * (1 if quantized else act_bytes)
    total = 2 * n_valid_entries * per_entry
    if quantized:
        total += 2 * n_valid_entries * bs * n_kv * 4
    return total
