"""Operations and bytes of the dense decoder, from its widths alone.

The benchmark's own yardstick: what the inputs need, never what a kernel
happens to do.  A multiply-add is 2 operations.  A prefill needs the
lm-head on one row a prompt (the serve keeps only the last row's logits)
and causal attention over n(n+1)/2 query-key pairs; a decode token at
context c (keys, itself included) needs every projection once, the
lm-head once, and c query-key pairs a head.  A decode step reads every
PSI weight once: its codes (bits / 8 bytes a weight where bit-planes pack
it, 1 byte otherwise) and its float32 scale per output channel.  The
embedding is a row gather and is not counted.

H100 SXM peaks (NVIDIA's data sheet, dense): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def matrices(m: Dict) -> List[Tuple[int, int]]:
    """(K, N) of each PSI matrix of one layer."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv, ff = m["n_heads"] * hd, m["n_kv_heads"] * hd, m["d_ff"]
    out = [(d, q), (d, kv), (d, kv), (q, d)]
    if m["act"] == "swiglu":
        out.append((d, ff))
    return out + [(d, ff), (ff, d)]


def layer_macs(m: Dict) -> int:
    """Projection multiply-adds of one token through all layers."""
    return m["n_layers"] * sum(k * n for k, n in matrices(m))


def head_macs(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def _attn_pair_macs(m: Dict) -> int:
    """Multiply-adds of one query-key pair over all heads and layers (the
    score and the weighted value)."""
    return m["n_layers"] * 2 * m["n_heads"] * m["head_dim"]


def decode_flops(m: Dict, contexts: Iterable[int]) -> float:
    """Operations of decoding one token at each context."""
    cs = list(contexts)
    per = layer_macs(m) + head_macs(m)
    return 2.0 * (per * len(cs) + _attn_pair_macs(m) * sum(cs))


def prefill_flops(m: Dict, prompt_lens: Iterable[int]) -> float:
    """Operations of prefilling each prompt: every projection on each
    true token, causal attention, the lm-head on its last row."""
    total = 0.0
    for n in prompt_lens:
        total += (layer_macs(m) * n + head_macs(m)
                  + _attn_pair_macs(m) * n * (n + 1) / 2)
    return 2.0 * total


def prefill_psi_flops(m: Dict, prompt_lens: Iterable[int]) -> float:
    """The PSI matmuls' share of :func:`prefill_flops` (no attention)."""
    return 2.0 * sum(layer_macs(m) * n + head_macs(m) for n in prompt_lens)


def code_bytes(k: int, n: int, bits: int, pack: bool) -> float:
    planes = pack and bits < 8 and k % 8 == 0
    return k * n * (bits / 8.0 if planes else 1.0) + 4.0 * n


def decode_weight_bytes(m: Dict, bits: int, pack: bool) -> float:
    """Bytes of PSI weights one decode step reads: every layer's matrices
    and the lm-head, codes and scales, once."""
    per = sum(code_bytes(k, n, bits, pack) for k, n in matrices(m))
    return (m["n_layers"] * per
            + code_bytes(m["d_model"], m["vocab_size"], bits, pack))
