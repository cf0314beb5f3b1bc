"""Float weights drawn from the run's seed, one group at a time.

A group is the embedding table, one decoder layer, or the head (final norm
and lm-head).  Each group's leaves come out of a single ``torch.randn``
call on the device, from a generator seeded by the run's seed and the
group's name, so any group can be drawn again alone and comes out the
same: the program's set-up draws every group once and hands the leaves to
the program's quantizer; the reference draws them again, one layer at a
time, after the window.

Matrices are normal with std fan_in^-1/2; a norm's scale is 1 + 0.1 N(0, 1),
so that a path that drops the scale shows in the check.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch


def layer_leaves(m: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of one decoder layer's leaves, in draw order;
    kind "norm" or "matrix"."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv, ff = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    out = [("norm1/scale", (d,), "norm"),
           ("attn/wq", (d, hq * hd), "matrix"),
           ("attn/wk", (d, hkv * hd), "matrix"),
           ("attn/wv", (d, hkv * hd), "matrix"),
           ("attn/wo", (hq * hd, d), "matrix"),
           ("norm2/scale", (d,), "norm")]
    if m["act"] == "swiglu":
        out.append(("mlp/w_gate", (d, ff), "matrix"))
    elif m["act"] != "gelu":
        raise ValueError(f"act {m['act']!r}: want swiglu or gelu")
    return out + [("mlp/w_up", (d, ff), "matrix"),
                  ("mlp/w_down", (ff, d), "matrix")]


def group_leaves(m: Dict, group: str) -> List[Tuple[str, tuple, str]]:
    if group == "embed":
        return [("embed", (m["vocab_size"], m["d_model"]), "matrix_rows")]
    if group == "head":
        return [("norm_f/scale", (m["d_model"],), "norm"),
                ("lm_head", (m["d_model"], m["vocab_size"]), "matrix")]
    if group.startswith("layers/"):
        return layer_leaves(m)
    raise KeyError(f"unknown weight group {group!r}")


def groups(m: Dict) -> List[str]:
    return (["embed"] + [f"layers/{i}" for i in range(m["n_layers"])]
            + ["head"])


def group_seed(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(m: Dict, seed: int, group: str, device) -> Dict[str, torch.Tensor]:
    """{leaf name: float32 tensor} of one group, from one randn call."""
    leaves = group_leaves(m, group)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    buf = torch.randn(sum(sizes), generator=gen, dtype=torch.float32,
                      device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        x = buf[at:at + n].view(shape)
        at += n
        if kind == "norm":
            # a new tensor: a view would keep the group's buffer alive
            out[name] = 1.0 + 0.1 * x
        else:
            fan_in = shape[1] if kind == "matrix_rows" else shape[0]
            out[name] = x.mul_(fan_in ** -0.5)
    return out

