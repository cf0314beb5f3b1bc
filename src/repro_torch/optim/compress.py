"""INT8 gradient compression with error feedback (the JAX package's
cross-pod all-reduce payload trick): each leaf, plus the residual carried
from the last step, is quantized to int8 codes with one symmetric f32
scale (``round`` half to even, as ``jnp.round``), and the new residual is
what the codes miss.  The codes are bit-equal to the JAX package's for
the same gradients and residuals.

    comp, err = compress_gradients(grads, err)
    grads = decompress_gradients(comp)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quantizer import tree_leaves, tree_map


def _compress_leaf(g, e):
    gf = g.to(torch.float32) + e
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal (another rounding)
    scale = (torch.clamp_min(torch.amax(torch.abs(gf)), 1e-12)
             / gf.new_full((), 127.0))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    err = gf - q.to(torch.float32) * scale
    return {"q": q, "scale": scale}, err


def _is_pair(t):
    return isinstance(t, tuple)


def compress_gradients(grads, err_state=None) -> Tuple[dict, dict]:
    """Returns (compressed tree: {"q": int8 codes, "scale": 0-d f32} per
    leaf, the new error-feedback tree: f32 residuals)."""
    if err_state is None:
        err_state = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    pairs = tree_map(_compress_leaf, grads, err_state)
    comp = tree_map(lambda t: t[0], pairs, is_leaf=_is_pair)
    err = tree_map(lambda t: t[1], pairs, is_leaf=_is_pair)
    return comp, err


def _is_comp(t):
    return isinstance(t, dict) and "q" in t


def decompress_gradients(comp):
    return tree_map(lambda leaf: leaf["q"].to(torch.float32) * leaf["scale"],
                    comp, is_leaf=_is_comp)


def compressed_bytes(comp) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(comp))
