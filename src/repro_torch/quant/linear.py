"""The single matmul entry point of every model layer.

A :class:`~repro_torch.core.psi.QuantizedTensor` weight goes through the
PSI matmul kernel (``kernels.ops``: CUDA kernel for a CUDA tensor, plain
version on the CPU); a float weight (a leaf a policy kept in float, or a
latent weight in training) is a plain product in the activation dtype,
under a ``qatN`` mode of its fake-quantized copy
(:func:`~repro_torch.core.psi.fake_quant_ste`: the straight-through
gradient reaches the float leaf), as the JAX package computes QAT outside
any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import psi, quantizer
from repro_torch.kernels import ops


def maybe_fake_quant(w: torch.Tensor, quant_mode: str, axis
                     ) -> torch.Tensor:
    """``w`` fake-quantized with the straight-through gradient under a
    ``qatN`` mode (scale over ``axis``), else ``w`` as it is."""
    kind, bits = quantizer.parse_quant_mode(quant_mode)
    if kind != "qat":
        return w
    return psi.fake_quant_ste(w, bits, axis)


def linear(wleaf, x: torch.Tensor, quant_mode: str = "none",
           out_dtype=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N), in x's dtype, or in f32 with
    ``out_dtype=torch.float32`` (the f32 sums before their cast, as a
    row-parallel shard's partial needs them).  A tensor-parallel leaf
    (``runtime.parallel.TPLinear``) runs its shard and its collective."""
    if isinstance(wleaf, psi.QuantizedTensor):
        return ops.psi_matmul(x, wleaf, out_dtype)
    tp = getattr(wleaf, "tp_linear", None)
    if tp is not None:
        return tp(x, quant_mode)
    w = maybe_fake_quant(wleaf, quant_mode, axis=(wleaf.dim() - 2,))
    if out_dtype is not None and out_dtype != x.dtype:
        # the products of x's dtype are exact in f32: f32 accumulation
        return torch.matmul(x.to(out_dtype), w.to(x.dtype).to(out_dtype))
    return torch.matmul(x, w.to(x.dtype))


def embed(wleaf, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding lookup; PSI tables dequantize per gathered row (a
    vocab-parallel table, ``runtime.parallel.TPEmbed``, sums its rows over
    the model group)."""
    if isinstance(wleaf, psi.QuantizedTensor):
        return wleaf.gather_rows(ids, dtype)
    tp = getattr(wleaf, "tp_embed", None)
    if tp is not None:
        return tp(ids, dtype)
    return wleaf[ids.long()].to(dtype)


def tied_head(wleaf: psi.QuantizedTensor) -> psi.QuantizedTensor:
    """The (D, V) lm-head of a tied (V, D) PSI table: its codes transposed
    into a contiguous copy (a packed table unpacks whole, as in the JAX
    package), with the per-row (= per-vocab) scales as the head's
    per-channel scales."""
    return psi.QuantizedTensor(wleaf.codes.t().contiguous(),
                               wleaf.scale.reshape(-1), wleaf.fmt)


def tied_logits(wleaf, x: torch.Tensor, quant_mode: str = "none",
                head=None) -> torch.Tensor:
    """logits = x @ embed_table.T.  A PSI table goes through ``head``, its
    :func:`tied_head` built once (``Model.serving_params``), or one built
    for this call when there is none.  A tensor-parallel table's ``head``
    is the gathered product of its local rows."""
    if getattr(head, "tp_linear", None) is not None:
        return linear(head, x, quant_mode)
    if isinstance(wleaf, psi.QuantizedTensor):
        return ops.psi_matmul(x, head if head is not None
                              else tied_head(wleaf))
    w = maybe_fake_quant(wleaf, quant_mode, axis=(wleaf.dim() - 1,))
    return torch.matmul(x, w.to(x.dtype).t())
