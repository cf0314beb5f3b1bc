"""The single matmul entry point of every model layer.

A :class:`~repro_torch.core.psi.QuantizedTensor` weight goes through the
PSI matmul kernel (``kernels.ops``: CUDA kernel for a CUDA tensor, plain
version on the CPU); a float weight (a leaf a policy kept in float) is a
plain product in the activation dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core import psi, quantizer
from repro_torch.kernels import ops


def _float_weight(w: torch.Tensor, x: torch.Tensor, quant_mode: str):
    kind, _ = quantizer.parse_quant_mode(quant_mode)
    if kind == "qat":
        raise NotImplementedError("QAT fake-quant arrives with the training "
                                  "port; serve PSI codes (--quant psiN)")
    return w.to(x.dtype)


def linear(wleaf, x: torch.Tensor, quant_mode: str = "none") -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N)."""
    if isinstance(wleaf, psi.QuantizedTensor):
        return ops.psi_matmul(x, wleaf)
    return torch.matmul(x, _float_weight(wleaf, x, quant_mode))


def embed(wleaf, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding lookup; PSI tables dequantize per gathered row."""
    if isinstance(wleaf, psi.QuantizedTensor):
        return wleaf.gather_rows(ids, dtype)
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
    for this call when there is none."""
    if isinstance(wleaf, psi.QuantizedTensor):
        return ops.psi_matmul(x, head if head is not None
                              else tied_head(wleaf))
    return torch.matmul(x, _float_weight(wleaf, x, quant_mode).t())
