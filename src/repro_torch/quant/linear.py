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


def tied_logits(wleaf, x: torch.Tensor, quant_mode: str = "none"
                ) -> torch.Tensor:
    """logits = x @ embed_table.T with per-row (= per-vocab) scales; a
    packed table unpacks whole, as in the JAX package."""
    if isinstance(wleaf, psi.QuantizedTensor):
        codes_t = wleaf.codes.t().contiguous()          # (D, V)
        return ops.psi_matmul(x, psi.QuantizedTensor(
            codes_t, wleaf.scale.reshape(-1), wleaf.fmt))
    return torch.matmul(x, _float_weight(wleaf, x, quant_mode).t())
