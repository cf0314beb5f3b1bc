"""Plain PyTorch versions of the PSI matmul kernels: the exact semantics
the CUDA kernels are held to, and what a CPU tensor runs.

f32 accumulation, the per-output-channel scale applied after the reduction,
output in ``x.dtype`` — the JAX oracles' contract.
"""
from __future__ import annotations

import torch

from repro_torch.core import psi


def psi_matmul_codes_ref(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(codes (K, N), scale (N,) or (1, N)) -> (..., N)."""
    acc = torch.matmul(x.to(torch.float32), codes.to(torch.float32))
    return (acc * scale.reshape(1, -1)).to(x.dtype)


def psi_matmul_packed_ref(x: torch.Tensor, planes: torch.Tensor,
                          scale: torch.Tensor, bits: int) -> torch.Tensor:
    """x (..., K) @ dequant(planes (bits, K//8, N), scale) -> (..., N)."""
    return psi_matmul_codes_ref(x, psi.unpack_codes(planes, bits), scale)
