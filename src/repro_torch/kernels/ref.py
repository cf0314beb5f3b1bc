"""Plain PyTorch versions of the PSI matmul kernels: the exact semantics
the CUDA kernels are held to, and what a CPU tensor runs.

f32 accumulation, the per-output-channel scale applied after the reduction,
output in ``x.dtype`` — the JAX oracles' contract — or in f32 when
``out_dtype=torch.float32`` (the sum before its one cast: a row-parallel
shard's partial, added over the ranks first).
"""
from __future__ import annotations

import torch

from repro_torch.core import psi


def psi_matmul_codes_ref(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (..., K) @ dequant(codes (K, N), scale (N,) or (1, N)) -> (..., N)."""
    acc = torch.matmul(x.to(torch.float32), codes.to(torch.float32))
    return (acc * scale.reshape(1, -1)).to(out_dtype or x.dtype)


def psi_matmul_packed_ref(x: torch.Tensor, planes: torch.Tensor,
                          scale: torch.Tensor, bits: int, out_dtype=None
                          ) -> torch.Tensor:
    """x (..., K) @ dequant(planes (bits, K//8, N), scale) -> (..., N)."""
    return psi_matmul_codes_ref(x, psi.unpack_codes(planes, bits), scale,
                                out_dtype)


# The paper's Table-I widths by name, as the JAX package names them.
psi_matmul_int8_ref = psi_matmul_codes_ref


def psi_matmul_int5_ref(x: torch.Tensor, planes: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    return psi_matmul_packed_ref(x, planes, scale, 5)


# ---------------------------------------------------------------------------
# Dequantize-then-matmul forms: the per-channel scale folded into the
# weight, cast to x's dtype, one dense product with f32 sums.  They are the
# library-call yardstick beside the kernels (PERF.md's table) and the tests'
# second oracle, not a route: nothing on a main path calls them.
# ---------------------------------------------------------------------------
def psi_matmul_codes_dequant(x: torch.Tensor, codes: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    w = (codes.to(torch.float32) * scale.reshape(1, -1)).to(x.dtype)
    return torch.matmul(x, w)


def psi_matmul_packed_dequant(x: torch.Tensor, planes: torch.Tensor,
                              scale: torch.Tensor, bits: int
                              ) -> torch.Tensor:
    return psi_matmul_codes_dequant(x, psi.unpack_codes(planes, bits), scale)


psi_matmul_int8_dequant = psi_matmul_codes_dequant


def psi_matmul_int5_dequant(x: torch.Tensor, planes: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    return psi_matmul_packed_dequant(x, planes, scale, 5)
