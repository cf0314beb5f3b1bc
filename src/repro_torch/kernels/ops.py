"""Routing of the kernel operations by the tensor's device only.

* a CUDA tensor -> the hand-written CUDA kernel (or an exception);
* a CPU tensor  -> the kernel's plain PyTorch version.

There is no switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core import psi
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import psi_matmul as _pm
from repro_torch.kernels import ref as _ref

# every kernel wrapper, by the name chip_smoke.py and the stats report
KERNELS = {
    "psi_matmul_codes": _pm.psi_matmul_codes_cuda,
    "psi_matmul_packed": _pm.psi_matmul_packed_cuda,
    "paged_attention": _pa.paged_attention_cuda,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by kernel name) to the launch counts.  A CUDA-graph
    replay runs the launches its capture recorded without calling the
    wrappers, so the executor adds them here on every replay."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def psi_matmul_2d(x2d: torch.Tensor, qt: psi.QuantizedTensor,
                  out_dtype=None) -> torch.Tensor:
    """(M, K) x QuantizedTensor weight (K, N) -> (M, N), in x's dtype or
    ``out_dtype`` (f32: the sums before their cast)."""
    scale = qt.scale.reshape(-1)
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}
    if _route(x2d) == "cuda":
        if qt.packed:
            return _pm.psi_matmul_packed_cuda(x2d, qt.data, scale,
                                              qt.fmt.bits, **kw)
        return _pm.psi_matmul_codes_cuda(x2d, qt.data, scale, **kw)
    if qt.packed:
        return _ref.psi_matmul_packed_ref(x2d, qt.data, scale, qt.fmt.bits,
                                          **kw)
    return _ref.psi_matmul_codes_ref(x2d, qt.data, scale, **kw)


def psi_matmul(x: torch.Tensor, qt: psi.QuantizedTensor, out_dtype=None
               ) -> torch.Tensor:
    """(..., K) x QuantizedTensor weight -> (..., N)."""
    lead = x.shape[:-1]
    y = psi_matmul_2d(x.reshape(-1, x.shape[-1]).contiguous(), qt,
                      out_dtype)
    return y.reshape(*lead, y.shape[-1])


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos,
                           k_scale=None, v_scale=None):
    """Paged-decode attention read side: q (B, Hq, D), pools
    (N, bs, Hkv, D) (+ per-entry scales for int8), block_tables (B, n_bt)
    int32, pos (B,) int32 -> (B, Hq, D)."""
    if _route(q) == "cuda":
        return _pa.paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                        pos, k_scale, v_scale)
    return _pa.paged_attention_ref(q, k_pool, v_pool, block_tables, pos,
                                   k_scale, v_scale)
