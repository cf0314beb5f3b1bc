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


# a kernel's second route, by name: (wrapper, attribute counting its
# launches, which the wrapper's ``launches`` count too)
ROUTES = {"psi_matmul_codes_rows": (_pm.psi_matmul_codes_cuda,
                                    "rows_launches"),
          "psi_matmul_packed_rows": (_pm.psi_matmul_packed_cuda,
                                     "rows_launches")}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in ROUTES.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, attr in ROUTES.values():
        setattr(fn, attr, 0)


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by kernel or route name) to the launch counts.  A
    CUDA-graph replay runs the launches its capture recorded without
    calling the wrappers, so the executor adds them here on every
    replay."""
    for name, n in counts.items():
        if name in ROUTES:
            fn, attr = ROUTES[name]
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
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


def psi_matmul_int5(x: torch.Tensor, planes: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The paper's INT5 width by name: x (M, K) @ dequant(planes (5, K//8,
    N) uint8, scale (N,) or (1, N)) -> (M, N) in x's dtype; kernel 2 at
    bits 5 on a CUDA tensor, its plain version on a CPU one."""
    scale = scale.reshape(-1).contiguous()
    if _route(x) == "cuda":
        return _pm.psi_matmul_packed_cuda(x, planes, scale, 5)
    return _ref.psi_matmul_int5_ref(x, planes, scale)


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
