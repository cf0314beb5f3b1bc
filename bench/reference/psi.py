"""The benchmark's own frozen copy of the PSI weight rounding.

An INT<bits> code is the integer that its best decomposition into at most
``n_psi`` signed powers of two (exponents 0 .. bits-1) reconstructs;
quantization is a symmetric per-channel scale (max |w| maps to the largest
code), ``round(w / scale)`` (half to even), a clip to the INT<bits> range
and the projection onto the PSI-representable codes.  Dequantization is
``codes * scale`` in float32.

Written from the format's definition for the benchmark alone: a later
change to the served program cannot move it.
"""
from __future__ import annotations

import functools

import torch

# terms per code width (INT5 -> 2 signed powers of two, INT8 -> 4)
N_PSI = {2: 1, 3: 2, 4: 2, 5: 2, 6: 3, 7: 3, 8: 4}


@functools.lru_cache(maxsize=None)
def value_table(bits: int) -> tuple:
    """For each integer of [-2^(bits-1), 2^(bits-1)), the nearest value a
    sum of at most N_PSI[bits] signed powers of two can take (ties to the
    smaller magnitude)."""
    n_psi, max_exp = N_PSI[bits], bits - 1
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    terms = [s * (1 << e) for e in range(max_exp + 1) for s in (1, -1)]
    vmax = n_psi * (1 << max_exp)
    reach = {0}
    for _ in range(n_psi):
        reach |= {v + t for v in reach for t in terms if -vmax <= v + t <= vmax}
    out = []
    for w in range(lo, hi + 1):
        out.append(min(reach, key=lambda v: (abs(v - w), abs(v))))
    return tuple(out)


def quantize(w: torch.Tensor, bits: int, per_row: bool = False):
    """(codes, scale), both float32: scales per output channel (over the
    contraction dim, axis 0 of a (K, N) weight), or per row of an
    embedding table (``per_row``)."""
    qmax = (1 << (bits - 1)) - 1
    lo = -(1 << (bits - 1))
    amax = w.abs().amax(dim=-1 if per_row else 0, keepdim=True)
    # tensor by tensor, as a true division (a Python scalar divisor can be
    # applied as a product with its reciprocal on CUDA)
    scale = torch.clamp_min(amax, 1e-8) / amax.new_full((), qmax)
    q = torch.clamp(torch.round(w / scale), lo, (1 << (bits - 1)) - 1)
    tab = torch.tensor(value_table(bits), dtype=torch.float32,
                       device=w.device)
    codes = tab[(q - lo).to(torch.int64)]
    return codes, scale.to(torch.float32)


def dequantized(w: torch.Tensor, bits: int, per_row: bool = False
                ) -> torch.Tensor:
    """The float32 weight the served codes stand for."""
    codes, scale = quantize(w, bits, per_row)
    return codes * scale
