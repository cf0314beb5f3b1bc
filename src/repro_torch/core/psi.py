"""Partial-Sub-Integer (PSI) weight format in PyTorch.

An INT<bits> weight is stored as its best decomposition into at most
``n_psi`` signed powers of two (the paper's Eq. 1); the stored code is the
integer that decomposition reconstructs, so dequantization is ``codes *
scale``.  Sub-byte widths are bit-plane packed, exactly ``bits/8`` bytes per
weight, in the layout the JAX package uses (bit ``j`` of
``planes[..., b, i, n]`` is bit ``b`` of the offset-binary weight
``codes[..., 8*i + j, n] + 2^(bits-1)``), so the two packages' codes and
planes are bit-equal for the same float weights.

The decomposition tables are exact integer bookkeeping in numpy, built once
per registered format.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PsiFormat:
    """One PSI weight format: INT<bits> codes decomposed into <= n_psi
    signed powers of two with exponents in [0, max_exp]."""
    bits: int
    n_psi: int
    max_exp: int
    w_min: int
    w_max: int
    exact: bool
    worst_case_rel_error: float

    @property
    def qmax(self) -> int:
        return self.w_max

    @property
    def offset(self) -> int:
        """Offset-binary bias for packing: code + offset in [0, 2^bits)."""
        return 1 << (self.bits - 1)

    @property
    def sub_byte(self) -> bool:
        return self.bits < 8

    def decomposition_table(self) -> np.ndarray:
        return _decomposition_table(self.bits, self.n_psi, self.max_exp)

    def value_table(self) -> np.ndarray:
        return _value_table(self.bits, self.n_psi, self.max_exp)


# Term budgets per width (paper: INT5 -> 2 PSIs, INT8 -> 4 PSIs).
DEFAULT_N_PSI = {2: 1, 3: 2, 4: 2, 5: 2, 6: 3, 7: 3, 8: 4}

_REGISTRY: Dict[int, PsiFormat] = {}

FormatLike = Union[int, str, PsiFormat]


def make_format(bits: int, n_psi: Optional[int] = None,
                max_exp: Optional[int] = None) -> PsiFormat:
    """Build the PSI format for a width, certifying exactness and the
    worst-case relative error exhaustively over the integer range."""
    if not 2 <= bits <= 8:
        raise ValueError(f"PSI weight width must be in [2, 8] bits, got {bits}")
    n_psi = DEFAULT_N_PSI[bits] if n_psi is None else n_psi
    max_exp = bits - 1 if max_exp is None else max_exp
    w_min, w_max = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = _value_table(bits, n_psi, max_exp)
    w = np.arange(w_min, w_max + 1)
    rel = np.abs(vals - w) / np.maximum(np.abs(w), 1)
    return PsiFormat(bits=bits, n_psi=n_psi, max_exp=max_exp,
                     w_min=w_min, w_max=w_max,
                     exact=bool(np.array_equal(vals, w)),
                     worst_case_rel_error=float(rel.max()))


def register_format(bits: int, n_psi: Optional[int] = None,
                    max_exp: Optional[int] = None) -> PsiFormat:
    fmt = make_format(bits, n_psi, max_exp)
    _REGISTRY[bits] = fmt
    return fmt


def get_format(spec: FormatLike) -> PsiFormat:
    """Look a format up by bits (5), name ("psi5"), or pass one through."""
    if isinstance(spec, PsiFormat):
        return spec
    if isinstance(spec, str):
        if not spec.startswith("psi"):
            raise ValueError(f"unknown PSI format name {spec!r}")
        spec = int(spec[3:])
    if spec not in _REGISTRY:
        raise ValueError(f"no PSI format registered for {spec} bits "
                         f"(registered: {sorted(_REGISTRY)})")
    return _REGISTRY[spec]


def registered_bits() -> Tuple[int, ...]:
    return tuple(sorted(_REGISTRY))


@functools.lru_cache(maxsize=None)
def _decomposition_table(bits: int, n_psi: int, max_exp: int) -> np.ndarray:
    """For every integer of the INT<bits> range, the best <= n_psi-term
    signed power-of-two decomposition (minimum absolute error, ties toward
    the smaller magnitude).  int16 ``(range, 2*n_psi)``: [s1, n1, ...]."""
    w_min, w_max = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    terms = []
    for n in range(max_exp + 1):
        terms.append((1 << n, 1, n))
        terms.append((-(1 << n), -1, n))
    vmax = n_psi * (1 << max_exp)
    reachable = {0: ()}
    for _ in range(n_psi):
        new = dict(reachable)
        for v, combo in reachable.items():
            for tv, ts, tn in terms:
                nv = v + tv
                if -vmax <= nv <= vmax and (nv not in new
                                            or len(new[nv]) > len(combo) + 1):
                    new[nv] = combo + ((ts, tn),)
        reachable = new
    table = np.zeros((w_max - w_min + 1, 2 * n_psi), dtype=np.int16)
    for w in range(w_min, w_max + 1):
        best_v, best_err = None, None
        for v in reachable:
            err = abs(v - w)
            if best_err is None or err < best_err or (
                    err == best_err and abs(v) < abs(best_v)):
                best_v, best_err = v, err
        row = []
        for (s, n) in reachable[best_v]:
            row.extend([s, n])
        row.extend([0, 0] * (n_psi - len(reachable[best_v])))
        table[w - w_min] = row
    return table


@functools.lru_cache(maxsize=None)
def _value_table(bits: int, n_psi: int, max_exp: int) -> np.ndarray:
    tab = _decomposition_table(bits, n_psi, max_exp)
    signs = tab[:, 0::2].astype(np.int64)
    exps = tab[:, 1::2].astype(np.int64)
    return np.sum(signs * (1 << exps), axis=1).astype(np.int32)


def psi_project_int(w: torch.Tensor, bits: FormatLike) -> torch.Tensor:
    """Project integer weights onto the PSI-representable set (int32)."""
    fmt = get_format(bits)
    tab = torch.as_tensor(fmt.value_table(), device=w.device)
    return tab[w.to(torch.int64) - fmt.w_min]


# ---------------------------------------------------------------------------
# QuantizedTensor: the serving-format weight leaf.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class QuantizedTensor:
    """A weight in PSI serving format: int8 codes ``(..., K, N)`` (packed
    False) or uint8 bit-planes ``(..., bits, K//8, N)`` (packed True), a f32
    per-channel scale broadcastable to the code shape, and its format."""
    data: torch.Tensor
    scale: torch.Tensor
    fmt: PsiFormat
    packed: bool = False

    @property
    def codes(self) -> torch.Tensor:
        """int8 codes ``(..., K, N)``; unpacks bit-planes on demand."""
        if self.packed:
            return unpack_codes(self.data, self.fmt)
        return self.data

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (dense-weight) shape."""
        if self.packed:
            *lead, _, kb, n = self.data.shape
            return (*lead, kb * 8, n)
        return tuple(self.data.shape)

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device), self.scale.to(device),
                               self.fmt, self.packed)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """codes * scale in f32, cast to ``dtype``."""
        return (self.codes.to(torch.float32) * self.scale).to(dtype)

    def gather_rows(self, ids: torch.Tensor, dtype=torch.bfloat16
                    ) -> torch.Tensor:
        """Dequantize only rows ``ids`` of a ``(V, D)`` table (embedding
        lookup); packed tables unpack per gathered row."""
        ids = ids.to(torch.int64)
        if self.packed:
            rows = unpack_rows(self.data, ids, self.fmt)
        else:
            rows = self.data[ids]
        return (rows.to(torch.float32) * self.scale[ids]).to(dtype)

    def pack(self) -> "QuantizedTensor":
        if self.packed:
            return self
        return QuantizedTensor(pack_codes(self.data, self.fmt), self.scale,
                               self.fmt, packed=True)


def compute_scale(w: torch.Tensor, bits: FormatLike, axis) -> torch.Tensor:
    """Symmetric per-channel scale: max|w| along ``axis`` maps to qmax."""
    a = w.abs()
    if axis is None:
        amax = a.amax().reshape([1] * w.dim())
    else:
        amax = a.amax(dim=tuple(axis), keepdim=True)
    return torch.clamp_min(amax, 1e-8) / get_format(bits).qmax


def quantize_weights(w: torch.Tensor, bits: FormatLike,
                     axis=None) -> QuantizedTensor:
    """Quantize float weights to PSI format: ``round(w / scale)`` in f32
    (round half to even, as ``jnp.round``), clipped, PSI-projected."""
    fmt = get_format(bits)
    scale = compute_scale(w, fmt, axis)
    q = torch.clamp(torch.round(w / scale), fmt.w_min, fmt.w_max)
    q = psi_project_int(q.to(torch.int32), fmt)
    return QuantizedTensor(q.to(torch.int8), scale.to(torch.float32), fmt)


# ---------------------------------------------------------------------------
# Sub-byte bit-plane packing.
# ---------------------------------------------------------------------------
def pack_codes(codes: torch.Tensor, fmt: FormatLike) -> torch.Tensor:
    """INT<bits> codes (..., K, N) -> uint8 bit-planes (..., bits, K//8, N)."""
    fmt = get_format(fmt)
    if not fmt.sub_byte:
        raise ValueError(f"bit-plane packing is for sub-byte widths, "
                         f"got {fmt.bits} bits")
    *lead, K, N = codes.shape
    if K % 8:
        raise ValueError(f"K={K} must be divisible by 8 for bit-plane packing")
    offs = (codes.to(torch.int32) + fmt.offset).reshape(*lead, K // 8, 8, N)
    lane = torch.arange(8, dtype=torch.int32,
                        device=codes.device).reshape(8, 1)
    planes = [(((offs >> b) & 1) << lane).sum(dim=-2).to(torch.uint8)
              for b in range(fmt.bits)]
    return torch.stack(planes, dim=-3)


def unpack_codes(packed: torch.Tensor, fmt: FormatLike) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., bits, K//8, N) -> (..., K, N)
    int8, a literal sum of shifted bits."""
    fmt = get_format(fmt)
    *lead, nbits, Kb, N = packed.shape
    if nbits != fmt.bits:
        raise ValueError(f"planes {tuple(packed.shape)} do not hold "
                         f"{fmt.bits} bit-planes")
    lane = torch.arange(8, dtype=torch.int32,
                        device=packed.device).reshape(1, 8, 1)
    val = torch.zeros((*lead, Kb, 8, N), dtype=torch.int32,
                      device=packed.device)
    for b in range(fmt.bits):
        plane = packed[..., b, :, :].to(torch.int32).unsqueeze(-2)
        val += ((plane >> lane) & 1) << b
    return (val.reshape(*lead, Kb * 8, N) - fmt.offset).to(torch.int8)


def unpack_rows(packed: torch.Tensor, rows: torch.Tensor,
                fmt: FormatLike) -> torch.Tensor:
    """Unpack only logical rows ``rows`` of a packed (bits, V//8, D) table:
    row ``i`` is bit ``i % 8`` of byte ``i // 8`` in each plane."""
    fmt = get_format(fmt)
    if packed.dim() != 3:
        raise ValueError(f"unpack_rows expects an unstacked (bits, V//8, D) "
                         f"table, got shape {tuple(packed.shape)}")
    rows = rows.to(torch.int64)
    byte, bit = rows // 8, (rows % 8).unsqueeze(-1)
    val = torch.zeros(rows.shape + (packed.shape[-1],), dtype=torch.int32,
                      device=packed.device)
    for b in range(fmt.bits):
        plane = packed[b][byte].to(torch.int64)
        val += (((plane >> bit) & 1) << b).to(torch.int32)
    return (val - fmt.offset).to(torch.int8)


for _bits in sorted(DEFAULT_N_PSI):
    register_format(_bits)
del _bits
