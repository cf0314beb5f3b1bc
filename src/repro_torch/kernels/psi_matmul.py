"""Wrappers of the CUDA PSI matmul kernels (``csrc/psi_matmul.cu``).

``psi_matmul_codes_cuda`` replaces the Pallas ``psi_matmul_int8`` (alias
``psi_matmul_codes``) and ``psi_matmul_packed_cuda`` replaces the Pallas
``psi_matmul_packed``; their plain versions are in
:mod:`repro_torch.kernels.ref`.  Each wrapper takes CUDA tensors only,
checks them, allocates its output with ``torch.empty``, launches on the
current stream, raises if the launch failed, and counts its launches in
``<wrapper>.launches``.

Both kernels have two routes, picked from x's dtype: f32 x runs on CUDA
cores, bf16 x on tensor cores with K split across the blocks of a cluster
as :func:`codes_split_plan` (codes) or :func:`split_plan` (planes) says.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("psi_matmul")
    if not getattr(lib, "_argtypes_set", False):
        lib.psi_matmul_codes.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.psi_matmul_codes.restype = _I
        lib.psi_matmul_packed.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.psi_matmul_packed.restype = _I
        lib._argtypes_set = True
    return lib


# the packed tensor-core route's tiles (csrc/psi_matmul.cu): a block is
# WARPS warps on TILE_N output channels; K goes in groups of GROUP_K (8
# plane rows), the warps of a block taking the groups of its split in turn;
# the splits of a tile are one cluster of at most MAX_SPLIT blocks
WARPS = 8
TILE_N = 32
GROUP_K = 64
MAX_SPLIT = 8
# the codes route's: a block of WARPS warps on CODES_TILES channels (128:
# one 128-byte line of a code row, or 64), K in steps of CODES_STEP_K rows
# (the last may be partial), taken by the warps in turn; splits as above
CODES_TILES = (128, 64)
CODES_STEP_K = 16
CODES_BLOCKS_PER_SM = 2


def _plan(units, tiles, blocks):
    want = -(-blocks // tiles)
    split = max(1, min(want, MAX_SPLIT, units // WARPS))
    chunk = -(-units // split)
    return chunk, -(-units // chunk)


def split_plan(K, N, n_sm=132):
    """(chunk, n_split): 64-K groups per split of K, and the number of
    splits, for the packed bf16 route at a (K, N) weight.  From the weight's
    shape alone, never from M, so a row's sums run in the same order
    whatever the batch: as many splits as it takes for one block per SM
    (ceil(N/32) channel tiles x n_split), but no more than MAX_SPLIT, nor
    more than leave each of a block's WARPS warps one group.  (On the H100
    at M = 4, more splits lost: each adds a block's start-up and a cluster
    reduction, and a block of 8 warps already streams its tile.)"""
    return _plan(-(-K // GROUP_K), -(-N // TILE_N), n_sm)


def codes_split_plan(K, N, n_sm=132):
    """(tile, chunk, n_split) for the codes bf16 route at a (K, N) weight:
    channels per block, 16-K steps per split of K (any K: the last step may
    be partial), and the number of splits.  From K and N only, never M, so
    a row's sums run in the same order whatever the batch.  128-channel
    tiles (a whole line of each code row) where they alone give
    CODES_BLOCKS_PER_SM blocks per SM (lm_head); else 64-channel tiles, with
    as many splits as it takes to get there, but no more than MAX_SPLIT, nor
    more than leave each of a block's WARPS warps one step.  (On the H100
    at M = 4 this plan was the fastest of tiles 32/64/128 x splits 1-8 at
    every qwen3-8b shape but wk/wv, where 32-channel tiles were a little
    faster.)"""
    steps = -(-K // CODES_STEP_K)
    blocks = CODES_BLOCKS_PER_SM * n_sm
    wide, narrow = CODES_TILES
    if -(-N // wide) >= blocks:
        return wide, steps, 1
    return (narrow,) + _plan(steps, -(-N // narrow), blocks)


def _check_common(x, w, scale, wdtype, N):
    if not x.is_cuda:
        raise ValueError("the CUDA psi_matmul takes CUDA tensors; a CPU "
                         "tensor goes to kernels.ref")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"x must be a contiguous (M>=1, K) matrix, got "
                         f"{tuple(x.shape)}")
    if w.dtype != wdtype or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"weight must be contiguous {wdtype} on "
                         f"{x.device}, got {w.dtype} on {w.device}")
    if (scale.dtype != torch.float32 or scale.shape != (N,)
            or not scale.is_contiguous() or scale.device != x.device):
        raise ValueError(f"scale must be contiguous float32 ({N},) on "
                         f"{x.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def psi_matmul_codes_cuda(x: torch.Tensor, codes: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ (codes (K, N) int8 * scale (N,)) -> (M, N) in x.dtype."""
    if codes.dim() != 2 or codes.shape[0] != x.shape[-1]:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    N = codes.shape[1]
    _check_common(x, codes, scale, torch.int8, N)
    tile = chunk = 0
    if x.dtype == torch.bfloat16:
        tile, chunk, _ = codes_split_plan(
            K, N, _build.sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _lib().psi_matmul_codes(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, _DTYPE_CODE[x.dtype], tile, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "psi_matmul_codes")
    psi_matmul_codes_cuda.launches += 1
    return out


psi_matmul_codes_cuda.launches = 0


def psi_matmul_packed_cuda(x: torch.Tensor, planes: torch.Tensor,
                           scale: torch.Tensor, bits: int) -> torch.Tensor:
    """x (M, K) @ dequant(planes (bits, K//8, N) uint8, scale (N,))."""
    if not 2 <= bits <= 7:
        raise ValueError(f"packed widths are 2..7 bits, got {bits}")
    if (planes.dim() != 3 or planes.shape[0] != bits
            or planes.shape[1] * 8 != x.shape[-1]):
        raise ValueError(f"planes {tuple(planes.shape)} do not hold {bits} "
                         f"planes of K/8 rows for x {tuple(x.shape)}")
    M, K = x.shape
    N = planes.shape[2]
    _check_common(x, planes, scale, torch.uint8, N)
    chunk = 0
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:                 # the kernel reads x in 16 bytes
            x = x.clone()
        chunk, _ = split_plan(K, N, _build.sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _lib().psi_matmul_packed(
        x.data_ptr(), planes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, int(bits), _DTYPE_CODE[x.dtype], chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "psi_matmul_packed")
    psi_matmul_packed_cuda.launches += 1
    return out


psi_matmul_packed_cuda.launches = 0
