"""Wrappers of the CUDA PSI matmul kernels (``csrc/psi_matmul.cu``, and
``csrc/psi_rows.cu`` for both kernels' prefill rows).

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
Each has a third route for bf16 prefill rows, built so that a block
decodes each piece of the weight once for many tokens:

* kernel 1's bf16 launches of more than ``CODES_ROWS_MIN_M`` rows (T =
  64, measured on the H100) take ``psi_gemm_codes_rows_kernel``: a block
  owns 32 tokens over the whole of K, its splits summed one after another
  (or one a block of a cluster where that grid is small)
  (:func:`codes_launch_plan`);
* kernel 2's take ``psi_gemm_packed_rows_kernel`` on weights of more than
  ``PACKED_ROWS_MIN_N`` (256) channels at more than ``PACKED_ROWS_ALL_M``
  (224) rows, and at more than ``PACKED_ROWS_MIN_M`` (T = 64) rows where
  the weight alone gives a 128-channel tile per SM (thresholds measured on
  the H100): a warp decodes its 32 channels once a 64-K group for 64
  tokens, the block walking the decode route's chains one after another
  (:func:`packed_launch_plan`).

Each runs its decode route's split plan, chains, sums and split order, so
a row's outputs are bit for bit the same whichever route is picked.  The
wrapper counts those launches in its ``launches`` with the decode route's,
and again in its ``rows_launches``.

The output is x's dtype, or f32 when ``out_dtype=torch.float32`` is asked
of a bf16 x: the same f32 sums times the scale, stored without the last
rounding (a row-parallel shard's partial sum, added over the ranks in f32
before its one cast); its cast to bf16 is the bf16 output bit for bit.
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
        lib.psi_matmul_codes.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.psi_matmul_codes.restype = _I
        lib.psi_matmul_packed.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.psi_matmul_packed.restype = _I
        lib._argtypes_set = True
    return lib


def _rows_lib():
    lib = _build.load("psi_rows")
    if not getattr(lib, "_argtypes_set", False):
        lib.psi_matmul_codes_rows.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.psi_matmul_codes_rows.restype = _I
        lib.psi_matmul_packed_rows.argtypes = [_P] * 4 + [_I] * 9 + [_P]
        lib.psi_matmul_packed_rows.restype = _I
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
# the codes route at prefill rows: bf16 launches of M > CODES_ROWS_MIN_M
# rows (T, measured on the H100; PERF.md) take it, a block owning
# CODES_ROWS_TOKENS tokens
CODES_ROWS_MIN_M = 64
CODES_ROWS_TOKENS = 32
# the packed route at prefill rows (csrc/psi_rows.cu, design (5)): a block
# owns PACKED_ROWS_TOKENS tokens x PACKED_ROWS_TILE channels (the kernel's
# kPackedTok x kPackedTN: it refuses a grid of other blocks); bf16 launches
# take it on weights of N > PACKED_ROWS_MIN_N channels at M >
# PACKED_ROWS_ALL_M rows, and at M > PACKED_ROWS_MIN_M where the weight
# alone gives a channel tile per SM (thresholds measured on the H100;
# PERF.md)
PACKED_ROWS_MIN_M = 64
PACKED_ROWS_ALL_M = 224
PACKED_ROWS_MIN_N = 256
PACKED_ROWS_TOKENS = 64
PACKED_ROWS_TILE = 128


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


def codes_rows_cluster(M, N, tile, chunk, n_split, n_sm=132):
    """rows_cluster of the prefill route, speed only (a row's sums do
    not depend on it): 1, one split a block of a cluster, where the blocks
    of whole K would cover less than 2/5 of the SMs, or less than 3/4 with
    splits of 16 steps or more; else 0, the splits one after another in
    each block (a 128-channel tile's plan has one split, so never there).
    (Fitted to both layouts' times on the H100 at every served weight, one
    card's and a model axis's: ``chip_smoke.py``'s ``routes_device_ms``;
    PERF.md.)"""
    blocks = -(-M // CODES_ROWS_TOKENS) * -(-N // tile)
    few = blocks < 2 * n_sm // 5 or (blocks < 3 * n_sm // 4 and chunk >= 16)
    return int(n_split > 1 and few)


def codes_launch_plan(M, K, N, n_sm=132):
    """(tile, chunk, rows, rows_cluster) of a bf16 codes launch: the
    split plan :func:`codes_split_plan` gives for the weight, whatever M,
    and the route, from M alone: rows 0 (the decode route) at M <=
    CODES_ROWS_MIN_M, else 1 (the prefill route), laid out as
    :func:`codes_rows_cluster` says."""
    tile, chunk, n_split = codes_split_plan(K, N, n_sm)
    if M <= CODES_ROWS_MIN_M:
        return tile, chunk, 0, 0
    return tile, chunk, 1, codes_rows_cluster(M, N, tile, chunk, n_split,
                                              n_sm)


def codes_rows_grid(M, N, tile, n_split, rows_cluster):
    """(token tiles, split blocks, channel tiles) of a prefill-route
    launch: blocks of CODES_ROWS_TOKENS rows x ``tile`` channels, each over
    the whole of K, or over one split of it in a cluster of n_split."""
    return (-(-M // CODES_ROWS_TOKENS), n_split if rows_cluster else 1,
            -(-N // tile))


def packed_launch_plan(M, K, N, n_sm=132):
    """(chunk, rows) of a bf16 packed launch: the chunk :func:`split_plan`
    gives for the weight, whatever M, and the route, speed only (both
    give the same bits): rows 1 (the prefill route) on weights of N >
    PACKED_ROWS_MIN_N channels at M > PACKED_ROWS_ALL_M, or at M >
    PACKED_ROWS_MIN_M where ceil(N / PACKED_ROWS_TILE) >= n_sm (lm_head,
    granite-34b's w_up); else rows 0 (the decode route).  (On the H100 the
    prefill route lost at N <= 256 at every M, and below ~224 rows where
    its grid of whole-K blocks covers the SMs thinly: granite-34b's 6144
    x 6144 at 96-192 rows; ``chip_smoke.py``'s ``routes_device_ms``.)"""
    chunk, _ = split_plan(K, N, n_sm)
    wide = -(-N // PACKED_ROWS_TILE) >= n_sm
    rows = N > PACKED_ROWS_MIN_N and (
        M > PACKED_ROWS_ALL_M or (M > PACKED_ROWS_MIN_M and wide))
    return chunk, int(rows)


def packed_rows_grid(M, K, N, chunk):
    """The grid of a packed prefill-route launch, as the wrapper passes it:
    (token tiles, split blocks, channel tiles), blocks of
    PACKED_ROWS_TOKENS rows x PACKED_ROWS_TILE channels, each over one
    split of ``chunk`` 64-K groups, the splits of a tile one cluster."""
    n_split = -(-(-(-K // GROUP_K)) // chunk)
    return (-(-M // PACKED_ROWS_TOKENS), n_split, -(-N // PACKED_ROWS_TILE))


def _out_dtype(x, out_dtype):
    """The output dtype of a launch: x's, or f32 asked of a bf16 x."""
    if out_dtype is None or out_dtype == x.dtype:
        return x.dtype
    if out_dtype == torch.float32:
        return out_dtype
    raise TypeError(f"out_dtype must be x's dtype or float32, got "
                    f"{out_dtype} for {x.dtype} x")


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
                          scale: torch.Tensor, out_dtype=None
                          ) -> torch.Tensor:
    """x (M, K) @ (codes (K, N) int8 * scale (N,)) -> (M, N) in x.dtype
    (or f32: ``out_dtype``)."""
    if codes.dim() != 2 or codes.shape[0] != x.shape[-1]:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    N = codes.shape[1]
    _check_common(x, codes, scale, torch.int8, N)
    plan = (0, 0, 0, 0)
    if x.dtype == torch.bfloat16:
        plan = codes_launch_plan(M, K, N,
                                 _build.sm_count(x.device.index or 0))
    out = _codes_launch(x, codes, scale, out_dtype, *plan)
    psi_matmul_codes_cuda.launches += 1
    psi_matmul_codes_cuda.rows_launches += plan[2]
    return out


def _codes_launch(x, codes, scale, out_dtype, tile, chunk, rows,
                  rows_cluster=0):
    """One launch of kernel 1 at the plan given (checked tensors).  The
    wrapper passes :func:`codes_launch_plan`'s; the card's checks also pass
    other layouts at the same M (rows 0: the decode route), to hold the
    routes side by side."""
    M, K = x.shape
    N = codes.shape[1]
    out = torch.empty((M, N), dtype=_out_dtype(x, out_dtype),
                      device=x.device)
    ptrs = (x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if rows:
        err = _rows_lib().psi_matmul_codes_rows(
            *ptrs, M, K, N, _DTYPE_CODE[out.dtype], tile, chunk,
            rows_cluster, stream)
    else:
        err = _lib().psi_matmul_codes(
            *ptrs, M, K, N, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out.dtype],
            tile, chunk, stream)
    _build.check(err, "psi_matmul_codes")
    return out


psi_matmul_codes_cuda.launches = 0
psi_matmul_codes_cuda.rows_launches = 0


def psi_matmul_packed_cuda(x: torch.Tensor, planes: torch.Tensor,
                           scale: torch.Tensor, bits: int, out_dtype=None
                           ) -> torch.Tensor:
    """x (M, K) @ dequant(planes (bits, K//8, N) uint8, scale (N,)) in
    x.dtype (or f32: ``out_dtype``)."""
    if not 2 <= bits <= 7:
        raise ValueError(f"packed widths are 2..7 bits, got {bits}")
    if (planes.dim() != 3 or planes.shape[0] != bits
            or planes.shape[1] * 8 != x.shape[-1]):
        raise ValueError(f"planes {tuple(planes.shape)} do not hold {bits} "
                         f"planes of K/8 rows for x {tuple(x.shape)}")
    M, K = x.shape
    N = planes.shape[2]
    _check_common(x, planes, scale, torch.uint8, N)
    plan = (0, 0)
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:                 # the kernel reads x in 16 bytes
            x = x.clone()
        plan = packed_launch_plan(M, K, N,
                                  _build.sm_count(x.device.index or 0))
    out = _packed_launch(x, planes, scale, bits, out_dtype, *plan)
    psi_matmul_packed_cuda.launches += 1
    psi_matmul_packed_cuda.rows_launches += plan[1]
    return out


def _packed_launch(x, planes, scale, bits, out_dtype, chunk, rows):
    """One launch of kernel 2 at the plan given (checked tensors, a bf16 x
    16-byte aligned).  The wrapper passes :func:`packed_launch_plan`'s;
    the card's checks also pass the other route at the same M, to hold
    the routes side by side."""
    M, K = x.shape
    N = planes.shape[2]
    out = torch.empty((M, N), dtype=_out_dtype(x, out_dtype),
                      device=x.device)
    ptrs = (x.data_ptr(), planes.data_ptr(), scale.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if rows:
        err = _rows_lib().psi_matmul_packed_rows(
            *ptrs, M, K, N, int(bits), _DTYPE_CODE[out.dtype], chunk,
            *packed_rows_grid(M, K, N, chunk), stream)
    else:
        err = _lib().psi_matmul_packed(
            *ptrs, M, K, N, int(bits), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out.dtype], chunk, stream)
    _build.check(err, "psi_matmul_packed")
    return out


psi_matmul_packed_cuda.launches = 0
psi_matmul_packed_cuda.rows_launches = 0
