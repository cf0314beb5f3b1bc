"""The serving decode cache, in one of two engine layouts.

* ``paged`` — per-layer block pools ``(n_blocks + max_batch, block_size,
  Hkv, head_dim)`` indexed through per-slot block tables (``-1`` =
  unallocated); the last ``max_batch`` blocks are per-slot scratch for the
  writes of inactive slots.  Key positions are synthesized from the table,
  so no ``k_pos`` is stored.
* ``dense`` — one ``(B, C, Hkv, D)`` slab per layer plus ``k_pos`` (B, C)
  (-1 = empty): the engine's per-slot slabs (C = ``max_seq``, or the
  window for SWA: a ring written at slot ``pos % C``), and also what a
  prefill returns, which ``Model.insert_cache`` copies into a slot's row
  or scatters into the pool.  A hybrid's rec layer holds its recurrent
  state there instead: ``{"h": (B, d_rnn), "conv": (B, cw-1, d_rnn)}``
  f32, no position axis and no ``k_pos``; a mamba layer its SSM state
  ``{"ssm": (B, d_inner, N), "conv": (B, cw-1, d_inner)}`` f32.
  whisper's cache also carries ``enc_out`` (B, enc_frames, d), the
  encoder output its cross attention reads at every decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

DENSE = "dense"
PAGED = "paged"
LAYOUTS = (DENSE, PAGED)


@dataclasses.dataclass
class KVCache:
    kv: List[Any]                  # one dict of tensors per layer
    layout: str = DENSE
    block_size: int = 0
    n_blocks: int = 0              # usable pool blocks (scratch excluded)
    enc_out: Optional[torch.Tensor] = None    # encoder-decoder, dense only

    @property
    def paged(self) -> bool:
        return self.layout == PAGED


def blocks_for(n_positions: int, block_size: int) -> int:
    """Blocks needed to hold ``n_positions`` rows (ceil division)."""
    return -(-int(n_positions) // int(block_size))


def full_blocks(n_positions: int, block_size: int) -> int:
    """Blocks completely filled by ``n_positions`` rows (floor division)."""
    return int(n_positions) // int(block_size)


def table_width(max_seq: int, block_size: int) -> int:
    """Block-table width ``n_bt``: logical blocks covering ``max_seq``."""
    return blocks_for(max_seq, block_size)


def cache_nbytes(cache: KVCache) -> int:
    """Bytes of every leaf, KV, recurrent state and ``enc_out`` alike."""
    enc = cache.enc_out
    return int(sum(t.numel() * t.element_size()
                   for layer in cache.kv for t in layer.values()
                   if isinstance(t, torch.Tensor))
               + (0 if enc is None else enc.numel() * enc.element_size()))
