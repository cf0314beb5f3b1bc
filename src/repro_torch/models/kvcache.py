"""The serving decode cache.

* ``paged`` — per-layer block pools ``(n_blocks + max_batch, block_size,
  Hkv, head_dim)`` indexed through per-slot block tables (``-1`` =
  unallocated); the last ``max_batch`` blocks are per-slot scratch for the
  writes of inactive slots.  Key positions are synthesized from the table,
  so no ``k_pos`` is stored.
* ``dense`` — what a prefill returns: one ``(B, C, Hkv, D)`` slab per layer
  in position order plus ``k_pos`` (-1 = empty), scattered into the pool by
  ``Model.insert_cache``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

DENSE = "dense"
PAGED = "paged"


@dataclasses.dataclass
class KVCache:
    kv: List[Any]                  # one dict of tensors per layer
    layout: str = DENSE
    block_size: int = 0
    n_blocks: int = 0              # usable pool blocks (scratch excluded)

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
    return int(sum(t.numel() * t.element_size()
                   for layer in cache.kv for t in layer.values()
                   if isinstance(t, torch.Tensor)))
