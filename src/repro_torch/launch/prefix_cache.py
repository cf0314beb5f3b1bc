"""Shared-prefix block cache over the paged KV pool (the port's copy of
the JAX package's ``launch/prefix_cache.py``).

The dominant production traffic shape is millions of requests sharing one
system prompt; without this module every admission re-prefills identical KV
state from scratch.  The cheapest MAC is the one never recomputed — the
paper's MACs/W thesis applied at the serving layer — so the engine caches
completed prompts' KV *blocks* and serves later requests' common prefixes
straight out of the pool.

Design (host-side only; the pool tensors never move):

* **Keys are block-aligned token-prefix hash chains.**  One cache entry per
  physical block: entry ``i`` of a prompt is keyed by
  ``H(parent_key, tokens[i*bs:(i+1)*bs])`` (sha256 — a collision would
  silently serve the wrong KV, so no Python ``hash``).  Chaining makes the
  key cover the FULL prefix ``tokens[:(i+1)*bs]``, which is exactly what
  block ``i``'s KV depends on under causal attention, and dedups shared
  sub-prefixes across entries.
* **Entries pin their block in the ``BlockAllocator``** (``ref_block`` on
  publish, ``unref_block`` on eviction), so a cached block is never handed
  back to the free pool while the cache can still serve it, and a block is
  freed only when the last reference — request or cache — drops.
* **Lookup** walks the chain from the root and returns the longest cached
  block run, capped so at least one suffix token remains to prefill (the
  engine needs the last prompt position's logits).  Matched entries move
  to MRU.
* **Eviction is LRU over unreferenced entries only** (block refcount 1 —
  the cache's own pin): an entry whose block a live request still shares
  is skipped.  ``Scheduler.admit`` evicts on demand when a reservation
  would not fit; ``drain`` empties the cache (the "initial allocator
  state" of the churn tests includes draining the LRU).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from repro_torch.models.kvcache import full_blocks

_ROOT = b"prefix-cache-root"


def _chain_key(parent: bytes, block_tokens: np.ndarray) -> bytes:
    h = hashlib.sha256(parent)
    h.update(np.ascontiguousarray(block_tokens, dtype=np.int32).tobytes())
    return h.digest()


class PrefixCache:
    """Block-aligned token-prefix hash chains -> physical pool blocks, with
    LRU eviction of unreferenced entries."""

    def __init__(self, block_size: int, align_tokens: int = 0):
        if block_size <= 0:
            raise ValueError(f"block_size must be > 0, got {block_size}")
        self.block_size = int(block_size)
        # ``align_tokens`` (the engine's prefill bucket): cap hits so the
        # reuse offset ``pos0 = n_hit * block_size`` lands on a bucket
        # boundary.  The engine's reservation / fail-fast / table-width
        # math is all stated in terms of ``bucket(len(prompt))``, which
        # bounds the suffix coverage ``pos0 + bucket(len - pos0)`` ONLY
        # when pos0 is bucket-aligned — a misaligned hit (block_size not a
        # multiple of the bucket) would over-allocate past the admission
        # reservation mid-serve.
        self._hit_step = self.hit_alignment_step(block_size, align_tokens)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # key -> blk
        # ---- counters (reported into the serve stats) ----
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.published_blocks = 0
        self.evicted_blocks = 0
        # restore path (SLO scheduling): lookups on behalf
        # of a PREEMPTED request re-attaching its own published KV — the
        # swap-layer traffic, reported separately from organic prefix hits
        self.restores = 0
        self.restored_tokens = 0

    @staticmethod
    def hit_alignment_step(block_size: int, align_tokens: int) -> int:
        """Hit depths are usable in multiples of this many blocks
        (``lcm(block_size, align_tokens) / block_size``) — the single
        source of truth shared with the engine's warmup, which must
        compile exactly the hit depths lookups can return."""
        if not align_tokens:
            return 1
        return math.lcm(int(block_size), int(align_tokens)) // int(block_size)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_blocks(self) -> List[int]:
        return list(self._entries.values())

    # ------------------------------------------------------------- lookup
    def lookup(self, prompt: np.ndarray) -> List[int]:
        """Longest cached block run covering a block-aligned prefix of
        ``prompt``, capped so at least one suffix token remains to prefill.
        Returns the physical block ids in logical order (possibly empty).
        Pure read (plus LRU touch) — the caller decides whether to
        ``BlockAllocator.attach`` them and ``note_lookup`` the outcome."""
        bs = self.block_size
        blocks: List[int] = []
        keys: List[bytes] = []
        key = _ROOT
        # strict `<`: a hit covering the whole prompt would leave nothing
        # to prefill, and the engine needs the last prompt token's logits
        while (len(blocks) + 1) * bs < len(prompt):
            key = _chain_key(key, prompt[len(blocks) * bs:
                                         (len(blocks) + 1) * bs])
            blk = self._entries.get(key)
            if blk is None:
                break
            keys.append(key)
            blocks.append(blk)
        self._touch(keys)
        # bucket alignment (see __init__): trim to the deepest hit whose
        # token offset lands on the engine's prefill-bucket grid
        return blocks[:(len(blocks) // self._hit_step) * self._hit_step]

    def _touch(self, chain_keys: List[bytes]) -> None:
        """LRU-touch a chain DEEPEST-FIRST, leaving the root most recent:
        a lookup cannot use entry i+1 without entry i, so eviction must
        take leaves before their ancestors — evicting a root first would
        orphan its still-pinned descendants (unreachable dead weight)."""
        for k in reversed(chain_keys):
            self._entries.move_to_end(k)

    def note_lookup(self, hit_blocks: List[int],
                    restore: bool = False) -> None:
        """Record one admission's lookup outcome (kept separate from
        ``lookup`` so head-of-line retries don't inflate the hit rate).
        ``restore=True`` marks a preempted request's re-admission — its
        hit tokens are ALSO counted as swap-restore traffic."""
        self.lookups += 1
        if hit_blocks:
            self.hits += 1
            self.tokens_reused += len(hit_blocks) * self.block_size
            if restore:
                self.restores += 1
                self.restored_tokens += len(hit_blocks) * self.block_size

    # ------------------------------------------------------------ publish
    def publish(self, prompt: np.ndarray, held_blocks: List[int],
                allocator) -> int:
        """Insert a retiring request's completed prompt into the cache: its
        fully-filled prompt blocks (``len(prompt) // block_size`` of them —
        block ``i``'s KV depends only on ``tokens[:(i+1)*bs]``, so partial
        tail blocks are never shareable) are pinned via ``ref_block``.
        ``held_blocks`` is the request's logical-order block list
        (``BlockAllocator.owned_by``).  Chain keys already present keep
        their existing block (first publisher wins).  Returns how many new
        entries were added."""
        bs = self.block_size
        n_full = min(full_blocks(len(prompt), bs), len(held_blocks))
        key, added, keys = _ROOT, 0, []
        for i in range(n_full):
            key = _chain_key(key, prompt[i * bs:(i + 1) * bs])
            keys.append(key)
            if key in self._entries:
                continue
            blk = held_blocks[i]
            allocator.ref_block(blk)
            self._entries[key] = blk
            added += 1
        self._touch(keys)          # leaves-before-ancestors LRU order
        self.published_blocks += added
        return added

    # ------------------------------------------------------------- evict
    def _evict_entry(self, key: bytes, allocator) -> None:
        blk = self._entries.pop(key)
        allocator.unref_block(blk)
        self.evicted_blocks += 1

    def evict_until(self, allocator, need: int) -> int:
        """LRU-evict unreferenced entries (block refcount == 1, the cache's
        own pin) until ``allocator.can_reserve(need)`` or nothing more is
        evictable; returns how many entries were evicted."""
        n = 0
        while not allocator.can_reserve(need):
            victim = next((k for k, blk in self._entries.items()
                           if allocator.refcount[blk] == 1), None)
            if victim is None:
                break                       # everything left is in use
            self._evict_entry(victim, allocator)
            n += 1
        return n

    def drain(self, allocator) -> int:
        """Evict every evictable entry (end-of-serve teardown: with
        refcounts, "allocator back to initial" includes draining the LRU).
        Returns how many entries were evicted."""
        n = 0
        for key in [k for k, blk in self._entries.items()
                    if allocator.refcount[blk] == 1]:
            self._evict_entry(key, allocator)
            n += 1
        return n

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": (self.hits / self.lookups if self.lookups else 0.0),
            "tokens_reused": self.tokens_reused,
            "restores": self.restores,
            "restored_tokens": self.restored_tokens,
            "published_blocks": self.published_blocks,
            "evicted_blocks": self.evicted_blocks,
            "entries": len(self._entries),
        }
