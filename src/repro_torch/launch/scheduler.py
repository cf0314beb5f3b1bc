"""Host-side scheduling for the continuous-batching engine (numpy only).

The port's own copy of the FIFO parts of the JAX package's scheduler: the
request record, the Poisson arrival trace (same numpy draws for the same
seed, so both engines serve the identical trace), the slot and block
allocators, admission, retirement and the latency summary.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request plus its lifecycle accounting."""
    rid: int
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new: int                        # per-request generation budget
    arrival_s: float = 0.0

    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_s: List[float] = dataclasses.field(default_factory=list)
    prefilled_tokens: int = 0

    @property
    def latency_s(self) -> float:
        if self.finish_s is None:
            return float("nan")
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        if self.first_token_s is None:
            return float("nan")
        return self.first_token_s - self.arrival_s

    @property
    def out(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def full_seq(self) -> np.ndarray:
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def emit(self, token: int, now: float) -> None:
        if self.first_token_s is None:
            self.first_token_s = now
        self.tokens.append(int(token))
        self.token_s.append(float(now))

    @property
    def itl_gaps(self) -> np.ndarray:
        if len(self.token_s) < 2:
            return np.empty((0,), np.float64)
        return np.diff(np.asarray(self.token_s, np.float64))


def poisson_trace(n_requests: int, *, rate_rps: float, prompt_len: int,
                  max_new: int, vocab_size: int, seed: int = 0,
                  min_new: Optional[int] = None,
                  prompt_jitter: int = 0) -> List[Request]:
    """Open-loop arrivals at ``rate_rps`` (exponential gaps), prompts of
    ``prompt_len`` +- ``prompt_jitter`` random tokens and decode budgets in
    ``[min_new, max_new]`` (default min_new ``max(1, max_new // 4)``).
    Deterministic given ``seed``, draw for draw the JAX package's trace."""
    if not rate_rps > 0:
        raise ValueError(f"rate_rps must be > 0 (requests/s), got "
                         f"{rate_rps!r}")
    rng = np.random.default_rng(seed)
    min_new = max(1, max_new // 4) if min_new is None else max(1, min_new)
    if min_new > max_new:
        raise ValueError(f"min_new={min_new} exceeds max_new={max_new}")
    reqs, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = prompt_len
        if prompt_jitter:
            plen = max(1, prompt_len + int(rng.integers(-prompt_jitter,
                                                        prompt_jitter + 1)))
        prompt = rng.integers(0, vocab_size, size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new=int(rng.integers(min_new, max_new + 1)),
                            arrival_s=t))
    return reqs


def replay_round(toks: np.ndarray, active: np.ndarray,
                 remaining: np.ndarray, eos_id: int):
    """Host replay of a horizon-M decode round's on-device retirement
    recurrence (``Model.decode_scan``).

    ``toks`` is the raw (M, B) per-step greedy token block of one round;
    ``active`` / ``remaining`` are the round-entry mirrors.  Step by step,
    as the device did::

        for each step, for each entry-active slot:
            emit toks[step, slot]; remaining -= 1
            active &= (token != eos_id) and (remaining > 0)

    The recurrence is the device's, and a retired slot's state is frozen
    by the masked decode, so the emitted streams equal a step-at-a-time
    loop's and the returned exit state equals the device carry row for
    row.  Returns (emitted, active_out, remaining_out): ``emitted[slot]``
    lists the tokens the slot emitted this round (EOS included, as in the
    single-step loop); the arrays are fresh copies.
    """
    M, B = toks.shape
    act = np.asarray(active).astype(bool)
    rem = np.asarray(remaining).copy()
    emitted = [[] for _ in range(B)]
    for m in range(M):
        for b in np.flatnonzero(act):
            t = int(toks[m, b])
            emitted[b].append(t)
            rem[b] -= 1
            if t == eos_id or rem[b] <= 0:
                act[b] = False
    return emitted, act, rem


class SlotAllocator:
    """Fixed pool of decode slots, lowest free index first."""

    def __init__(self, n_slots: int):
        self._free = list(range(n_slots))
        heapq.heapify(self._free)
        self.occupant: List[Optional[int]] = [None] * n_slots

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, rid: int) -> int:
        slot = heapq.heappop(self._free)
        self.occupant[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        if self.occupant[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.occupant[slot] = None
        heapq.heappush(self._free, slot)


class BlockAllocator:
    """The paged pool's ``n_blocks`` physical blocks: ``reserve`` a
    request's worst case at admission, ``alloc`` blocks on demand against
    that reservation, ``release`` everything (and the unused reservation)
    at retirement.  Lowest free block first."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks))
        heapq.heapify(self._free)
        self._held: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self.high_watermark = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - self.free_count

    @property
    def reserved_total(self) -> int:
        return sum(self._reserved.values())

    def can_reserve(self, n: int) -> bool:
        return n <= self.free_count - self.reserved_total

    def reserve(self, rid: int, n: int) -> None:
        if rid in self._reserved:
            raise ValueError(f"request {rid} already holds a reservation")
        if not self.can_reserve(n):
            raise ValueError(f"cannot reserve {n} blocks: {self.free_count} "
                             f"free, {self.reserved_total} already promised")
        self._reserved[rid] = n

    def alloc(self, rid: int) -> int:
        if self._reserved.get(rid, 0) <= 0:
            raise ValueError(f"request {rid} allocating beyond its "
                             f"reservation — admission accounting bug")
        if not self._free:
            raise ValueError("no free blocks despite reservation — "
                             "allocator invariant broken")
        blk = heapq.heappop(self._free)
        self._held.setdefault(rid, []).append(blk)
        self._reserved[rid] -= 1
        self.high_watermark = max(self.high_watermark, self.in_use)
        return blk

    def release(self, rid: int) -> int:
        freed = 0
        for blk in self._held.pop(rid, []):
            heapq.heappush(self._free, blk)
            freed += 1
        self._reserved.pop(rid, None)
        return freed


class Scheduler:
    """FIFO admission of arrived requests into free decode slots, gated on
    block reservations when a :class:`BlockAllocator` is given.  Drive it
    with a non-decreasing ``now``: ``poll`` -> ``admit`` -> decode ->
    ``retire``."""

    def __init__(self, requests: Sequence[Request], max_batch: int,
                 blocks: Optional[BlockAllocator] = None,
                 blocks_needed: Optional[Callable[[Request], int]] = None):
        for r in requests:
            if r.admit_s is not None or r.tokens:
                raise ValueError(f"request {r.rid} was already served; "
                                 f"build a fresh trace per serve")
        if (blocks is None) != (blocks_needed is None):
            raise ValueError("blocks and blocks_needed come as a pair")
        self._pending = deque(sorted(requests,
                                     key=lambda r: (r.arrival_s, r.rid)))
        self._key = lambda r: (r.arrival_s, r.rid)
        self.waiting: List[Request] = []
        self.slots = SlotAllocator(max_batch)
        self.blocks = blocks
        self._blocks_needed = blocks_needed
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []

    def poll(self, now: float) -> int:
        n = 0
        while self._pending and self._pending[0].arrival_s <= now:
            bisect.insort(self.waiting, self._pending.popleft(),
                          key=self._key)
            n += 1
        return n

    def admit(self, now: float) -> List[Tuple[int, Request]]:
        admitted = []
        while self.waiting and self.slots.free_count:
            req = self.waiting[0]
            if self.blocks is not None:
                need = self._blocks_needed(req)
                if not self.blocks.can_reserve(need):
                    break                 # head-of-line waits for capacity
                self.blocks.reserve(req.rid, need)
            self.waiting.pop(0)
            slot = self.slots.alloc(req.rid)
            req.slot = slot
            if req.admit_s is None:
                req.admit_s = now
            self.running[slot] = req
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int, now: float) -> Request:
        req = self.running.pop(slot)
        req.finish_s = now
        self.slots.release(slot)
        if self.blocks is not None:
            self.blocks.release(req.rid)
        self.finished.append(req)
        return req

    @property
    def done(self) -> bool:
        return not (self._pending or self.waiting or self.running)

    def next_arrival_s(self) -> Optional[float]:
        return self._pending[0].arrival_s if self._pending else None


def _pctile(vals: np.ndarray, q: float) -> float:
    vals = vals[~np.isnan(vals)]
    return float(np.percentile(vals, q)) if vals.size else 0.0


def summarize(requests: Sequence[Request], wall_s: float,
              mode: str = "") -> Dict:
    """Throughput and latency percentiles over a request set."""
    if not requests:
        return {"mode": mode, "n_requests": 0, "tokens": 0, "wall_s": wall_s,
                "tok_per_s": 0.0, "p50_latency_s": 0.0, "p99_latency_s": 0.0,
                "p50_ttft_s": 0.0, "p99_ttft_s": 0.0,
                "p50_itl_s": 0.0, "p99_itl_s": 0.0}
    lats = np.asarray([r.latency_s for r in requests])
    ttfts = np.asarray([r.ttft_s for r in requests])
    gaps = np.concatenate([r.itl_gaps for r in requests])
    tokens = int(sum(len(r.tokens) for r in requests))
    return {
        "mode": mode,
        "n_requests": len(requests),
        "tokens": tokens,
        "wall_s": wall_s,
        "tok_per_s": tokens / wall_s if wall_s > 0 else 0.0,
        "p50_latency_s": _pctile(lats, 50),
        "p99_latency_s": _pctile(lats, 99),
        "p50_ttft_s": _pctile(ttfts, 50),
        "p99_ttft_s": _pctile(ttfts, 99),
        "p50_itl_s": _pctile(gaps, 50),
        "p99_itl_s": _pctile(gaps, 99),
    }
