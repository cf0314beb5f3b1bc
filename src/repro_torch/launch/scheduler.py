"""Host-side scheduling for the continuous-batching engine (numpy only).

The port's own copy of the JAX package's scheduler: the request record,
the Poisson arrival trace (same numpy draws for the same seed, so both
engines serve the identical trace), the slot allocator, the ref-counted
block allocator behind the prefix cache, admission (FIFO, or ordered by
an SLO policy's key), preemption, retirement and the latency summary.
The scheduler takes any policy with ``sort_key``; it does not import
``slo``.
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
    # SLO class: lower = more urgent; FIFO ignores it
    priority: int = 0
    slo_class: str = ""

    admit_s: Optional[float] = None     # FIRST admission into a slot
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_s: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0                # times evicted from a slot
    prefilled_tokens: int = 0           # tokens the engine forwarded
    # prefix-cache blocks shared into the current admission, and the
    # tokens ever served from the cache (cumulative over re-admissions)
    prefix_blocks: List[int] = dataclasses.field(default_factory=list)
    prefix_hit_tokens: int = 0
    # self-speculative rounds run, draft tokens accepted over them, and
    # wall seconds of this request's share of the draft passes
    spec_rounds: int = 0
    spec_accepted: int = 0
    draft_s: float = 0.0

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
    def queue_s(self) -> float:
        """Arrival -> first admission; NaN while still queued."""
        if self.admit_s is None:
            return float("nan")
        return self.admit_s - self.arrival_s

    @property
    def accepted_per_step(self) -> float:
        """Mean draft tokens accepted per speculative round; NaN for a
        request that ran none (``summarize`` skips NaNs)."""
        if self.spec_rounds == 0:
            return float("nan")
        return self.spec_accepted / self.spec_rounds

    @property
    def out(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def full_seq(self) -> np.ndarray:
        """Prompt and every emitted token: what a preempted request must
        restore (its re-admission lookup runs over this)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def emit(self, token: int, now: float) -> None:
        """Record one token; TTFT is set once (a restore keeps it)."""
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
                  prompt_jitter: int = 0,
                  shared_prefix_len: int = 0,
                  priority_mix: Optional[Sequence[Tuple[str, int, float]]]
                  = None) -> List[Request]:
    """Open-loop arrivals at ``rate_rps`` (exponential gaps), prompts of
    ``prompt_len`` +- ``prompt_jitter`` random tokens and decode budgets in
    ``[min_new, max_new]`` (default min_new ``max(1, max_new // 4)``).
    ``shared_prefix_len`` > 0 prepends one fixed random prefix of that
    many tokens to every prompt (``prompt_len`` then sizes the unique
    tail); ``priority_mix`` draws each request's SLO class from weighted
    ``(name, priority, weight)`` entries.  Deterministic given ``seed``,
    draw for draw the JAX package's trace."""
    if not rate_rps > 0:
        raise ValueError(f"rate_rps must be > 0 (requests/s), got "
                         f"{rate_rps!r}")
    if shared_prefix_len < 0:
        raise ValueError(
            f"shared_prefix_len must be >= 0, got {shared_prefix_len}")
    rng = np.random.default_rng(seed)
    min_new = max(1, max_new // 4) if min_new is None else max(1, min_new)
    if min_new > max_new:
        raise ValueError(f"min_new={min_new} exceeds max_new={max_new}")
    shared = (rng.integers(0, vocab_size, size=(shared_prefix_len,))
              .astype(np.int32) if shared_prefix_len else None)
    mix_p = None
    if priority_mix is not None:
        if not priority_mix:
            raise ValueError("priority_mix must be a non-empty sequence of "
                             "(class_name, priority, weight)")
        w = np.asarray([float(m[2]) for m in priority_mix], np.float64)
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"priority_mix weights must be non-negative "
                             f"with a positive sum, got {list(w)}")
        mix_p = w / w.sum()
    reqs, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = prompt_len
        if prompt_jitter:
            plen = max(1, prompt_len + int(rng.integers(-prompt_jitter,
                                                        prompt_jitter + 1)))
        prompt = rng.integers(0, vocab_size, size=(plen,)).astype(np.int32)
        if shared is not None:
            prompt = np.concatenate([shared, prompt])
        name, prio = "", 0
        if mix_p is not None:
            name, prio, _ = priority_mix[int(rng.choice(len(mix_p),
                                                        p=mix_p))]
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new=int(rng.integers(min_new, max_new + 1)),
                            arrival_s=t, priority=int(prio),
                            slo_class=str(name)))
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
    """Fixed pool of ``n_slots`` decode slots, optionally partitioned into
    per-shard pools.

    On a mesh the executor holds the slots in contiguous chunks over the
    data axes (``sharding.slot_shard_map``); admission then balances
    data-parallel work by taking a free slot from the shard with the MOST
    free slots (ties -> lowest shard index), lowest slot index within the
    shard.  With ``n_shards == 1`` this is lowest-index-first reuse."""

    def __init__(self, n_slots: int, n_shards: int = 1,
                 shard_of: Optional[Sequence[int]] = None):
        self.n_slots = n_slots
        self.n_shards = max(int(n_shards), 1)
        if shard_of is None:  # contiguous chunks
            shard_of = [(s * self.n_shards) // n_slots for s in range(n_slots)]
        self.shard_of = [int(s) for s in shard_of]
        assert len(self.shard_of) == n_slots
        self._free: List[List[int]] = [
            [s for s in range(n_slots) if self.shard_of[s] == i]
            for i in range(self.n_shards)]
        for pool in self._free:
            heapq.heapify(pool)
        self.occupant: List[Optional[int]] = [None] * n_slots  # slot -> rid

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free)

    def free_per_shard(self) -> List[int]:
        return [len(f) for f in self._free]

    def shard_order(self) -> List[int]:
        """Shards with a free slot, in admission preference: most free
        slots first, ties to the lowest index."""
        return sorted((i for i in range(self.n_shards) if self._free[i]),
                      key=lambda i: (-len(self._free[i]), i))

    def alloc(self, rid: int, shard: Optional[int] = None) -> int:
        """A free slot for ``rid``: from ``shard`` when given, else from
        the shard with the most free slots."""
        if shard is None:
            shard = max(range(self.n_shards),
                        key=lambda i: (len(self._free[i]), -i))
        slot = heapq.heappop(self._free[shard])
        self.occupant[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        if self.occupant[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.occupant[slot] = None
        heapq.heappush(self._free[self.shard_of[slot]], slot)


class BlockAllocator:
    """The paged pool's ``n_blocks`` physical blocks, lowest free first,
    optionally partitioned into per-shard pools mirroring the pool's
    block-over-data layout (``sharding.block_shard_map``).

    ``reserve`` books a request's blocks at admission, ``alloc`` takes one
    exclusive block against that reservation, ``release`` drops every
    reference the request holds and its unused reservation.  Every
    in-use block carries a refcount: ``attach`` shares populated blocks
    read-only into a request (a prefix hit), the prefix cache pins blocks
    with ``ref_block`` / ``unref_block``, and a block is freed only when
    its last reference drops.  ``fork`` is copy-on-write: a shared
    reference is traded for a fresh exclusive block (the caller copies the
    data).  ``capacity_version`` grows whenever capacity may have grown (a
    block freed, a reservation refunded), so a blocked admission knows when
    to retry.

    With ``n_shards > 1`` (mesh serving, where each rank holds only its
    shard's blocks and computes only its own slots' rows) every
    reservation is booked against one shard (``reserve(rid, n, shard=)``)
    and every block of it comes from that shard's pool, so a slot's blocks
    stay on its shard.
    """

    def __init__(self, n_blocks: int, n_shards: int = 1,
                 shard_of: Optional[Sequence[int]] = None):
        self.n_blocks = n_blocks
        self.n_shards = max(int(n_shards), 1)
        if shard_of is None:  # contiguous chunks
            shard_of = [(b * self.n_shards) // n_blocks
                        for b in range(n_blocks)]
        self.shard_of = [int(s) for s in shard_of]
        assert len(self.shard_of) == n_blocks
        # per-shard min-heaps, lowest block id first
        self._pools: List[List[int]] = [
            [b for b in range(n_blocks) if self.shard_of[b] == i]
            for i in range(self.n_shards)]
        for pool in self._pools:
            heapq.heapify(pool)
        self.owner: List[Optional[int]] = [None] * n_blocks
        self.refcount: List[int] = [0] * n_blocks
        self._held: Dict[int, List[int]] = {}   # rid -> blocks, in order
        self._reserved: Dict[int, int] = {}     # rid -> outstanding blocks
        self._res_shard: Dict[int, int] = {}    # rid -> shard (sharded)
        self.high_watermark = 0
        self.capacity_version = 0

    @property
    def _free(self) -> List[int]:
        """The free block ids (the one heap when unsharded)."""
        if self.n_shards == 1:
            return self._pools[0]
        return [b for pool in self._pools for b in pool]

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._pools)

    def shard_capacity(self) -> List[int]:
        """Blocks each shard's pool holds in all."""
        return [self.shard_of.count(i) for i in range(self.n_shards)]

    @property
    def in_use(self) -> int:
        """Blocks holding live data; a block shared N ways counts once."""
        return self.n_blocks - self.free_count

    @property
    def reserved_total(self) -> int:
        return sum(self._reserved.values())

    def owned_by(self, rid: int) -> List[int]:
        """Blocks ``rid`` references (shared prefix blocks first), in
        logical-block order."""
        return list(self._held.get(rid, ()))

    def is_shared(self, blk: int) -> bool:
        return self.refcount[blk] > 1

    def can_reserve(self, n: int, shard: Optional[int] = None) -> bool:
        if shard is None:
            return n <= self.free_count - self.reserved_total
        promised = sum(r for rid, r in self._reserved.items()
                       if self._res_shard.get(rid) == shard)
        return n <= len(self._pools[shard]) - promised

    def reserve(self, rid: int, n: int, shard: Optional[int] = None) -> None:
        if rid in self._reserved:
            raise ValueError(f"request {rid} already holds a reservation")
        if self.n_shards > 1 and shard is None:
            raise ValueError("a sharded allocator books each reservation "
                             "against one shard: pass shard=")
        if not self.can_reserve(n, shard):
            raise ValueError(f"cannot reserve {n} blocks: {self.free_count} "
                             f"free, {self.reserved_total} already promised")
        self._reserved[rid] = n
        if shard is not None:
            self._res_shard[rid] = int(shard)

    def reserved_of(self, rid: int) -> int:
        """Blocks still promised (reserved, not yet allocated) to ``rid``."""
        return self._reserved.get(rid, 0)

    def grow_reserve(self, rid: int, n: int = 1) -> None:
        """Grow an admitted request's reservation by ``n`` blocks (the
        optimistic-admission pressure path), under ``reserve``'s gate."""
        if n <= 0:
            raise ValueError(f"grow_reserve needs n > 0, got {n}")
        if rid not in self._reserved:
            raise ValueError(
                f"request {rid} holds no reservation to grow — grow_reserve "
                f"is for admitted requests only")
        if not self.can_reserve(n, self._res_shard.get(rid)):
            raise ValueError(
                f"cannot grow reservation by {n}: {self.free_count} free, "
                f"{self.reserved_total} already promised")
        self._reserved[rid] += n

    def alloc(self, rid: int) -> int:
        """Take one exclusive block for ``rid``, drawing down its
        reservation, from the pool of the shard it was booked against."""
        if self._reserved.get(rid, 0) <= 0:
            raise ValueError(f"request {rid} allocating beyond its "
                             f"reservation — admission accounting bug")
        pool = self._pools[self._res_shard.get(rid, 0)]
        if not pool:
            raise ValueError("no free blocks despite reservation — "
                             "allocator invariant broken")
        blk = heapq.heappop(pool)
        self.owner[blk] = rid
        self.refcount[blk] = 1
        self._held.setdefault(rid, []).append(blk)
        self._reserved[rid] -= 1
        self.high_watermark = max(self.high_watermark, self.in_use)
        return blk

    def attach(self, rid: int, blocks: Sequence[int]) -> None:
        """Share populated blocks read-only into ``rid`` ahead of its own
        allocations; validated before the first reference is taken."""
        if self._held.get(rid):
            raise ValueError(
                f"request {rid} already holds blocks; attach prefix blocks "
                f"before any alloc so logical order is preserved")
        free = [blk for blk in blocks if self.refcount[blk] <= 0]
        if free:
            raise ValueError(
                f"cannot attach free block(s) {free} to request {rid}")
        for blk in blocks:
            self.refcount[blk] += 1
        self._held.setdefault(rid, []).extend(blocks)

    def ref_block(self, blk: int) -> None:
        """Pin a populated block (the prefix cache publishing it)."""
        if self.refcount[blk] <= 0:
            raise ValueError(f"cannot pin free block {blk}")
        self.refcount[blk] += 1

    def unref_block(self, blk: int) -> bool:
        """Drop one pin; True when the block was freed."""
        return self._decref(blk)

    def fork(self, rid: int, blk: int) -> int:
        """Make ``rid``'s reference to ``blk`` exclusive: an exclusive
        block is returned as is, a shared one is swapped for a fresh
        allocation in the same logical position."""
        held = self._held.get(rid, [])
        if blk not in held:
            raise ValueError(f"block {blk} not referenced by request {rid}")
        if self.refcount[blk] == 1:
            return blk
        new = self.alloc(rid)
        held.pop()                       # alloc appended it at the end
        held[held.index(blk)] = new
        self._decref(blk)
        return new

    def _decref(self, blk: int) -> bool:
        if self.refcount[blk] <= 0:
            raise ValueError(f"refcount underflow on block {blk}")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self.owner[blk] = None
            heapq.heappush(self._pools[self.shard_of[blk]], blk)
            self.capacity_version += 1
            return True
        return False

    def release(self, rid: int) -> int:
        """Drop every reference ``rid`` holds (a block with references
        left stays) and its unused reservation; returns blocks freed."""
        freed = 0
        for blk in self._held.pop(rid, []):
            if self.owner[blk] == rid:
                self.owner[blk] = None  # survivors belong to their sharers
            freed += bool(self._decref(blk))
        self._res_shard.pop(rid, None)
        if self._reserved.pop(rid, None):
            self.capacity_version += 1     # reservation refund
        return freed


class Scheduler:
    """Admission of arrived requests into free decode slots — FIFO, or by
    a policy's time-invariant ``sort_key`` — gated on block reservations
    when a :class:`BlockAllocator` is given.  Drive it with a
    non-decreasing ``now``: ``poll`` -> ``admit`` -> decode -> ``retire``
    (or ``preempt`` under pool pressure).

    With a ``prefix`` cache, admission attaches the longest cached prefix
    of ``full_seq`` before it evicts (the extra references keep the hit
    out of the LRU), retirement publishes the prompt's full blocks, and
    preemption publishes the KV actually written so a restore is a suffix
    prefill."""

    def __init__(self, requests: Sequence[Request], max_batch: int,
                 n_shards: int = 1,
                 shard_of: Optional[Sequence[int]] = None,
                 blocks: Optional[BlockAllocator] = None,
                 blocks_needed: Optional[Callable[[Request], int]] = None,
                 prefix=None, policy=None):
        for r in requests:
            if r.admit_s is not None or r.tokens:
                raise ValueError(f"request {r.rid} was already served; "
                                 f"build a fresh trace per serve")
        if (blocks is None) != (blocks_needed is None):
            raise ValueError("blocks and blocks_needed come as a pair")
        if prefix is not None and blocks is None:
            raise ValueError("a prefix cache needs a BlockAllocator")
        self._pending = deque(sorted(requests,
                                     key=lambda r: (r.arrival_s, r.rid)))
        self.policy = policy
        self._key: Callable[[Request], Tuple] = (
            policy.sort_key if policy is not None
            else (lambda r: (r.arrival_s, r.rid)))
        self.waiting: List[Request] = []
        self.slots = SlotAllocator(max_batch, n_shards, shard_of)
        self.blocks = blocks
        self._blocks_needed = blocks_needed
        self.prefix = prefix
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []
        # (rid, capacity_version) of the last admission that failed on
        # blocks: no retry until capacity may have grown
        self._hol_blocked: Optional[Tuple[int, int]] = None

    def poll(self, now: float) -> int:
        n = 0
        while self._pending and self._pending[0].arrival_s <= now:
            bisect.insort(self.waiting, self._pending.popleft(),
                          key=self._key)
            n += 1
        return n

    def _requeue(self, req: Request) -> None:
        """A preempted request goes back at its policy position (its key
        does not change)."""
        bisect.insort(self.waiting, req, key=self._key)

    def admit(self, now: float) -> List[Tuple[int, Request]]:
        admitted = []
        while self.waiting and self.slots.free_count:
            req = self.waiting[0]
            shard = None
            if self.blocks is not None:
                if self._hol_blocked == (req.rid,
                                         self.blocks.capacity_version):
                    break          # nothing changed since the last failure
                hit: List[int] = []
                if self.prefix is not None:
                    hit = self.prefix.lookup(req.full_seq)
                    if hit:
                        # attach before any eviction: the extra reference
                        # makes the matched entries unevictable
                        self.blocks.attach(req.rid, hit)
                need = self._blocks_needed(req) - len(hit)
                if self.blocks.n_shards > 1:
                    # the slot's shard must hold the whole reservation: the
                    # first shard in slot preference whose pool can
                    shard = next((i for i in self.slots.shard_order()
                                  if self.blocks.can_reserve(need, i)), None)
                    if shard is None:
                        self._hol_blocked = (req.rid,
                                             self.blocks.capacity_version)
                        break            # head-of-line waits for capacity
                elif not self.blocks.can_reserve(need):
                    if self.prefix is not None:
                        self.prefix.evict_until(self.blocks, need)
                    if not self.blocks.can_reserve(need):
                        if hit:          # roll back the shared references
                            self.blocks.release(req.rid)
                        self._hol_blocked = (req.rid,
                                             self.blocks.capacity_version)
                        break            # head-of-line waits for capacity
                self.blocks.reserve(req.rid, need, shard)
                req.prefix_blocks = list(hit)
                if self.prefix is not None:
                    req.prefix_hit_tokens += len(hit) * self.prefix.block_size
                    self.prefix.note_lookup(hit,
                                            restore=req.preemptions > 0)
            self.waiting.pop(0)
            slot = self.slots.alloc(req.rid, shard)
            req.slot = slot
            if req.admit_s is None:      # first admission only
                req.admit_s = now
            self.running[slot] = req
            admitted.append((slot, req))
        return admitted

    def preempt(self, slot: int, now: float,
                covered: Optional[int] = None) -> Request:
        """Evict the request in ``slot``: publish the KV of the first
        ``covered`` tokens of ``full_seq`` (all of it when None) into the
        prefix cache, release its blocks and reservation, and re-queue
        it."""
        req = self.running.pop(slot)
        self.slots.release(slot)
        if self.blocks is not None:
            if self.prefix is not None:
                seq = req.full_seq
                if covered is not None:
                    seq = seq[:covered]
                self.prefix.publish(seq, self.blocks.owned_by(req.rid),
                                    self.blocks)
            self.blocks.release(req.rid)
        req.slot = None
        req.preemptions += 1
        req.prefix_blocks = []
        self._requeue(req)
        return req

    def retire(self, slot: int, now: float) -> Request:
        req = self.running.pop(slot)
        req.finish_s = now
        self.slots.release(slot)
        if self.blocks is not None:
            if self.prefix is not None:
                # the cache pins the prompt's full blocks before the
                # request's own references drop
                self.prefix.publish(req.prompt,
                                    self.blocks.owned_by(req.rid),
                                    self.blocks)
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


def _nanmean(vals: np.ndarray) -> float:
    """Mean over the finite entries; 0.0 when there are none."""
    vals = vals[~np.isnan(vals)]
    return float(np.mean(vals)) if vals.size else 0.0


def summarize(requests: Sequence[Request], wall_s: float,
              mode: str = "") -> Dict:
    """Throughput, latency percentiles, preemptions and the speculative
    accounting (0.0 when no request ran a round) over a request set."""
    if not requests:
        return {"mode": mode, "n_requests": 0, "tokens": 0, "wall_s": wall_s,
                "tok_per_s": 0.0, "p50_latency_s": 0.0, "p99_latency_s": 0.0,
                "p50_ttft_s": 0.0, "p99_ttft_s": 0.0,
                "p50_itl_s": 0.0, "p99_itl_s": 0.0, "preemptions": 0,
                "accepted_per_step": 0.0, "draft_overhead_s": 0.0}
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
        "preemptions": int(sum(r.preemptions for r in requests)),
        "accepted_per_step": _nanmean(np.asarray(
            [r.accepted_per_step for r in requests])),
        "draft_overhead_s": float(sum(r.draft_s for r in requests)),
    }
