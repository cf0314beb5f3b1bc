"""Continuous-batching serving engine over PSI-quantized weights (port).

The engine owns ``max_batch`` decode slots over the paged KV pool (or,
with ``--cache-layout dense`` and for SWA configs, a dense per-slot slab:
a ring of ``window`` positions for SWA): a FIFO scheduler admits arriving
requests into free slots mid-decode (paged: gated on a worst-case block
reservation), prefills the admissions of one iteration in one forward at
bucketed lengths (a burst) and writes each row's KV into its slot
(paged: freshly allocated pool blocks), runs one masked decode step over
all slots per iteration, and retires sequences at EOS or their own
``max_new`` — freeing slot and blocks for the next arrival.  ``static``
mode barriers admission until every slot drains (the batch-synchronous
baseline).  For the dense family greedy tokens do not depend on the
mode: a burst row's first token and KV are bit-identical to its prefill
alone.  An MoE burst runs each row whole over the burst's padded length,
as the JAX package does: pad tokens route and take expert capacity, so
its rows can differ from their prefills alone, in both packages.  The
hybrid (recurrentgemma-9b) prefills at exact prompt lengths, since
recurrent state absorbs pad tokens: a burst of unequal prompts prefills
one request at a time.  So does the SSM (falcon-mamba-7b), whose SSM
state lives on the dense layout, and the encoder-decoder (whisper-base),
whose encoder runs over zero stub frames at every prefill and whose
cross attention reads the cached encoder output at every decode step.

With ``--decode-horizon M`` (M > 1) each iteration runs a round of M
steps with EOS and budget retirement on the device and one host sync per
round; the host replays the same recurrence (``scheduler.replay_round``)
to recover the streams, which equal horizon 1's.  Round N+1 is dispatched
from the device carry before the host replays round N.

Context serving (paged only) — ``--prefix-cache on``, ``--prefill-chunk
N`` and ``--slo SPEC``, alone or together — sends every admission through
one per-request suffix prefill that starts at a block-aligned offset ``pos0``
and reads the KV of ``[0, pos0)`` out of the pool:

* the prefix cache serves the longest cached block-aligned prefix of a
  prompt out of ref-counted pool blocks and prefills only the rest;
* chunked prefill splits a long prefill into pieces of N tokens, one per
  loop iteration, interleaved with decode (pieces that are not the last
  skip the lm-head);
* SLO scheduling orders admission by an aged priority, reserves blocks
  optimistically and, under pool pressure, preempts a running request:
  its written KV is published into the prefix cache, and its restore is
  a suffix prefill over ``prompt + generated``, whose last logits are the
  next decode output.

Greedy tokens do not depend on any of them.

With ``--speculative BITS:K`` each iteration is one self-speculative
round: K greedy draft steps with a psiBITS view of the serving codes (no
second checkpoint), then one K-token verify at the serving width; each
slot emits its longest agreed draft prefix plus the target's own next
token, so tokens equal plain decode's.  It composes with the prefix
cache, chunked prefill and SLO scheduling, not with a horizon M > 1 or
the dense layout.

The Server is the host half; device work goes through
``repro_torch.runtime.Executor``, which runs every projection through the
PSI matmul kernel and every paged decode attention read through the paged
attention kernel (CUDA on the card, where each decode step or round is a
CUDA-graph replay; plain PyTorch, eagerly, with ``--device cpu``); the
dense read is plain PyTorch in both places.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --quant psi8 --mode both --device cpu --decode-horizon 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --quant psi8 --mode both --device cpu --prefix-cache on \\
      --shared-prefix-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --quant psi8 --mode both --device cpu --speculative 3:4 \\
      --qat-precondition 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --quant psi8 --mode both --device cpu --cache-layout dense
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --reduced --quant psi8 --mode both \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --reduced --quant psi8 --mode both \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --reduced --quant psi8 --mode both \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-base --reduced --quant psi8 --mode both --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quantizer import (parse_policy, parse_quant_mode,
                                        serving_mode_choices)
from repro_torch.kernels import ops
from repro_torch.launch.prefix_cache import PrefixCache
from repro_torch.launch.scheduler import (BlockAllocator, Request, Scheduler,
                                          poisson_trace, replay_round,
                                          summarize)
from repro_torch.launch.slo import parse_slo_spec, slo_report
from repro_torch.models import attention, build_model, kvcache as kvc
from repro_torch.perf.roofline_model import PEAK_FLOPS, decode_macs_per_token
from repro_torch.runtime import parallel
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.sharding import LeafPlacer

# prompt lengths round up to a multiple of this before prefill; the pad
# rows are masked out of the cache through true_lens
PREFILL_BUCKET = 16


@functools.lru_cache(maxsize=None)
def card_power_limit(card: str) -> float:
    """The power limit in W of the card ``card`` names (its UUID,
    ``GPU-...``, which names the same physical card whatever
    ``CUDA_VISIBLE_DEVICES`` says), as ``nvidia-smi
    --query-gpu=power.limit --format=csv,noheader`` reports it (read once
    per card): the default board power of the tokens-per-joule stat on a
    CUDA device."""
    hint = "pass watts= / --watts to give the board power without the query"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", card],
                             capture_output=True, text=True, timeout=60)
    except OSError as e:                 # no nvidia-smi on this host
        raise RuntimeError(f"cannot run nvidia-smi to read the power limit "
                           f"({e}); {hint}") from None
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi could not read the power limit "
                           f"({out.stderr.strip()}); {hint}")
    return float(out.stdout.strip().splitlines()[0].split()[0])


def card_uuid(dev: torch.device) -> str:
    """The ``GPU-...`` UUID of CUDA device ``dev``, as nvidia-smi names
    the card."""
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def parse_mesh_spec(spec: Optional[str], device=None):
    """"DATAxMODEL" (e.g. "2x2") -> a ("data", "model") ``DeviceMesh`` over
    the ranks of the process group, which is initialised from torchrun's
    environment when the caller has not (NCCL for a CUDA ``device``, gloo
    for the CPU); None -> None (this process alone)."""
    if not spec:
        return None
    try:
        d, m = (int(p) for p in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(
            f"malformed mesh spec {spec!r}: want \"DATAxMODEL\" with two "
            f"integers, e.g. \"2x2\"") from e
    import torch.distributed as dist
    if not dist.is_initialized():
        dev = resolve_device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if d * m != dist.get_world_size():
        raise ValueError(
            f"mesh {spec} needs {d * m} ranks, have {dist.get_world_size()} "
            f"(run under torchrun --nproc-per-node {d * m})")
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((d, m), ("data", "model"))


def parse_spec_spec(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """"BITS:K" (e.g. "3:4") -> (draft_bits, k) for --speculative; None or
    "off" -> None.  BITS is checked against the serving width where that
    is known (build_server); K is the draft length of a round."""
    if not spec or spec == "off":
        return None
    try:
        bits, k = (int(p) for p in spec.split(":"))
    except ValueError as e:
        raise ValueError(
            f"malformed --speculative spec {spec!r}: want \"BITS:K\" with "
            f"two integers, e.g. \"3:4\" (psi3 draft, 4 tokens a round)"
        ) from e
    if k < 1:
        raise ValueError(f"--speculative draft length k={k} must be >= 1")
    return bits, k


class Server:
    """Slot-based serving engine: continuous or batch-synchronous
    scheduling (FIFO, or an SLO policy with preemption) over one masked
    decode step, a round of M steps, or a self-speculative round, on the
    paged or the dense layout."""

    def __init__(self, cfg, params, max_batch: int = 4, max_seq: int = 256,
                 eos_id: int = -1, device=None,
                 n_blocks: Optional[int] = None, decode_horizon: int = 1,
                 prefill_chunk: int = 0, slo=None,
                 speculative: Optional[Tuple[int, int]] = None,
                 watts: Optional[float] = None, mesh=None,
                 params_are_local: bool = False):
        self.cfg = cfg
        self.paged = cfg.resolved_cache_layout == kvc.PAGED
        # decode in rounds of M steps with retirement on the device and one
        # host sync per round; 1 = one step at a time
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError(
                f"decode_horizon={decode_horizon} must be >= 1")
        # self-speculative rounds: (draft_bits, k) or None.  A round writes
        # k positions whatever the budget left, so the last one can write
        # k-1 past the final emitted token: that overhang joins every
        # cache and block extent below.  The executor checks the rest (k,
        # quantized params, no horizon M > 1).
        self.spec = tuple(speculative) if speculative else None
        self.spec_k = self.spec[1] if self.spec else 0
        self._spec_overhang = self.spec_k - 1 if self.spec else 0
        self.prefix_enabled = cfg.prefix_cache_enabled
        if n_blocks is not None and not self.paged:
            raise ValueError(
                "n_blocks/--cache-blocks only applies to the paged cache "
                "layout; this server resolved to dense "
                "(cfg.resolved_cache_layout)")
        self.block_size = cfg.cache_block_size if self.paged else 0
        if self.paged:
            # the paged read attends over n_bt * block_size keys: align the
            # extent to the block grid
            max_seq = -(-max_seq // self.block_size) * self.block_size
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        # SLO scheduling and chunked prefill replay absolute positions
        # from a block-aligned offset, as the prefix cache does
        self.slo = slo
        self.prefill_chunk = int(prefill_chunk or 0)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if self.slo is not None or self.prefill_chunk:
            what = "--slo" if self.slo is not None else "--prefill-chunk"
            if not self.paged:
                raise ValueError(f"{what} requires the paged cache layout "
                                 f"(cfg.resolved_cache_layout)")
            if cfg.rope != "rope":
                raise ValueError(
                    f"{what} replays absolute positions from a block-"
                    f"aligned offset, which needs plain RoPE; got "
                    f"rope={cfg.rope!r}")
        if self.prefill_chunk:
            # chunk boundaries land on the block grid (the context is whole
            # blocks) and on the bucket grid (pos0 + bucket(L - pos0) ==
            # bucket(L) only for a bucket-aligned pos0, so the last piece
            # stays inside the admission's reservation)
            grid = math.lcm(self.block_size, PREFILL_BUCKET)
            self.prefill_chunk = -(-self.prefill_chunk // grid) * grid
        # every admission prefills alone, as a suffix over pool context,
        # when any of the three context consumers is on
        self._ctx_serving = (self.prefix_enabled or self.slo is not None
                             or self.prefill_chunk > 0)
        self.executor = Executor(cfg, params, max_batch=max_batch,
                                 max_seq=max_seq, device=device,
                                 n_blocks=n_blocks,
                                 decode_horizon=self.decode_horizon,
                                 speculative=self.spec, mesh=mesh,
                                 params_are_local=params_are_local)
        # board power of the tokens-per-joule stat: the card's power
        # limit on a CUDA device unless given, 0 (no figure) on the CPU
        dev = self.executor.device
        if watts is None:
            watts = (card_power_limit(card_uuid(dev)) if dev.type == "cuda"
                     else 0.0)
        self.watts = float(watts)
        self._swa_window = cfg.window if cfg.attn_type == "swa" else 0
        self._ring_extent = attention.cache_extent(cfg, max_seq)
        # recurrent state absorbs pad tokens: the hybrid and the SSM (and,
        # as in the JAX package, the encoder-decoder) prefill at exact
        # prompt lengths, never in padded buckets
        self._pad_ok = cfg.family not in ("ssm", "hybrid", "encdec")

    # -------------------------------------------------------------- plumbing
    def _bucket_len(self, n: int) -> int:
        if not self._pad_ok:
            return n
        sb = -(-n // PREFILL_BUCKET) * PREFILL_BUCKET
        # pad positions past an SWA ring's extent would roll real prompt
        # tokens out of the window: then the prompt prefills at its exact
        # length
        if self._swa_window and sb > self._ring_extent:
            return n
        return sb

    def _blocks_needed(self, req: Request) -> int:
        """Blocks to reserve at admission, over ``full_seq`` (a restore
        reserves what it needs, not the prompt's worst case).  FIFO: the
        worst case, the bucketed prefill extent or sequence + remaining
        budget (plus the speculative overhang), whichever is longer.  Under
        an SLO policy: optimistic, the bucketed extent plus
        ``reserve_frac`` of the remaining budget (and the overhang); the
        shortfall is secured on demand, with preemption as the valve."""
        L = len(req.full_seq)
        remaining = max(req.max_new - len(req.tokens), 0)
        need = max(self._bucket_len(L), L + remaining + self._spec_overhang)
        if self.slo is not None:
            expected = max(self._bucket_len(L),
                           L + math.ceil(self.slo.reserve_frac * remaining)
                           + self._spec_overhang)
            need = min(need, expected)
        return kvc.blocks_for(need, self.block_size)

    def _worst_extent(self, req: Request) -> int:
        """The most cache a request can need.  Under an SLO policy a
        restore re-prefills prompt + generated in one bucketed piece, so
        the worst case is the bucketed full sequence; every request being
        feasible alone is what makes the preemption valve terminate.  A
        speculative round's overhang adds k-1."""
        if self.slo is not None:
            return self._bucket_len(len(req.prompt) + req.max_new
                                    + self._spec_overhang)
        return max(self._bucket_len(len(req.prompt)),
                   len(req.prompt) + req.max_new + self._spec_overhang)

    def _prefill_admits(self, cache, admits: Sequence[Tuple[int, Request]],
                        sched: Scheduler, bt, chunking: Dict[int, int]):
        """Prefill new admissions and insert each into its slot; returns
        the first greedy token per admission (None for a slot that chunked
        prefill deferred).

        The JAX package's rule: one admission runs a (1, Sb) prefill fused
        with its insert; a burst (static mode, startup, or several
        arrivals in one iteration) runs one forward over all its prompts,
        right-padded to the longest bucket, then inserts each row.  (The
        reference also pads the batch to ``max_batch`` to bound its
        compiles; eager PyTorch has none to bound, and MoE dispatch is per
        row, so those rows change nothing.)  Dense: each row attends at
        its own bucketed length and the PSI kernels' rows do not depend on
        the batch, so a row's first token and KV are bit-identical to its
        prefill alone: greedy tokens do not depend on the scheduling mode.
        MoE: each row attends over the whole padded burst, as in the
        reference, whose pad positions route to experts and take capacity
        (C from the padded length) from later slots' tokens.
        Where right-padding is unsafe — recurrent state (the hybrid), or
        an SWA ring that the longest bucket overruns — and prompt lengths
        differ, each request prefills alone.

        Paged: each admission's prompt blocks are allocated here (drawing
        down its reservation) and written into ``bt``; the insert scatters
        the rows into exactly those blocks (a row's padding past them goes
        to the slot's scratch block).

        Context serving (prefix cache, SLO, chunked prefill) prefills each
        admission alone, since hit depths and restores differ per request:
        a prefix hit's blocks enter the table read-only and only the suffix
        of ``full_seq`` is prefilled; with no hit that suffix is the whole
        prompt."""
        if self._ctx_serving:
            firsts = []
            for slot, req in admits:
                f, cache = self._begin_fill(cache, slot, req, sched, bt,
                                            chunking)
                firsts.append(f)
            return firsts, cache
        lens = [len(r.prompt) for _, r in admits]
        sb = self._bucket_len(max(lens))
        pad_safe = self._pad_ok and not (self._swa_window
                                         and sb > self._ring_extent)
        if len(set(lens)) > 1 and not pad_safe:
            firsts = []
            for adm in admits:
                f, cache = self._prefill_admits(cache, [adm], sched, bt,
                                                chunking)
                firsts.extend(f)
            return firsts, cache
        if self.paged:
            for slot, req in admits:
                bt[slot, :] = -1
                for j in range(kvc.blocks_for(
                        self._bucket_len(len(req.prompt)), self.block_size)):
                    bt[slot, j] = sched.blocks.alloc(req.rid)
        if not (self._swa_window or self.cfg.is_attention_free):
            # a longer prefill, or a decode past max_seq, would wrap the
            # full-attention slab and evict prompt tokens the causal mask
            # still expects (an SWA ring rolls by definition; an SSM's
            # state has no extent)
            need = max(sb, *(len(r.prompt) + r.max_new + self._spec_overhang
                             for _, r in admits))
            if need > self.max_seq:
                raise ValueError(
                    f"request needs cache extent {need} (bucketed prompt + "
                    f"max_new) but Server was built with max_seq="
                    f"{self.max_seq}; size the Server for the longest "
                    f"request")
        B = len(admits)
        toks = np.zeros((B, sb), np.int32)
        for i, (_, req) in enumerate(admits):
            toks[i, :len(req.prompt)] = req.prompt
            req.prefilled_tokens += len(req.prompt)
        tl = np.asarray(lens, np.int32)
        ex = self.executor
        if B == 1:                               # fused prefill + insert
            slot = admits[0][0]
            first, cache = ex.prefill_insert(
                toks, tl, cache, slot, bt[slot] if self.paged else None)
            return [int(first[0])], cache
        row_lens = (None if self.cfg.family == "moe"
                    else [self._bucket_len(n) for n in lens])
        slots = [slot for slot, _ in admits]
        rows = np.stack([bt[slot] for slot in slots]) if self.paged else None
        first, cache = ex.prefill_burst(toks, tl, slots, cache,
                                        row_lens=row_lens, block_rows=rows)
        return [int(f) for f in first], cache

    def _begin_fill(self, cache, slot, req, sched, bt,
                    chunking: Dict[int, int]):
        """Start filling a slot for one (re-)admission: the hit's blocks
        enter the table, then the suffix ``full_seq[pos0:]`` prefills now,
        or, longer than one chunk, the slot enters ``chunking`` and
        advances one piece per loop iteration.  A restored request's
        suffix ends with its pending token (emitted, KV never written), so
        the last piece's logits are the next decode output."""
        pos0 = len(req.prefix_blocks) * self.block_size
        bt[slot, :] = -1
        if req.prefix_blocks:
            cache = self._localize_hit(cache, slot, req, sched)
            bt[slot, :len(req.prefix_blocks)] = req.prefix_blocks
        if (self.prefill_chunk
                and len(req.full_seq) - pos0 > self.prefill_chunk):
            chunking[slot] = pos0
            return None, cache
        return self._fill_piece(cache, slot, req, sched, bt, pos0)

    def _localize_hit(self, cache, slot, req, sched):
        """On a pool split over mesh shards, copy each hit block another
        shard holds into a block of the slot's shard (booked with the
        reservation) and put the copy in its place: the slot's rank reads
        only its own blocks, and the suffix prefill's context is then the
        exact KV the hit named."""
        ex = self.executor
        if ex.n_block_shards == 1:
            return cache
        mine = int(ex.slot_shards[slot])
        moves = []
        for i, blk in enumerate(req.prefix_blocks):
            if int(ex.block_shards[blk]) != mine:
                new = sched.blocks.relocate(req.rid, blk)
                moves.append((int(blk), new))
                req.prefix_blocks[i] = new
        return ex.copy_blocks(cache, moves) if moves else cache

    def _fill_piece(self, cache, slot, req, sched, bt, cur: int):
        """Prefill + insert one piece of ``full_seq`` from the block- and
        bucket-aligned offset ``cur``, over the pool KV of ``[0, cur)``.
        A piece that is not the last is exactly ``prefill_chunk`` tokens
        and skips the lm-head; the last is the bucketed remainder and
        returns the next greedy token.  Fresh blocks draw down the
        reservation; coverage ends at ``bucket(len(full_seq))``."""
        seq = req.full_seq
        bs = self.block_size
        rem = len(seq) - cur
        final = not (self.prefill_chunk and rem > self.prefill_chunk)
        n = self._bucket_len(rem) if final else self.prefill_chunk
        take = rem if final else n
        for j in range(cur // bs, kvc.blocks_for(cur + n, bs)):
            if bt[slot, j] < 0:
                bt[slot, j] = sched.blocks.alloc(req.rid)
        toks = np.zeros((1, n), np.int32)
        toks[0, :take] = seq[cur:cur + take]
        req.prefilled_tokens += int(take)
        first, cache = self.executor.prefill_insert(
            toks, np.asarray([take], np.int32), cache, slot, bt[slot],
            ctx_ids=bt[slot, :cur // bs], emit=final)
        return (int(first[0]) if final else None), cache

    def _advance_chunk(self, cache, slot, sched, bt,
                       chunking: Dict[int, int]):
        """Advance one chunking slot by one piece; a token (not None)
        means the last piece ran and the slot can decode."""
        req = sched.running[slot]
        cur = chunking[slot]
        first, cache = self._fill_piece(cache, slot, req, sched, bt, cur)
        if first is None:
            chunking[slot] = cur + self.prefill_chunk
        else:
            del chunking[slot]
        return first, cache

    def warmup(self, requests: Sequence[Request]) -> int:
        """Run every prompt bucket the trace can reach once against the
        pool (building the kernels on first use) and, on a card, capture
        the decode graph, so serving measures the steady state.  Prefill is
        eager, so a context depth or a chunk needs no shape of its own.  At
        horizon M > 1 the decode shape is the M-step round: exactly one
        round graph and no single-step graph.  Speculative: one draft and
        one verify graph, and no plain decode graph.  Returns the number of
        shapes run."""
        ex = self.executor
        cache = ex.init_cache()
        brow = np.full((ex.n_bt,), -1, np.int32) if self.paged else None
        buckets = sorted({self._bucket_len(len(r.prompt)) for r in requests})
        for sb in buckets:
            ex.prefill_insert(np.zeros((1, sb), np.int32),
                              np.ones((1,), np.int32), cache, 0, brow)
        B = self.max_batch
        zeros = np.zeros((B, 1), np.int32)
        idle = np.zeros((B,), bool)
        table = (np.full((B, ex.n_bt), -1, np.int32) if self.paged
                 else None)
        if self.spec:
            drafts, _ = ex.draft(zeros, zeros, idle, cache, table)
            ex.verify(zeros, drafts, zeros, idle, cache, table)
        elif self.decode_horizon > 1:
            ex.decode_multi(zeros, zeros, idle, np.zeros((B,), np.int32),
                            cache, table, eos_id=self.eos_id)
        else:
            ex.decode(zeros, zeros, idle, cache, table)
        if ex.device.type == "cuda":
            spec = bool(self.spec)
            want = {"decode": int(self.decode_horizon == 1 and not spec),
                    "decode_multi": int(self.decode_horizon > 1),
                    "draft": int(spec), "verify": int(spec)}
            if ex.graph_counts() != want:
                raise RuntimeError(
                    f"decode graph contract violated at warmup: want "
                    f"{want} at horizon {self.decode_horizon}"
                    f"{', speculative' if spec else ''}, got "
                    f"{ex.graph_counts()}")
            torch.cuda.synchronize(ex.device)
        return len(buckets) + (2 if self.spec else 1)

    def _spec_round(self, sched, cache, tok, pos, act, bt, now_fn):
        """One self-speculative round: the k-step draft pass at the draft
        width, then one k-token verify at the serving width, enqueued back
        to back (the verify builds its window from the drafts on the
        device).  Per slot, accept the longest draft prefix the target
        agrees with (a) and emit min(a+1, k) tokens — the accepted drafts
        and the target's verdict after them, which is the plain-decode
        token there — cut at the budget and at the first EOS.  ``pos``
        advances by the emitted count only: the rejected tail's KV lies at
        or past the next feed position and is overwritten by the next round
        before any query reads it."""
        ex = self.executor
        K = self.spec_k
        t_draft = time.perf_counter()
        drafts_dev, cache = ex.draft(tok, pos, act, cache, bt)
        verdicts_dev, cache = ex.verify(tok, drafts_dev, pos, act, cache, bt)
        drafts = np.asarray(drafts_dev)      # waits for the draft pass only
        draft_dt = time.perf_counter() - t_draft
        verdicts = np.asarray(verdicts_dev)
        now = now_fn()
        share = draft_dt / max(int(act.sum()), 1)
        for slot in list(sched.running):
            if not act[slot]:
                continue        # chunking slot: masked out of the round
            req = sched.running[slot]
            req.draft_s += share
            d, v = drafts[slot], verdicts[slot]
            a = 0
            while a < K and d[a] == v[a]:
                a += 1
            emit = [int(x) for x in d[:a]]
            if a < K:
                emit.append(int(v[a]))
            req.spec_rounds += 1
            req.spec_accepted += a
            finished = False
            n_emit = 0
            for t in emit:
                req.emit(t, now)
                n_emit += 1
                if t == self.eos_id or len(req.tokens) >= req.max_new:
                    finished = True
                    break
            pos[slot, 0] += n_emit
            if finished:
                act[slot] = False
                sched.retire(slot, now)
                bt[slot, :] = -1
            else:
                tok[slot, 0] = emit[n_emit - 1]
        return cache

    # ------------------------------------------------------------- the loop
    def serve(self, requests: Sequence[Request], continuous: bool = True,
              warmup: bool = True):
        """Serve an arrival trace (arrival times on the wall clock from the
        start of this call); returns (finished requests, stats)."""
        clock = time.perf_counter
        ex = self.executor
        # fail fast, before any request is served (an SWA ring rolls by
        # definition and an SSM's state has no extent, so neither needs
        # the check)
        bad = [r.rid for r in requests
               if not (self._swa_window or self.cfg.is_attention_free)
               and self._worst_extent(r) > self.max_seq]
        if bad:
            raise ValueError(
                f"requests {bad} need more cache than max_seq="
                f"{self.max_seq} (bucketed prompt + max_new"
                + (" + the k-1 speculative overhang"
                   if self._spec_overhang else "")
                + "); size the Server for the longest request")
        blocks = None
        if self.paged:
            # on a mesh whose pool splits over ranks, a request's blocks all
            # come from its slot's shard
            blocks = BlockAllocator(ex.n_blocks, n_shards=ex.n_block_shards,
                                    shard_of=ex.block_shards)
            room = max(blocks.shard_capacity())
            bad = [r.rid for r in requests
                   if kvc.blocks_for(self._worst_extent(r), self.block_size)
                   > room]
            if bad:
                raise ValueError(
                    f"requests {bad} need more blocks than the pool holds "
                    f"(n_blocks={ex.n_blocks}"
                    + (f", at most {room} on one shard"
                       if ex.n_block_shards > 1 else "")
                    + ")")
        if warmup:
            self.warmup(requests)
        prefix = None
        if self.prefix_enabled or self.slo is not None:
            # hits aligned to the bucket grid; under an SLO policy the
            # cache is the swap layer preemption publishes into and a
            # restore attaches from, even with --prefix-cache off
            prefix = PrefixCache(self.block_size,
                                 align_tokens=PREFILL_BUCKET)
        sched = Scheduler(requests, self.max_batch,
                          n_shards=ex.n_slot_shards, shard_of=ex.slot_shards,
                          blocks=blocks,
                          blocks_needed=(self._blocks_needed if self.paged
                                         else None),
                          prefix=prefix, policy=self.slo)
        cache = ex.init_cache()
        B = self.max_batch
        tok = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        act = np.zeros((B,), bool)
        # remaining emission budget per slot: the round's on-device
        # retirement counter (unused at horizon 1)
        rem = np.zeros((B,), np.int32)
        bt = ex.make_block_table() if self.paged else None
        chunking: Dict[int, int] = {}      # slot -> next piece's offset
        steps = rounds = host_syncs = loop_iters = peak_running = 0
        n_chunks = 0
        M = self.decode_horizon
        multi = M > 1
        # rounds are pipelined: round N+1 is dispatched from the device
        # carry before the host replays round N, so host work overlaps
        # device work.  Preemption and chunked prefill change slot state
        # at any boundary, so under them each round is drained at once.
        pipeline = multi and self.slo is None and not self.prefill_chunk
        pending = None        # the in-flight round's RoundTokens
        carry = None          # device carry chained round to round
        prefills0 = ex.prefill_calls
        headless0 = ex.prefill_headless
        launches0 = ops.launch_counts()
        colls0 = parallel.collective_counts()
        copied0 = ex.blocks_copied
        # on a mesh every rank admits on rank 0's clock, so all take the
        # same decisions at the same iteration
        now_fn = ((lambda: clock() - t0) if ex.mesh is None
                  else (lambda: ex.agree_time(clock() - t0)))
        t0 = clock()

        def retire(slot, now):
            act[slot] = False
            sched.retire(slot, now)
            if self.paged:
                bt[slot, :] = -1

        def process_toks(round_toks) -> None:
            """Sync one finished round and replay the device's retirement
            recurrence over the host mirrors: emit each slot's tokens,
            retire EOS- or budget-ended slots, and leave tok/pos/act/rem
            equal to the device carry row for row."""
            nonlocal host_syncs
            toks = np.asarray(round_toks)                # (M, B) host sync
            host_syncs += 1
            now = clock() - t0
            emitted, act_out, rem_out = replay_round(toks, act, rem,
                                                     self.eos_id)
            for slot in list(sched.running):
                if not emitted[slot]:
                    continue             # not active when the round began
                req = sched.running[slot]
                for t in emitted[slot]:
                    req.emit(t, now)
                pos[slot, 0] += len(emitted[slot])
                tok[slot, 0] = emitted[slot][-1]
                rem[slot] = rem_out[slot]
                if not act_out[slot]:
                    retire(slot, now)

        def drain() -> None:
            """Process the in-flight round, if any.  Runs before any host
            change of tok/pos/act/rem outside :func:`process_toks`: while a
            round is in flight the mirrors lag the device by one round."""
            nonlocal pending
            if pending is not None:
                prev, pending = pending, None
                process_toks(prev)

        def emit_first(slot: int, req: Request, first: int,
                       now: float) -> None:
            """Book a prefill's token and arm the slot for decode (fresh
            admission, last chunk and restore alike: the feed position is
            the index of the newest token of ``full_seq``)."""
            nonlocal carry
            carry = None           # host mutated: rebuild from the mirrors
            req.emit(first, now)
            if first == self.eos_id or len(req.tokens) >= req.max_new:
                retire(slot, now)
                return
            tok[slot, 0] = first
            pos[slot, 0] = len(req.prompt) + len(req.tokens) - 1
            act[slot] = True
            rem[slot] = req.max_new - len(req.tokens)

        def preempt_slot(vslot: int, vnow: float) -> None:
            """Evict a victim: publish only the KV actually written (a
            decode victim's pending token has none — ``pos`` is its feed
            position; a chunking victim has exactly ``[0, cur)``), clear
            the slot and re-queue the request at its policy position."""
            nonlocal carry
            carry = None           # host mutated: rebuild from the mirrors
            covered = chunking.pop(vslot, None)
            if covered is None:
                covered = int(pos[vslot, 0])
            sched.preempt(vslot, vnow, covered=covered)
            act[vslot] = False
            bt[vslot, :] = -1
            tok[vslot, 0] = 0
            pos[vslot, 0] = 0

        def secure_one(req: Request) -> bool:
            """Make one more block allocatable for ``req`` (the optimistic
            reservation's pressure path): spend its reservation if any is
            left, else free capacity — LRU prefix eviction first, then
            preempt the policy's preferred victim — and grow it.  False
            when ``req`` itself had to yield its slot; the caller then
            skips the alloc.  Terminates: each pass evicts or preempts, and
            a lone runner always fits (the per-request fail-fast)."""
            if sched.blocks.reserved_of(req.rid) > 0:
                return True
            # a pool split over mesh shards: the request's own shard must
            # make room (its blocks all live there)
            shard = sched.blocks.shard_of_request(req.rid)
            while not sched.blocks.can_reserve(1, shard):
                if prefix is not None:
                    prefix.evict_until(sched.blocks, 1, shard)
                    if sched.blocks.can_reserve(1, shard):
                        break
                victims = [s for s in sched.running if s != req.slot
                           and (shard is None
                                or int(ex.slot_shards[s]) == shard)]
                if not victims:
                    preempt_slot(req.slot, clock() - t0)
                    return False
                v = max(victims,
                        key=lambda s: self.slo.victim_key(sched.running[s]))
                preempt_slot(v, clock() - t0)
            sched.blocks.grow_reserve(req.rid, 1)
            return True

        while not sched.done:
            loop_iters += 1
            now = now_fn()
            sched.poll(now)
            if continuous or not sched.running:
                admits = sched.admit(now)
                if admits:
                    drain()    # mirrors must be current before emit_first
                    firsts, cache = self._prefill_admits(cache, admits,
                                                         sched, bt, chunking)
                    if any(f is not None for f in firsts):
                        host_syncs += 1
                    now = clock() - t0
                    peak_running = max(peak_running, len(sched.running))
                    for (slot, req), first in zip(admits, firsts):
                        if first is not None:   # None: chunking, no token
                            emit_first(slot, req, first, now)
            if chunking:
                # one piece per loop iteration, lowest slot first: a long
                # prefill interleaves with decode instead of stalling it
                slot = min(chunking)
                first, cache = self._advance_chunk(cache, slot, sched, bt,
                                                   chunking)
                n_chunks += 1
                if first is not None:
                    host_syncs += 1
                    emit_first(slot, sched.running[slot], first,
                               clock() - t0)
            if not sched.running:
                if sched.waiting:
                    continue
                nxt = sched.next_arrival_s()
                if nxt is None:
                    break
                wait = nxt - (clock() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.25))
                continue
            if not act.any():
                continue       # every running slot is still mid-chunking
            # alloc-on-demand (paged): every block this step's or round's
            # writes can touch must exist before it runs.  FIFO reserved
            # the worst case at admission; an SLO policy secures the
            # shortfall here.  A round writes up to M positions, a
            # speculative round k, and with a round in flight the device
            # carry may already be M ahead of the host mirror, so the span
            # grows by M.  Positions past a request's last feed (prompt +
            # max_new - 2) hold no emitted token's KV: a block there is
            # never needed.
            span = max(self.spec_k, M)
            if pipeline and pending is not None:
                span += M
            for slot, req in list(sched.running.items()):
                if not (self.paged and act[slot]):
                    continue        # dense, chunking, or preempted just now
                p0 = int(pos[slot, 0])
                hi = min(p0 + span - 1, len(req.prompt) + req.max_new - 2)
                for li in range(p0 // self.block_size,
                                hi // self.block_size + 1):
                    if bt[slot, li] < 0:
                        if self.slo is not None and not secure_one(req):
                            break   # req itself yielded its slot
                        bt[slot, li] = sched.blocks.alloc(req.rid)
            if not act.any():
                continue           # the pressure path preempted every decoder
            if self.spec:
                cache = self._spec_round(sched, cache, tok, pos, act, bt,
                                         lambda: clock() - t0)
                host_syncs += 2          # the drafts, then the verdicts
                steps += 1
                continue
            if multi:
                # one horizon-M round, chained from the device carry when
                # the host has not touched its mirrors since the last round
                src = carry if carry is not None else {
                    "token": tok, "pos": pos, "active": act,
                    "remaining": rem}
                round_toks, carry, cache = ex.decode_multi(
                    src["token"], src["pos"], src["active"],
                    src["remaining"], cache, bt, eos_id=self.eos_id)
                steps += M
                rounds += 1
                prev, pending = pending, round_toks
                if prev is not None:
                    # the device already runs round N+1 while the host
                    # replays round N here
                    process_toks(prev)
                if not pipeline:
                    drain()
                continue
            new_tok, cache = ex.decode(tok, pos, act, cache, bt)
            new_tok = new_tok.cpu().numpy()
            host_syncs += 1
            steps += 1
            now = clock() - t0
            for slot in list(sched.running):
                if not act[slot]:
                    continue            # chunking slot: masked this step
                req = sched.running[slot]
                t = int(new_tok[slot])
                req.emit(t, now)
                pos[slot, 0] += 1
                if t == self.eos_id or len(req.tokens) >= req.max_new:
                    retire(slot, now)
                else:
                    tok[slot, 0] = t
        drain()         # a trailing all-masked round can still be in flight
        wall = clock() - t0
        stats = summarize(sched.finished, wall,
                          mode="continuous" if continuous else "static")
        launches = ops.launch_counts()
        colls = parallel.collective_counts()
        n_done = max(len(sched.finished), 1)
        prefilled = int(sum(r.prefilled_tokens for r in sched.finished))
        stats.update({
            "device": str(ex.device),
            "decode_steps": steps,
            "decode_horizon": M,
            "decode_rounds": rounds,
            # captured graphs of the decode path (0 on the CPU: eager)
            "decode_compiles": ex.graph_counts()[
                "decode_multi" if multi else "decode"],
            "prefill_forwards": ex.prefill_calls - prefills0,
            # ... of which skipped the lm-head (chunks that are not the last)
            "prefill_forwards_headless": ex.prefill_headless - headless0,
            "kernel_launches": {k: launches[k] - launches0[k]
                                for k in launches},
            # slot shards the scheduler partitions over (1 off a mesh) and
            # the collectives this rank issued
            "slot_shards": ex.n_slot_shards,
            "collectives": {k: colls[k] - colls0[k] for k in colls},
            "cache_layout": "paged" if self.paged else "dense",
            "cache_bytes": kvc.cache_nbytes(cache),
            "peak_concurrency": peak_running,
            # every host-blocking device-to-host read the loop paid: decode
            # steps or rounds, and prefill first tokens
            "host_syncs": host_syncs,
            "host_syncs_per_token": round(
                host_syncs / max(stats["tokens"], 1), 4),
            "loop_iters": loop_iters,
            # the per-request forwarded count: chunks, restores and hits
            # all move it away from len(prompt) - hits
            "prefilled_tokens": prefilled,
            "prefilled_tokens_mean": round(prefilled / n_done, 2),
            "prefix_tokens_reused": int(sum(r.prefix_hit_tokens
                                            for r in sched.finished)),
        })
        # MFU and tokens per joule (the paper's MACs/W figure of merit
        # tied to measured throughput): MACs a token from the analytic
        # roofline at the mean final context, the peak the card's times the
        # mesh's size, energy the board power (watts)
        fin = sched.finished
        mean_ctx = (sum(len(r.full_seq) for r in fin) / len(fin)
                    if fin else 1.0)
        macs_tok = decode_macs_per_token(self.cfg, int(mean_ctx))
        stats["macs_per_token"] = round(macs_tok, 1)
        stats["mfu"] = round(2.0 * macs_tok * stats["tok_per_s"]
                             / (PEAK_FLOPS * ex.mesh_size), 8)
        stats["watts"] = self.watts
        stats["tokens_per_joule"] = (round(stats["tok_per_s"] / self.watts, 4)
                                     if self.watts > 0 else 0.0)
        if self.prefill_chunk:
            stats["prefill_chunks"] = n_chunks
        if self.slo is not None:
            stats["slo"] = {"aging_s": self.slo.aging_s,
                            "reserve_frac": self.slo.reserve_frac,
                            "classes": slo_report(sched.finished, self.slo)}
        if self.spec:
            n_rounds = int(sum(r.spec_rounds for r in sched.finished))
            accepted = int(sum(r.spec_accepted for r in sched.finished))
            stats["speculative"] = {
                "draft_bits": self.spec[0], "k": self.spec[1],
                "rounds": n_rounds, "accepted_draft_tokens": accepted,
                "mean_accepted": (round(accepted / n_rounds, 3)
                                  if n_rounds else 0.0),
                "spec_compiles": ex.spec_cache_sizes()}
        if self.paged:
            stats.update({
                "block_size": self.block_size,
                "n_blocks": ex.n_blocks,
                "block_table_transfers": dict(bt.stats),
                "peak_blocks_in_use": blocks.high_watermark,
                # prefix-hit blocks copied from another shard of a split
                # pool into the slot's (0 off a mesh)
                "blocks_copied": ex.blocks_copied - copied0,
                "block_util_pct": round(
                    100.0 * blocks.high_watermark / max(ex.n_blocks, 1), 1)})
            if prefix is not None:
                stats["prefix_cache"] = prefix.stats()
                # the allocator is back to its initial state only once the
                # LRU is drained: then blocks_free_end == n_blocks (the leak
                # check)
                prefix.drain(blocks)
            stats["blocks_free_end"] = blocks.free_count
        return sched.finished, stats


def build_server(args) -> Tuple[Server, object]:
    """Config, random PSI-quantized params (seeded, quantized leaf by leaf
    on the device) and the Server, from the CLI flags."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    over = {"cache_layout": getattr(args, "cache_layout", "auto") or "auto",
            "cache_block_size": int(getattr(args, "block_size", 0)
                                    or cfg.cache_block_size)}
    if getattr(args, "n_layers", 0):
        over["n_layers"] = int(args.n_layers)
    if getattr(args, "d_model", 0):
        if not args.reduced:
            raise ValueError("--d-model widens a --reduced config")
        over["d_model"] = int(args.d_model)
    over["prefix_cache"] = getattr(args, "prefix_cache", "off") == "on"
    cfg = dataclasses.replace(cfg, **over)
    cfg.resolved_cache_layout        # validate the layout and the prefix
    cfg.prefix_cache_enabled         # cache before the weights are drawn
    device = resolve_device(getattr(args, "device", None))
    mesh = parse_mesh_spec(getattr(args, "mesh", None), device)
    if mesh is not None and device.type == "cuda":
        # one card a rank: torchrun's local rank picks it
        import os
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    policy = parse_policy(getattr(args, "quant_policy", None))
    spec = parse_spec_spec(getattr(args, "speculative", None))
    if spec:
        kind, sbits = parse_quant_mode(args.quant)
        if kind != "psi" or sbits <= spec[0]:
            raise ValueError(
                f"--speculative {spec[0]}:{spec[1]} derives the draft from "
                f"the PSI serving codes, so it needs a wider serving format "
                f"(--quant psiN with N > {spec[0]}); got --quant "
                f"{args.quant}")
    # --qat-precondition: each leaf is snapped to that grid as it is drawn
    pre = int(getattr(args, "qat_precondition", 0) or 0)
    model = build_model(cfg)
    # on a mesh each rank draws every leaf and keeps its share only: no
    # rank holds the whole model
    share = (None if mesh is None
             else LeafPlacer(cfg, mesh, mode="serve"))
    if args.quant != "none" or policy:
        _, bits = parse_quant_mode(args.quant)
        params = model.init(seed=args.seed, device=device, bits=bits,
                            pack=True, policy=policy, qat_precondition=pre,
                            share=share)
        mode = args.quant
        if mode == "none" and policy and policy.get("default"):
            mode = f"psi{policy['default']}"
        cfg = dataclasses.replace(cfg, quant_mode=mode)
    else:
        params = model.init(seed=args.seed, device=device,
                            qat_precondition=pre, share=share)
    # the cache extent covers the bucketed prompt (a shared prefix
    # included) plus the decode budget, plus k-1 for a speculative round's
    # overhang
    longest = (args.prompt_len + args.prompt_jitter
               + getattr(args, "shared_prefix_len", 0))
    prompt_pad = -(-longest // PREFILL_BUCKET) * PREFILL_BUCKET
    max_seq = prompt_pad + args.max_new + 8 + (spec[1] - 1 if spec else 0)
    chunk = int(getattr(args, "prefill_chunk", 0) or 0)
    slo = parse_slo_spec(getattr(args, "slo", "off") or "off")
    if slo is not None or chunk:
        # a restore re-prefills prompt + generated in one bucketed piece,
        # which can pass the prompt-only pad by up to one bucket
        max_seq += PREFILL_BUCKET
    # the block grid for every layout: dense then attends over the same
    # extent as paged
    bsz = cfg.cache_block_size
    max_seq = -(-max_seq // bsz) * bsz
    server = Server(cfg, params, max_batch=args.max_batch, max_seq=max_seq,
                    eos_id=args.eos_id, device=device,
                    n_blocks=getattr(args, "cache_blocks", None),
                    decode_horizon=int(getattr(args, "decode_horizon", 1)),
                    prefill_chunk=chunk, slo=slo, speculative=spec,
                    watts=getattr(args, "watts", None), mesh=mesh,
                    params_are_local=mesh is not None)
    return server, cfg


def trace_from_args(args, cfg):
    """The arrival trace of the CLI flags: drawn from ``--trace-seed`` when
    it is given, else from ``--seed`` (which also fixes the weights), so
    traffic can vary against fixed weights; ``--priority-mix`` draws each
    request's SLO class from the ``--slo`` policy's classes."""
    seed = getattr(args, "trace_seed", None)
    if seed is None:
        seed = args.seed
    mix = None
    pm = getattr(args, "priority_mix", None)
    if pm:
        slo = parse_slo_spec(getattr(args, "slo", "off") or "off")
        if slo is None:
            raise ValueError("--priority-mix draws classes from the --slo "
                             "policy; pass --slo as well")
        mix = slo.mix([float(x) for x in pm.split(",")])
    return poisson_trace(args.requests, rate_rps=args.arrival_rate,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         min_new=args.min_new,
                         prompt_jitter=args.prompt_jitter,
                         shared_prefix_len=getattr(args, "shared_prefix_len",
                                                   0),
                         vocab_size=cfg.vocab_size, seed=int(seed),
                         priority_mix=mix)


def _positive_rate(s: str) -> float:
    v = float(s)
    if not v > 0:
        raise argparse.ArgumentTypeError(
            f"--arrival-rate must be > 0 requests/s, got {s!r}")
    return v


def add_serve_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="with --reduced, this residual width (0 = the "
                         "reduced config's); 1024 or more puts the weights "
                         "tensor-parallel over a mesh's model axis")
    ap.add_argument("--quant", default="psi8",
                    choices=list(serving_mode_choices()),
                    help="uniform PSI serving width; sub-byte widths "
                         "bit-plane pack")
    ap.add_argument("--quant-policy", default=None,
                    help='per-leaf mixed precision, e.g. '
                         '"embed=8,w_down=4,default=5"')
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--arrival-rate", type=_positive_rate, default=1000.0)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--min-new", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--prompt-jitter", type=int, default=0)
    ap.add_argument("--cache-layout", default="auto",
                    choices=["auto", *kvc.LAYOUTS],
                    help="decode-cache layout: paged = block pool + per-slot "
                         "block tables (the default for full attention); "
                         "dense = per-slot slabs (required for SWA rings)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="positions per paged block (0 = config default)")
    ap.add_argument("--cache-blocks", type=int, default=None,
                    help="usable pool blocks for the paged layout (default "
                         "max_batch * ceil(max_seq / block_size))")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="-1 disables EOS retirement")
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="shared-prefix block reuse over the paged pool: "
                         "admission serves the longest cached block-aligned "
                         "prompt prefix out of ref-counted blocks and "
                         "prefills only the suffix")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend one fixed random prefix of this many "
                         "tokens to every prompt (--prompt-len then sizes "
                         "the unique tail)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill long prompts in pieces of this many "
                         "tokens, one per loop iteration, interleaved with "
                         "decode (0 = off; rounded up to lcm(block size, "
                         "prefill bucket)); tokens stay identical")
    ap.add_argument("--slo", default="off",
                    help='SLO scheduling: "off", "default" (interactive/'
                         'standard/batch) or "name:prio:ttft:itl,...", '
                         'with optional "@aging=S" / "@reserve=F" knobs: '
                         'aged-priority admission, optimistic block '
                         'reservation and preemption with a restore from '
                         'the prefix cache')
    ap.add_argument("--priority-mix", default=None, metavar="W1,W2,...",
                    help="per-class arrival weights, one per --slo class in "
                         "order; each request draws its class from them")
    ap.add_argument("--trace-seed", type=int, default=None,
                    help="seed of the arrival trace alone (default --seed), "
                         "so traffic varies against fixed weights")
    ap.add_argument("--speculative", default=None, metavar="BITS:K",
                    help="self-speculative decoding: draft K tokens a round "
                         "with a psiBITS view of the serving codes (no "
                         "second model), then verify all K in one pass at "
                         "the serving width; tokens equal plain decode's.  "
                         "e.g. \"3:4\"; needs --quant psiN with N > BITS "
                         "and K <= the block size")
    ap.add_argument("--qat-precondition", type=int, default=0,
                    metavar="BITS",
                    help="snap the random weights to the psiBITS grid "
                         "before the serving quantization, as a checkpoint "
                         "trained with the quantizer would be (0 = off); "
                         "random weights' margins drown in low-bit noise, "
                         "so a draft accepts almost nothing without it")
    ap.add_argument("--decode-horizon", type=int, default=1,
                    help="decode steps per round, with retirement on the "
                         "device and one host sync per round (1 = one "
                         "step at a time)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights (and of the arrival trace "
                         "unless --trace-seed is given)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch kernels)")
    ap.add_argument("--watts", type=float, default=None,
                    help="board power for the tokens-per-joule stat (default "
                         "the card's power limit from nvidia-smi on a CUDA "
                         "device, 0 on the CPU: no figure)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help='serving mesh, e.g. "2x2": run one process a rank '
                         "under torchrun (gloo with --device cpu, NCCL on "
                         "cards); decode slots split over the data axis, "
                         "weights tensor-parallel over model where the "
                         "config is wide enough")


def main():
    ap = argparse.ArgumentParser()
    add_serve_args(ap)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "static", "both"])
    args = ap.parse_args()
    server, cfg = build_server(args)
    modes = (["continuous", "static"] if args.mode == "both"
             else [args.mode])
    ex = server.executor
    # on a mesh every rank serves the same trace; its first rank prints
    quiet = False
    if ex.mesh is not None:
        import torch.distributed as dist
        quiet = dist.get_rank() != ex.mesh_ranks()[0]
    for mode in modes:
        done, stats = server.serve(trace_from_args(args, cfg),
                                   continuous=(mode == "continuous"))
        if quiet:
            continue
        horizon = ""
        if "prefix_cache" in stats:
            pc = stats["prefix_cache"]
            horizon += (f" | prefix hit rate {pc['hit_rate']:.2f}, "
                        f"{stats['prefix_tokens_reused']} tok reused / "
                        f"{stats['prefilled_tokens']} prefilled")
        if "prefill_chunks" in stats:
            horizon += f" | {stats['prefill_chunks']} prefill chunks"
        if "slo" in stats:
            horizon += (f" | preemptions {stats['preemptions']}, restores "
                        f"{stats['prefix_cache']['restores']}")
        if "speculative" in stats:
            sp = stats["speculative"]
            horizon += (f" | spec psi{sp['draft_bits']} k={sp['k']}: "
                        f"{sp['rounds']} rounds, "
                        f"{stats['accepted_per_step']:.2f} accepted/round, "
                        f"draft {stats['draft_overhead_s']:.3f}s")
        if stats["decode_horizon"] > 1:
            horizon += (f" | horizon {stats['decode_horizon']}: "
                        f"{stats['decode_rounds']} rounds, "
                        f"{stats['host_syncs_per_token']:.3f} syncs/tok")
        print(f"[{mode}] served {stats['n_requests']} requests on "
              f"{stats['device']}: {stats['tokens']} tokens in "
              f"{stats['wall_s']:.3f}s = {stats['tok_per_s']:.1f} tok/s | "
              f"latency p50 {stats['p50_latency_s'] * 1e3:.0f}ms "
              f"p99 {stats['p99_latency_s'] * 1e3:.0f}ms | "
              f"ttft p50 {stats['p50_ttft_s'] * 1e3:.0f}ms | "
              f"itl p50 {stats['p50_itl_s'] * 1e3:.1f}ms | "
              f"peak concurrency {stats['peak_concurrency']} | "
              f"{stats['macs_per_token']:.4g} MACs/tok, mfu "
              f"{stats['mfu']:.2e}, {stats['tokens_per_joule']:.2f} tok/J @ "
              f"{stats['watts']:.0f}W | slot shards {stats['slot_shards']} "
              f"| cache "
              + (f"paged ({stats['n_blocks']}x{stats['block_size']} blocks, "
                 f"peak util {stats['block_util_pct']}%)"
                 if "n_blocks" in stats else "dense")
              + f" | prefill forwards {stats['prefill_forwards']}"
              f" | decode compiles "
              f"{stats['decode_compiles']} | kernel launches "
              f"{stats['kernel_launches']}{horizon}")
        if "slo" in stats:
            for name, c in stats["slo"]["classes"].items():
                print(f"  [{name}] n={c['n_requests']} ttft p99 "
                      f"{c['p99_ttft_s'] * 1e3:.0f}ms (attain "
                      f"{c['ttft_attainment']:.2f}) | itl p99 "
                      f"{c['p99_itl_s'] * 1e3:.0f}ms (attain "
                      f"{c['itl_attainment']:.2f}) | preemptions "
                      f"{c['preemptions']}")
        for r in sorted(done, key=lambda r: r.rid)[:2]:
            print(f"  req {r.rid}: slot {r.slot}, {len(r.tokens)} tokens, "
                  f"{r.out[:10].tolist()}...")
    if ex.mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
