"""Continuous-batching serving engine over PSI-quantized weights (port).

The engine owns ``max_batch`` decode slots over the paged KV pool: a FIFO
scheduler admits arriving requests into free slots mid-decode (gated on a
worst-case block reservation), prefills each admission at a bucketed
length and scatters its KV into freshly allocated pool blocks, runs one
masked decode step over all slots per iteration, and retires sequences at
EOS or their own ``max_new`` — freeing slot and blocks for the next
arrival.  ``static`` mode barriers admission until every slot drains (the
batch-synchronous baseline).  Greedy tokens do not depend on the mode.

With ``--decode-horizon M`` (M > 1) each iteration runs a round of M
steps with EOS and budget retirement on the device and one host sync per
round; the host replays the same recurrence (``scheduler.replay_round``)
to recover the streams, which equal horizon 1's.  Round N+1 is dispatched
from the device carry before the host replays round N.

The Server is the host half; device work goes through
``repro_torch.runtime.Executor``, which runs every projection through the
PSI matmul kernel and every decode attention read through the paged
attention kernel (CUDA on the card, where each decode step or round is a
CUDA-graph replay; plain PyTorch, eagerly, with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --quant psi8 --mode both --device cpu --decode-horizon 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quantizer import (parse_policy, parse_quant_mode,
                                        serving_mode_choices)
from repro_torch.kernels import ops
from repro_torch.launch.scheduler import (BlockAllocator, Request, Scheduler,
                                          poisson_trace, replay_round,
                                          summarize)
from repro_torch.models import build_model, kvcache as kvc
from repro_torch.runtime.executor import Executor

# prompt lengths round up to a multiple of this before prefill; the pad
# rows are masked out of the cache through true_lens
PREFILL_BUCKET = 16


class Server:
    """Slot-based serving engine: continuous or batch-synchronous FIFO
    scheduling over one masked decode step, or a round of M steps, on the
    paged layout."""

    def __init__(self, cfg, params, max_batch: int = 4, max_seq: int = 256,
                 eos_id: int = -1, device=None,
                 n_blocks: Optional[int] = None, decode_horizon: int = 1):
        self.cfg = cfg
        # decode in rounds of M steps with retirement on the device and one
        # host sync per round; 1 = one step at a time
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError(
                f"decode_horizon={decode_horizon} must be >= 1")
        self.block_size = cfg.cache_block_size
        # the paged read attends over n_bt * block_size keys: align the
        # extent to the block grid
        max_seq = -(-max_seq // self.block_size) * self.block_size
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.executor = Executor(cfg, params, max_batch=max_batch,
                                 max_seq=max_seq, device=device,
                                 n_blocks=n_blocks,
                                 decode_horizon=self.decode_horizon)

    # -------------------------------------------------------------- plumbing
    def _bucket_len(self, n: int) -> int:
        return -(-n // PREFILL_BUCKET) * PREFILL_BUCKET

    def _blocks_needed(self, req: Request) -> int:
        """Worst case at admission: the bucketed prefill extent or prompt +
        remaining budget, whichever is longer."""
        L = len(req.full_seq)
        remaining = max(req.max_new - len(req.tokens), 0)
        need = max(self._bucket_len(L), L + remaining)
        return kvc.blocks_for(need, self.block_size)

    def _prefill_admits(self, cache, admits: Sequence[Tuple[int, Request]],
                        sched: Scheduler, bt):
        """Prefill new admissions and scatter each into its slot's freshly
        allocated blocks; returns the first greedy token per admission.

        Each admission is its own (1, Sb) prefill: a sequence's prefill is
        then the same computation whether it arrived alone or in a burst,
        so greedy tokens cannot depend on the scheduling mode through
        batch-shape-dependent rounding on the card."""
        firsts = []
        for slot, req in admits:
            sb = self._bucket_len(len(req.prompt))
            if max(sb, len(req.prompt) + req.max_new) > self.max_seq:
                raise ValueError(
                    f"request {req.rid} needs more cache than max_seq="
                    f"{self.max_seq} (bucketed prompt + max_new)")
            bt[slot, :] = -1
            for j in range(kvc.blocks_for(sb, self.block_size)):
                bt[slot, j] = sched.blocks.alloc(req.rid)
            req.prefilled_tokens += len(req.prompt)
            toks = np.zeros((1, sb), np.int32)
            toks[0, :len(req.prompt)] = req.prompt
            first, cache = self.executor.prefill_insert(
                toks, np.asarray([len(req.prompt)], np.int32), cache, slot,
                bt[slot])
            firsts.append(int(first[0]))
        return firsts, cache

    def warmup(self, requests: Sequence[Request]) -> int:
        """Run every shape the trace can reach once against the pool
        (building the kernels on first use and, on a card, capturing the
        decode graph), so serving measures the steady state.  At horizon
        M > 1 the decode shape is the M-step round: exactly one round graph
        and no single-step graph.  Returns the number of shapes run."""
        ex = self.executor
        cache = ex.init_cache()
        brow = np.full((ex.n_bt,), -1, np.int32)
        buckets = sorted({self._bucket_len(len(r.prompt)) for r in requests})
        for sb in buckets:
            ex.prefill_insert(np.zeros((1, sb), np.int32),
                              np.ones((1,), np.int32), cache, 0, brow)
        B = self.max_batch
        zeros = np.zeros((B, 1), np.int32)
        idle = np.zeros((B,), bool)
        table = np.full((B, ex.n_bt), -1, np.int32)
        if self.decode_horizon > 1:
            ex.decode_multi(zeros, zeros, idle, np.zeros((B,), np.int32),
                            cache, table, eos_id=self.eos_id)
        else:
            ex.decode(zeros, zeros, idle, cache, table)
        if ex.device.type == "cuda":
            want = {"decode": int(self.decode_horizon == 1),
                    "decode_multi": int(self.decode_horizon > 1)}
            if ex.graph_counts() != want:
                raise RuntimeError(
                    f"decode graph contract violated at warmup: want "
                    f"{want} at horizon {self.decode_horizon}, got "
                    f"{ex.graph_counts()}")
            torch.cuda.synchronize(ex.device)
        return len(buckets) + 1

    # ------------------------------------------------------------- the loop
    def serve(self, requests: Sequence[Request], continuous: bool = True,
              warmup: bool = True):
        """Serve an arrival trace (arrival times on the wall clock from the
        start of this call); returns (finished requests, stats)."""
        clock = time.perf_counter
        ex = self.executor
        bad = [r.rid for r in requests
               if max(self._bucket_len(len(r.prompt)),
                      len(r.prompt) + r.max_new) > self.max_seq]
        if bad:
            raise ValueError(f"requests {bad} need more cache than max_seq="
                             f"{self.max_seq}; size the Server for the "
                             f"longest request")
        bad = [r.rid for r in requests
               if self._blocks_needed(r) > ex.n_blocks]
        if bad:
            raise ValueError(f"requests {bad} need more blocks than the pool "
                             f"holds (n_blocks={ex.n_blocks})")
        if warmup:
            self.warmup(requests)
        blocks = BlockAllocator(ex.n_blocks)
        sched = Scheduler(requests, self.max_batch, blocks=blocks,
                          blocks_needed=self._blocks_needed)
        cache = ex.init_cache()
        B = self.max_batch
        tok = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        act = np.zeros((B,), bool)
        # remaining emission budget per slot: the round's on-device
        # retirement counter (unused at horizon 1)
        rem = np.zeros((B,), np.int32)
        bt = ex.make_block_table()
        steps = rounds = host_syncs = loop_iters = peak_running = 0
        M = self.decode_horizon
        multi = M > 1
        # rounds are pipelined: round N+1 is dispatched from the device
        # carry before the host replays round N's tokens, so host work
        # overlaps device work (the port has no SLO preemption or chunked
        # prefill, which would need each round drained at once)
        pending = None        # the in-flight round's RoundTokens
        carry = None          # device carry chained round to round
        prefills0 = ex.prefill_calls
        launches0 = ops.launch_counts()
        t0 = clock()

        def retire(slot, now):
            act[slot] = False
            sched.retire(slot, now)
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
            """Book a prefill's token and arm the slot for decode."""
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

        while not sched.done:
            loop_iters += 1
            now = clock() - t0
            sched.poll(now)
            if continuous or not sched.running:
                admits = sched.admit(now)
                if admits:
                    drain()    # mirrors must be current before emit_first
                    firsts, cache = self._prefill_admits(cache, admits,
                                                         sched, bt)
                    host_syncs += 1
                    now = clock() - t0
                    peak_running = max(peak_running, len(sched.running))
                    for (slot, req), first in zip(admits, firsts):
                        emit_first(slot, req, first, now)
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
            # alloc-on-demand: every block this step's or round's writes can
            # touch must exist before it runs (reserved at admission).  A
            # round writes up to M positions, and with a round in flight the
            # device carry may already be M ahead of the host mirror, so the
            # span doubles.  Positions past a request's last feed (prompt +
            # max_new - 2) are never written, so the span stops there.
            span = M if pending is None else 2 * M
            for slot, req in sched.running.items():
                p0 = int(pos[slot, 0])
                hi = min(p0 + span - 1, len(req.prompt) + req.max_new - 2)
                for li in range(p0 // self.block_size,
                                hi // self.block_size + 1):
                    if bt[slot, li] < 0:
                        bt[slot, li] = sched.blocks.alloc(req.rid)
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
                continue
            new_tok, cache = ex.decode(tok, pos, act, cache, bt)
            new_tok = new_tok.cpu().numpy()
            host_syncs += 1
            steps += 1
            now = clock() - t0
            for slot in list(sched.running):
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
        stats.update({
            "device": str(ex.device),
            "decode_steps": steps,
            "decode_horizon": M,
            "decode_rounds": rounds,
            # captured graphs of the decode path (0 on the CPU: eager)
            "decode_compiles": ex.graph_counts()[
                "decode_multi" if multi else "decode"],
            "prefill_forwards": ex.prefill_calls - prefills0,
            "kernel_launches": {k: launches[k] - launches0[k]
                                for k in launches},
            "cache_layout": "paged",
            "cache_bytes": kvc.cache_nbytes(cache),
            "peak_concurrency": peak_running,
            # every host-blocking device-to-host read the loop paid: decode
            # steps or rounds, and prefill first tokens
            "host_syncs": host_syncs,
            "host_syncs_per_token": round(
                host_syncs / max(stats["tokens"], 1), 4),
            "loop_iters": loop_iters,
            "block_size": self.block_size,
            "n_blocks": ex.n_blocks,
            "block_table_transfers": dict(bt.stats),
            "peak_blocks_in_use": blocks.high_watermark,
            "block_util_pct": round(
                100.0 * blocks.high_watermark / max(ex.n_blocks, 1), 1),
            "blocks_free_end": blocks.free_count,
            "prefilled_tokens": int(sum(r.prefilled_tokens
                                        for r in sched.finished)),
        })
        return sched.finished, stats


def build_server(args) -> Tuple[Server, object]:
    """Config, random PSI-quantized params (seeded, quantized leaf by leaf
    on the device) and the Server, from the CLI flags."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    over = {"cache_block_size": int(getattr(args, "block_size", 0)
                                    or cfg.cache_block_size)}
    if getattr(args, "n_layers", 0):
        over["n_layers"] = int(args.n_layers)
    cfg = dataclasses.replace(cfg, **over)
    cfg.resolved_cache_layout
    device = resolve_device(getattr(args, "device", None))
    policy = parse_policy(getattr(args, "quant_policy", None))
    model = build_model(cfg)
    if args.quant != "none" or policy:
        _, bits = parse_quant_mode(args.quant)
        params = model.init(seed=args.seed, device=device, bits=bits,
                            pack=True, policy=policy)
        mode = args.quant
        if mode == "none" and policy and policy.get("default"):
            mode = f"psi{policy['default']}"
        cfg = dataclasses.replace(cfg, quant_mode=mode)
    else:
        params = model.init(seed=args.seed, device=device)
    longest = args.prompt_len + args.prompt_jitter
    prompt_pad = -(-longest // PREFILL_BUCKET) * PREFILL_BUCKET
    bsz = cfg.cache_block_size
    max_seq = -(-(prompt_pad + args.max_new + 8) // bsz) * bsz
    server = Server(cfg, params, max_batch=args.max_batch, max_seq=max_seq,
                    eos_id=args.eos_id, device=device,
                    n_blocks=getattr(args, "cache_blocks", None),
                    decode_horizon=int(getattr(args, "decode_horizon", 1)))
    return server, cfg


def trace_from_args(args, cfg):
    return poisson_trace(args.requests, rate_rps=args.arrival_rate,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         min_new=args.min_new,
                         prompt_jitter=args.prompt_jitter,
                         vocab_size=cfg.vocab_size, seed=int(args.seed))


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
    ap.add_argument("--block-size", type=int, default=0,
                    help="positions per paged block (0 = config default)")
    ap.add_argument("--cache-blocks", type=int, default=None,
                    help="usable pool blocks (default max_batch * "
                         "ceil(max_seq / block_size))")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="-1 disables EOS retirement")
    ap.add_argument("--decode-horizon", type=int, default=1,
                    help="decode steps per round, with retirement on the "
                         "device and one host sync per round (1 = one "
                         "step at a time)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the arrival trace")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch kernels)")


def main():
    ap = argparse.ArgumentParser()
    add_serve_args(ap)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "static", "both"])
    args = ap.parse_args()
    server, cfg = build_server(args)
    modes = (["continuous", "static"] if args.mode == "both"
             else [args.mode])
    for mode in modes:
        done, stats = server.serve(trace_from_args(args, cfg),
                                   continuous=(mode == "continuous"))
        horizon = ""
        if stats["decode_horizon"] > 1:
            horizon = (f" | horizon {stats['decode_horizon']}: "
                       f"{stats['decode_rounds']} rounds, "
                       f"{stats['host_syncs_per_token']:.3f} syncs/tok")
        print(f"[{mode}] served {stats['n_requests']} requests on "
              f"{stats['device']}: {stats['tokens']} tokens in "
              f"{stats['wall_s']:.3f}s = {stats['tok_per_s']:.1f} tok/s | "
              f"latency p50 {stats['p50_latency_s'] * 1e3:.0f}ms "
              f"p99 {stats['p99_latency_s'] * 1e3:.0f}ms | "
              f"ttft p50 {stats['p50_ttft_s'] * 1e3:.0f}ms | "
              f"itl p50 {stats['p50_itl_s'] * 1e3:.1f}ms | "
              f"peak concurrency {stats['peak_concurrency']} | cache paged "
              f"({stats['n_blocks']}x{stats['block_size']} blocks, peak "
              f"util {stats['block_util_pct']}%) | decode compiles "
              f"{stats['decode_compiles']} | kernel launches "
              f"{stats['kernel_launches']}{horizon}")
        for r in sorted(done, key=lambda r: r.rid)[:2]:
            print(f"  req {r.rid}: slot {r.slot}, {len(r.tokens)} tokens, "
                  f"{r.out[:10].tolist()}...")


if __name__ == "__main__":
    main()
