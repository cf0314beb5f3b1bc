"""One serve on a mesh of cards, measured: a process a card under torchrun
(NCCL; gloo with ``--device cpu``), every rank drawing its share of the
params through the rank-local init (``serve.build_server`` with
``--mesh``), so no rank holds the whole model.

    torchrun --nproc-per-node 4 -m repro_torch.launch.mesh_check \\
        --arch mixtral-8x22b --quant psi8 --mesh 1x4 --requests 8 \\
        --prompt-len 64 --prompt-jitter 8 --max-new 16 --min-new 8

The serve flags are the serve CLI's (continuous mode).  The mesh's first
rank prints one JSON line: the serve's stats (tokens/s, latency, MFU,
collectives, slot shards), the decode step's time (CUDA events around
``WINDOW`` calls of ``Executor.decode`` at 72 positions: the graph
replay and the token all-gather), every rank's peak memory and init
time, and a digest of the tokens.  With ``--against-one-card`` the first
rank then serves the same trace alone on its own card from the whole
params (``Model.init`` of the same seed) while the others wait, and the
line says whether the tokens are identical (else where each request's
part) and holds the logits of one forward of a fixed (4, 64) batch
against the one card's (``probe``): the largest difference and, where
the argmax differs, the one card's top-2 margin there; for an MoE each
layer's share of slots routed to another expert.  Where the slots do not
split (a mesh of "model" only), ``decode_probe`` does the same for
``DECODE_STEPS`` decode steps of slot 0 after a 64-token prefill, fed the
same fixed tokens on both sides (the KV cache, a dense ring split over
"model" included, and the decode read).  Beside them, ``replan_probe`` and
``replan_decode_probe`` hold the one card against itself with the
kernels planned for a card of half its SMs (``_replanned``): the same
products, their f32 sums split and added in another order, as a rank's
narrower weights are planned: the size of a difference that order alone
makes in bf16 through the whole depth.

On four cards, the runs of PERF.md (each with ``--against-one-card``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.mesh_check \
        --arch qwen3-8b --quant psi8 --mesh 1x4 --requests 8 \
        --prompt-len 64 --prompt-jitter 8 --max-new 16 --min-new 8 \
        --against-one-card
    # ... --arch qwen3-moe-30b-a3b; --arch recurrentgemma-9b; --arch
    # granite-34b --quant psi5 --cache-layout dense; and --arch qwen3-8b
    # --mesh 4x1 with --prefix-cache on --shared-prefix-len 32, or with
    # --speculative 3:4
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.core.psi import QuantizedTensor
from repro_torch.launch import serve
from repro_torch.runtime import parallel

WINDOW = 10                     # decode steps timed after the serve
DECODE_STEPS = 8                # the decode probe's steps
KEEP = ("n_requests", "tokens", "wall_s", "tok_per_s", "p50_latency_s",
        "p99_latency_s", "p50_ttft_s", "p50_itl_s", "decode_steps",
        "prefill_forwards", "decode_compiles", "slot_shards", "collectives",
        "macs_per_token", "mfu", "watts", "tokens_per_joule",
        "prefilled_tokens", "prefix_tokens_reused", "prefix_cache",
        "blocks_copied", "blocks_free_end", "n_blocks", "speculative",
        "cache_layout")


def _tokens(done) -> dict:
    return {r.rid: [int(t) for t in r.tokens] for r in done}


def _digest(toks: dict) -> str:
    return hashlib.sha1(json.dumps(sorted(toks.items())).encode()
                        ).hexdigest()[:16]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_ms(ex, n: int) -> float:
    """Mean ms of ``n`` decode steps (all slots active at 72 positions,
    or the last the cache holds; a paged table of blocks on each slot's
    shard), CUDA events on a card, the host's clock on the CPU."""
    B = ex.max_batch
    tok = np.arange(B, dtype=np.int32)[:, None]
    pos = np.full((B, 1), min(72, ex.max_seq - 1), np.int32)
    act = np.ones((B,), bool)
    cache = ex.init_cache()
    table = None
    if ex.paged:
        # each slot's blocks from its own shard's pool (cycled where the
        # shard holds fewer: the window times reads, not contents)
        table = np.empty((B, ex.n_bt), np.int32)
        for slot in range(B):
            mine = np.flatnonzero(ex.block_shards == ex.slot_shards[slot])
            table[slot] = mine[np.arange(ex.n_bt) % len(mine)]
    ex.decode(tok, pos, act, cache, table)
    _sync(ex.device)
    if ex.device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(n):
            ex.decode(tok, pos, act, cache, table)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / n
    t0 = time.perf_counter()
    for _ in range(n):
        ex.decode(tok, pos, act, cache, table)
    return (time.perf_counter() - t0) * 1e3 / n


def main():
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    serve.add_serve_args(ap)
    ap.add_argument("--against-one-card", action="store_true",
                    help="the first rank also serves the trace alone from "
                         "the whole params; the line says whether the "
                         "tokens are identical")
    args = ap.parse_args()
    if not args.mesh:
        raise SystemExit("mesh_check needs --mesh")
    t0 = time.perf_counter()
    server, cfg = serve.build_server(args)
    ex = server.executor
    dev = ex.device
    _sync(dev)
    init_s = time.perf_counter() - t0
    first = dist.get_rank() == ex.mesh_ranks()[0]
    trace = serve.trace_from_args(args, cfg)
    server.warmup(trace)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    done, stats = server.serve(serve.trace_from_args(args, cfg),
                               continuous=True, warmup=False)
    step_ms = _step_ms(ex, WINDOW)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    local_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(ex.params))
    # the ranks' figures travel on the host (gloo): the mesh's host group
    host = ex.mesh.host_group
    mine = torch.tensor([init_s, peak or 0.0, local_bytes / 1e9],
                        dtype=torch.float64)
    parts = [mine]
    if host is not None:
        parts = [torch.zeros_like(mine)
                 for _ in range(dist.get_world_size(host))]
        dist.all_gather(parts, mine, group=host)
    toks = _tokens(done)
    probe = None
    if args.against_one_card:
        # one forward of a fixed (4, 64) batch on the mesh: its logits are
        # held against the one card's below
        rng = np.random.default_rng(args.seed)
        probe = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(4, 64)).astype(np.int32)).to(dev)
        feed = rng.integers(0, cfg.vocab_size, size=(DECODE_STEPS,))
        mesh_probe = _probe(ex, probe)
        mesh_decode = (_decode_probe(ex, probe[0].cpu().numpy(), feed)
                       if ex.n_slot_shards == 1 else None)
    out = {"arch": args.arch, "quant": args.quant, "mesh": args.mesh,
           "layers": cfg.n_layers, "device": str(dev),
           "local_cfg": {"n_heads": ex.local_cfg.n_heads,
                         "n_kv_heads": ex.local_cfg.n_kv_heads,
                         "d_inner": (ex.local_cfg.d_inner
                                     if cfg.family == "ssm" else None),
                         "d_rnn": (ex.local_cfg.resolved_d_rnn
                                   if cfg.family == "hybrid" else None),
                         "kv_ring_split": ex._ring_split},
           **{k: stats.get(k) for k in KEEP},
           "decode_step_ms": step_ms, "window": WINDOW,
           "rank_init_s": [float(p[0]) for p in parts],
           "rank_peak_gb": [float(p[1]) for p in parts],
           "rank_param_gb": [float(p[2]) for p in parts],
           "tokens_digest": _digest(toks)}
    del server, ex
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if args.against_one_card:
        if first:
            one = argparse.Namespace(**dict(vars(args), mesh=None))
            alone, _ = serve.build_server(one)
            done1, st1 = alone.serve(serve.trace_from_args(args, cfg),
                                     continuous=True)
            out["one_card"] = {k: st1.get(k) for k in (
                "tok_per_s", "decode_steps", "prefilled_tokens",
                "prefix_tokens_reused", "prefix_cache", "speculative")}
            alone_toks = _tokens(done1)
            out["one_card_tokens_digest"] = _digest(alone_toks)
            out["tokens_identical"] = alone_toks == toks
            # where a request's tokens part, the first index that differs
            out["first_divergence"] = {
                rid: next((i for i, (a, b) in enumerate(zip(t, toks[rid]))
                           if a != b), min(len(t), len(toks[rid])))
                for rid, t in alone_toks.items() if t != toks.get(rid)}
            one_probe = _probe(alone.executor, probe)
            out["probe"] = _compare(mesh_probe, one_probe)
            with _replanned():
                out["replan_probe"] = _compare(
                    _probe(alone.executor, probe), one_probe)
            if mesh_decode is not None:
                args1 = (alone.executor, probe[0].cpu().numpy(), feed)
                one_decode = _decode_probe(*args1)
                out["decode_probe"] = _compare(mesh_decode, one_decode)
                with _replanned():
                    out["replan_decode_probe"] = _compare(
                        _decode_probe(*args1), one_decode)
        if host is not None:
            dist.barrier(group=host)
    if first:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _probe(ex, tokens) -> dict:
    """One forward of ``tokens`` through ``ex``'s model: the logits, and
    per MoE layer the router's input and each slot's expert (``moe.route``
    wrapped for the call; the transformer looks it up through the
    module), all on the host."""
    from repro_torch.models import moe
    route, seen = moe.route, []

    def logged(p, x, cfg, *a, **kw):
        out = route(p, x, cfg, *a, **kw)
        seen.append((x.float().cpu(), (out[1] // out[4]).cpu()))
        return out

    moe.route = logged
    try:
        with torch.inference_mode():
            logits = ex.model.forward(ex.params, tokens)[0].float().cpu()
    finally:
        moe.route = route
    return {"logits": logits, "routes": seen}


@contextlib.contextmanager
def _replanned():
    """Kernels 1-3 planned for a card of half this one's SMs while the
    block runs (their split plans read ``_build.sm_count`` at each
    launch)."""
    from repro_torch.kernels import _build
    real = _build.sm_count
    _build.sm_count = lambda index: max(1, real(index) // 2)
    try:
        yield
    finally:
        _build.sm_count = real


def _decode_probe(ex, prompt, feed) -> dict:
    """Slot 0's logits over ``len(feed)`` eager decode steps after a
    prefill of ``prompt`` into it, fed the tokens ``feed`` (the same on
    every side, so the logits compare at the same inputs), the other slots
    idle; on a paged pool slot 0 holds blocks 0, 1, ... of the table."""
    B, dev = ex.local_batch, ex.device
    cache = ex.init_cache()
    P = len(prompt)
    brow = table = None
    if ex.paged:
        brow = np.arange(ex.n_bt, dtype=np.int32)
        table = torch.full((B, ex.n_bt), -1, dtype=torch.int32, device=dev)
        table[0] = torch.from_numpy(brow).to(dev)
    rows = []
    with torch.inference_mode():
        ex.prefill_insert(prompt[None], np.asarray([P], np.int32), cache, 0,
                          brow)
        for j, t in enumerate(feed):
            tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            pos = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            tok[0, 0], pos[0, 0] = int(t), P + j
            act = torch.zeros((B,), dtype=torch.bool, device=dev)
            act[0] = True
            batch = {"token": tok, "pos": pos, "active": act}
            if table is not None:
                batch["block_table"] = table
            lg, cache = ex.model.decode_step(ex.params, batch, cache)
            rows.append(lg[0].float().cpu())
    return {"logits": torch.stack(rows), "routes": []}


def _compare(mesh, one) -> dict:
    """The mesh's probe against the one card's: the logits' largest and
    mean difference, the largest logit, and at the positions whose argmax
    differs, the one card's top-2 margin there (a flip where the margin is
    below the difference is a near tie); for an MoE, each layer's router
    input difference (max) and the share of its slots routed to another
    expert."""
    diff = (mesh["logits"] - one["logits"]).abs()
    top2 = torch.topk(one["logits"], 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flips = mesh["logits"].argmax(-1) != one["logits"].argmax(-1)
    out = {"positions": int(flips.numel()),
           "max_abs_diff": float(diff.max()),
           "mean_abs_diff": float(diff.mean()),
           "max_abs_logit": float(one["logits"].abs().max()),
           "argmax_flips": int(flips.sum()),
           "flip_margins": [float(m) for m in margin[flips].tolist()],
           "flip_row_diffs": [float(d) for d in
                              diff.amax(-1)[flips].tolist()],
           "median_margin": float(margin.median())}
    if mesh["routes"]:
        out["router_input_max_diff"] = [
            float((a[0] - b[0]).abs().max())
            for a, b in zip(mesh["routes"], one["routes"])]
        out["rerouted_share"] = [
            float((a[1] != b[1]).float().mean())
            for a, b in zip(mesh["routes"], one["routes"])]
    return out


def _tensors(tree):
    """The tensors of a serving param tree: QuantizedTensor data and
    scales, the shards inside tensor-parallel leaves."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, QuantizedTensor):
        return [tree.data, tree.scale]
    if isinstance(tree, parallel.TPLinear):
        return _tensors(tree.w)
    if isinstance(tree, parallel.TPEmbed):
        return _tensors(tree.table)
    return []


if __name__ == "__main__":
    main()
