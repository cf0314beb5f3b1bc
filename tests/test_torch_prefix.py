"""The port's prefix cache against the JAX package's.

Units on one seeded sequence of operations each: the ref-counted
``BlockAllocator`` (share, pin, fork, release churn; the cases of
``tests/test_prefix.py::TestRefcounts``) and ``PrefixCache`` (chain
lookup, publish, LRU eviction, drain; ``TestPrefixCache``) give the same
return values, exceptions and state after every operation.  The model
side on reduced qwen3-8b psi8 f32 (JAX ``init`` + ``quantize``, carried
across by interop): ``gather_paged_ctx`` exactly, the suffix prefill
(``pos0`` / ``ctx_kv``) within 1e-4 on the last logits and 1e-5 on the KV
rows with the same pad mask, and ``emit_logits=False``.  Then the port's
``Server`` with ``--prefix-cache on`` against the JAX ``Server`` on a
shared-prefix trace, continuous and static: identical tokens and equal
timing-free integer stats, with measured hits.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.launch import prefix_cache as jpc
from repro.launch import scheduler as jsched
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import prefix_cache as tpc
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

LOGITS_ATOL = 1e-4     # logits tolerance of test_torch_model.py (f32)
KV_ATOL = 1e-5         # K/V rows: one projection + RoPE deep, f32


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Allocator and prefix cache: one op script, both packages, state compared
# after every op.
# ---------------------------------------------------------------------------
def _alloc_state(a):
    free = (sorted(b for pool in a._free for b in pool)
            if isinstance(a, jsched.BlockAllocator) else sorted(a._free))
    return (free, list(a.refcount), list(a.owner), dict(a._held),
            dict(a._reserved), a.high_watermark, a.capacity_version,
            a.free_count, a.in_use, a.reserved_total)


def _cache_state(pc):
    return (list(pc._entries.items()), pc.stats())


def _call(obj, name, args):
    """(result, exception type and message) of ``obj.name(*args)``."""
    try:
        return getattr(obj, name)(*args), None
    except ValueError as e:
        return None, str(e)


def _run_script(n_blocks, script, block_size=4, align=0):
    """Apply ``script`` — (target, method, args) with target "alloc" or
    "cache" — to the JAX and the port objects; every result, every error
    and the full state after each op must be equal."""
    ja, ta = jsched.BlockAllocator(n_blocks), tsched.BlockAllocator(n_blocks)
    jc = jpc.PrefixCache(block_size, align_tokens=align)
    tc = tpc.PrefixCache(block_size, align_tokens=align)
    for i, (target, name, args) in enumerate(script):
        if target == "alloc":
            jr, tr = _call(ja, name, args), _call(ta, name, args)
        elif name == "publish":                 # (prompt, held, allocator)
            jr, tr = _call(jc, name, args + (ja,)), _call(tc, name,
                                                          args + (ta,))
        elif name in ("evict_until", "drain"):  # (allocator, ...)
            jr, tr = _call(jc, name, (ja,) + args), _call(tc, name,
                                                          (ta,) + args)
        else:
            jr, tr = _call(jc, name, args), _call(tc, name, args)
        assert jr == tr, (i, target, name, args, jr, tr)
        assert _alloc_state(ja) == _alloc_state(ta), (i, name)
        assert _cache_state(jc) == _cache_state(tc), (i, name)
    return ta, tc


def _churn_script(seed, n_blocks):
    """A seeded share / pin / fork / release churn in the shape of
    TestRefcounts.test_share_churn_invariants, driven on a model of the
    allocator so every op is one a caller could make (plus a few that
    must raise)."""
    rng = random.Random(seed)
    model = tsched.BlockAllocator(n_blocks)
    script, live, pinned = [], {}, []

    def op(name, *args):
        script.append(("alloc", name, args))
        _call(model, name, args)

    for rid in range(rng.randint(4, 25)):
        if live and rng.random() < 0.35:
            op("release", rng.choice(list(live)))
            live.pop(script[-1][2][0])
        need = rng.randint(1, max(1, n_blocks // 3))
        if not model.can_reserve(need):
            op("reserve", rid, need)              # raises: no capacity
            continue
        mine = []
        sharable = [b for bs_ in live.values() for b in bs_] + pinned
        if sharable and rng.random() < 0.5:
            share = list(dict.fromkeys(
                rng.sample(sharable, rng.randint(1, len(sharable)))))
            op("attach", rid, share)
            mine += share
        op("reserve", rid, need)
        for _ in range(rng.randint(0, need)):
            op("alloc", rid)
            blk = model._held[rid][-1]
            mine.append(blk)
            if rng.random() < 0.3:
                op("ref_block", blk)
                pinned.append(blk)
        if mine and rng.random() < 0.3:
            op("fork", rid, rng.choice(mine))     # may raise: budget spent
            mine = model.owned_by(rid)
        if rng.random() < 0.2 and model.reserved_of(rid) == 0 \
                and model.can_reserve(1):
            op("grow_reserve", rid, 1)
        live[rid] = mine
    op("attach", 999, [b for b in range(n_blocks)
                       if model.refcount[b] == 0][:1])    # a free block
    for rid in list(live):
        op("release", rid)
    for b in pinned:
        op("unref_block", b)
    return script


@pytest.mark.parametrize("seed", range(6))
def test_allocator_refcount_churn_matches_jax(seed):
    n_blocks = 6 + 5 * seed
    ta, _ = _run_script(n_blocks, _churn_script(seed, n_blocks))
    assert ta.free_count == n_blocks and all(r == 0 for r in ta.refcount)


REFCOUNT_CASES = {
    # TestRefcounts.test_release_never_frees_shared_block
    "release_never_frees_shared": (4, [
        ("alloc", "reserve", (1, 2)), ("alloc", "alloc", (1,)),
        ("alloc", "alloc", (1,)), ("alloc", "ref_block", (0,)),
        ("alloc", "release", (1,)), ("alloc", "unref_block", (0,))]),
    # TestRefcounts.test_attach_requires_populated_block
    "attach_requires_populated": (4, [
        ("alloc", "attach", (1, [0])), ("alloc", "ref_block", (0,))]),
    # TestRefcounts.test_fork_cow_semantics
    "fork_cow": (6, [
        ("alloc", "reserve", (1, 2)), ("alloc", "alloc", (1,)),
        ("alloc", "alloc", (1,)), ("alloc", "reserve", (2, 1)),
        ("alloc", "attach", (2, [0, 1])), ("alloc", "fork", (2, 1)),
        ("alloc", "fork", (2, 0)), ("alloc", "release", (1,)),
        ("alloc", "release", (2,))]),
    # TestRefcounts.test_fork_exclusive_is_identity
    "fork_exclusive": (4, [
        ("alloc", "reserve", (1, 2)), ("alloc", "alloc", (1,)),
        ("alloc", "fork", (1, 0))]),
}


@pytest.mark.parametrize("case", list(REFCOUNT_CASES))
def test_allocator_cases_match_jax(case):
    n_blocks, script = REFCOUNT_CASES[case]
    _run_script(n_blocks, script)


def _tok(*vals):
    return np.asarray(vals, np.int32)


def _publish_ops(rid, prompt, n_held, first_block):
    """Ops of a retiring request whose ``n_held`` blocks are the next
    ``n_held`` free ids from ``first_block`` (lowest-first allocation)."""
    held = list(range(first_block, first_block + n_held))
    return ([("alloc", "reserve", (rid, n_held))]
            + [("alloc", "alloc", (rid,))] * n_held
            + [("cache", "publish", (prompt, held)),
               ("alloc", "release", (rid,))])


PREFIX_CASES = {
    # TestPrefixCache.test_block_aligned_chain_lookup
    "chain_lookup": (16, 4, 0, _publish_ops(1, np.arange(10, dtype=np.int32),
                                            3, 0) + [
        ("cache", "lookup", (np.arange(10, dtype=np.int32),)),
        ("cache", "lookup", (_tok(0, 1, 2, 3, 4, 99, 6, 7, 8, 9),)),
        ("cache", "lookup", (np.arange(8, dtype=np.int32),)),
        ("cache", "lookup", (np.arange(4, dtype=np.int32),))]),
    # TestPrefixCache.test_publish_dedups_first_wins
    "dedup_first_wins": (16, 4, 0,
                         _publish_ops(1, np.arange(8, dtype=np.int32), 3, 0)
                         + _publish_ops(2, np.arange(8, dtype=np.int32), 3,
                                        2) + [
        ("cache", "lookup", (np.arange(9, dtype=np.int32),))]),
    # TestPrefixCache.test_lru_eviction_restores_initial_free_set
    "lru_eviction_drain": (8, 2, 0, sum(
        (_publish_ops(r, _tok(r * 10, r * 10 + 1, r * 10 + 2, r * 10 + 3), 2,
                      2 * r) for r in range(4)), []) + [
        ("cache", "lookup", (_tok(0, 1, 2, 3, 4),)),
        ("cache", "evict_until", (2,)),
        ("cache", "lookup", (_tok(10, 11, 12, 13, 14),)),
        ("cache", "lookup", (_tok(0, 1, 2, 3, 4),)),
        ("cache", "drain", ())]),
    # TestPrefixCache.test_eviction_takes_leaves_before_roots
    "leaves_before_roots": (8, 2, 0,
                            _publish_ops(1, np.arange(8, dtype=np.int32), 4,
                                         0) + [
        ("cache", "evict_until", (5,)),
        ("cache", "lookup", (np.arange(9, dtype=np.int32),)),
        ("cache", "evict_until", (6,)),
        ("cache", "lookup", (np.arange(9, dtype=np.int32),))]),
    # TestPrefixCache.test_eviction_skips_referenced_entries
    "skips_referenced": (4, 2, 0, _publish_ops(1, _tok(1, 2, 3, 4), 3, 0) + [
        ("alloc", "reserve", (2, 1)), ("alloc", "attach", (2, [0, 1])),
        ("cache", "evict_until", (4,)), ("alloc", "release", (2,)),
        ("cache", "evict_until", (4,))]),
    # hits trimmed to the bucket grid (align_tokens), and note_lookup's
    # hit / restore counters
    "aligned_hits_and_counters": (16, 4, 8,
                                  _publish_ops(1, np.arange(14,
                                                            dtype=np.int32),
                                               4, 0) + [
        ("cache", "lookup", (np.arange(14, dtype=np.int32),)),
        ("cache", "note_lookup", ([0, 1],)),
        ("cache", "note_lookup", ([0, 1], True)),
        ("cache", "note_lookup", ([],))]),
}


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_prefix_cache_matches_jax(case):
    n_blocks, bs, align, script = PREFIX_CASES[case]
    _run_script(n_blocks, script, block_size=bs, align=align)


def test_prefix_cache_lookup_keeps_one_suffix_token():
    pc = tpc.PrefixCache(4)
    alloc = tsched.BlockAllocator(8)
    alloc.reserve(0, 2)
    held = [alloc.alloc(0), alloc.alloc(0)]
    pc.publish(np.arange(8, dtype=np.int32), held, alloc)
    assert pc.lookup(np.arange(8, dtype=np.int32)) == held[:1]
    assert pc.lookup(np.arange(9, dtype=np.int32)) == held
    assert tpc.PrefixCache.hit_alignment_step(16, 16) == 1
    assert tpc.PrefixCache.hit_alignment_step(8, 16) == 2


# ---------------------------------------------------------------------------
# The model: the context gather and the suffix prefill.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen3-8b"))
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="psi8")
    tparams = params_from_numpy(np_tree(params), device="cpu")
    return cfg, params, tcfg, tparams


def _pools(cfg, tcfg, kv_quant, n_total=6, bs=16, seed=0):
    """The same random pool contents in both packages' layouts."""
    rng = np.random.default_rng(seed)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (L, n_total, bs, hkv, hd)
    if kv_quant == "int8":
        vals = {"k": rng.integers(-127, 128, size=shape).astype(np.int8),
                "v": rng.integers(-127, 128, size=shape).astype(np.int8),
                "k_scale": rng.uniform(1e-3, 0.05, size=shape[:4] + (1,))
                .astype(np.float32),
                "v_scale": rng.uniform(1e-3, 0.05, size=shape[:4] + (1,))
                .astype(np.float32)}
    else:
        vals = {k: rng.normal(size=shape).astype(np.float32)
                for k in ("k", "v")}
    jcache = ({"b0": {k: jnp.asarray(v) for k, v in vals.items()}}, [])
    tpools = [{k: torch.from_numpy(v[i].copy()) for k, v in vals.items()}
              for i in range(L)]
    return jcache, tpools


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_gather_paged_ctx_matches_jax(setup, kv_quant):
    from repro.models import transformer as jtransformer
    cfg, _, tcfg, _ = setup
    jcache, tpools = _pools(cfg, tcfg, kv_quant)
    ids = np.array([4, 1, 3], np.int32)
    want = jtransformer.gather_paged_ctx(jcache, jnp.asarray(ids),
                                         jnp.float32)["b0"]
    got = ttransformer.gather_paged_ctx(tpools, torch.from_numpy(ids),
                                        torch.float32)
    assert len(got) == cfg.n_layers
    for i, layer in enumerate(got):
        for k in ("k", "v"):
            assert layer[k].shape == (1, 3 * 16, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
            np.testing.assert_array_equal(layer[k].numpy(),
                                          np.asarray(want[k][i]))


def _jax_suffix(cfg, params, full, split, tl_suffix, emit=True):
    """JAX: full prefill of ``full[:split]`` scattered into blocks
    0..split/16-1, the context gathered back, then the suffix prefill."""
    jm = build_model(cfg)
    n = split // 16
    jcache = jm.init_cache(1, 64, dtype=jnp.float32, layout="paged",
                           block_size=16, n_blocks=4)
    _, seq = jm.prefill(params, {"tokens": jnp.asarray(full[None, :split])})
    row = jnp.asarray(np.array([2, 0, 3, 1], np.int32))
    jcache = jm.insert_cache(jcache, seq, 0, block_row=row)
    ctx = jm.gather_prefix_ctx(jcache, row[:n], jnp.float32)
    suffix = full[None, split:]
    return jm.prefill(params, {"tokens": jnp.asarray(suffix)},
                      true_lens=jnp.asarray([tl_suffix], jnp.int32),
                      pos0=split, ctx_kv=ctx, emit_logits=emit)


def _torch_suffix(tcfg, tparams, full, split, tl_suffix, emit=True):
    tm = tbuild_model(tcfg)
    n = split // 16
    tcache = tm.init_cache(1, 64, device="cpu", block_size=16, n_blocks=4)
    _, seq = tm.prefill(tparams, torch.from_numpy(full[None, :split]))
    row = torch.tensor([2, 0, 3, 1])
    tm.insert_cache(tcache, seq, 0, row)
    ctx = tm.gather_prefix_ctx(tcache, row[:n])
    with torch.inference_mode():
        return tm.prefill(tparams, torch.from_numpy(full[None, split:]),
                          true_lens=torch.tensor([tl_suffix]), pos0=split,
                          ctx_kv=ctx, emit_logits=emit)


@pytest.mark.parametrize("split,S,tl", [(16, 16, 11), (32, 16, 16),
                                        (16, 32, 20)])
def test_suffix_prefill_matches_jax(setup, split, S, tl):
    """Last logits within 1e-4, K/V rows within 1e-5, the same pad mask
    (absolute positions: k_pos >= split + tl read as empty)."""
    cfg, params, tcfg, tparams = setup
    rng = np.random.default_rng(split + S + tl)
    full = rng.integers(0, 256, size=(split + S,)).astype(np.int32)
    jl, jseq = _jax_suffix(cfg, params, full, split, tl)
    tl_, tseq = _torch_suffix(tcfg, tparams, full, split, tl)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=0)
    jkv = jseq.kv[0]["b0"]
    for i, layer in enumerate(tseq.kv):
        want_pos = np.asarray(jkv["k_pos"][i])
        np.testing.assert_array_equal(layer["k_pos"].numpy(), want_pos)
        assert (want_pos[0] == np.where(np.arange(S) < tl,
                                        split + np.arange(S), -1)).all()
        for k in ("k", "v"):
            np.testing.assert_allclose(layer[k].numpy(),
                                       np.asarray(jkv[k][i]), atol=KV_ATOL,
                                       rtol=0)


def test_emit_false_returns_no_logits_and_the_same_kv(setup):
    cfg, params, tcfg, tparams = setup
    rng = np.random.default_rng(5)
    full = rng.integers(0, 256, size=(48,)).astype(np.int32)
    jl, jseq = _jax_suffix(cfg, params, full, 16, 32, emit=False)
    tl_, tseq = _torch_suffix(tcfg, tparams, full, 16, 32, emit=False)
    _, tseq_emit = _torch_suffix(tcfg, tparams, full, 16, 32)
    assert jl is None and tl_ is None
    jkv = jseq.kv[0]["b0"]
    for i, (layer, ref) in enumerate(zip(tseq.kv, tseq_emit.kv)):
        for k in layer:
            assert torch.equal(layer[k], ref[k]), k
        for k in ("k", "v"):
            np.testing.assert_allclose(layer[k].numpy(),
                                       np.asarray(jkv[k][i]), atol=KV_ATOL,
                                       rtol=0)


def test_insert_writes_only_the_suffix_blocks(setup):
    """prefill_insert with ctx_ids scatters into block_row[nctx:] and
    leaves the context blocks (possibly another request's) untouched."""
    _, _, tcfg, tparams = setup
    srv = tserve.Server(tcfg, tparams, max_batch=2, max_seq=64,
                        device="cpu")
    ex = srv.executor
    cache = ex.init_cache()
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 256, size=(1, 32)).astype(np.int32)
    row = np.array([5, 2, -1, -1], np.int32)
    ex.prefill_insert(prompt[:, :16], np.array([16], np.int32), cache, 0,
                      row)
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache.kv]
    first, _ = ex.prefill_insert(prompt[:, 16:], np.array([16], np.int32),
                                 cache, 0, row, ctx_ids=row[:1])
    for layer, old in zip(cache.kv, before):
        for k in layer:
            assert torch.equal(layer[k][5], old[k][5]), k
            assert not torch.equal(layer[k][2], old[k][2]), k
    full_first, _ = ex.prefill(prompt, np.array([32], np.int32))
    assert int(first[0]) == int(full_first[0])
    with pytest.raises(ValueError, match="ctx_ids"):
        ex.prefill_insert(prompt, np.array([32], np.int32), cache, 0, row,
                          emit=False)


# ---------------------------------------------------------------------------
# The Server with the prefix cache, against the JAX Server.
# ---------------------------------------------------------------------------
TRACE = dict(rate_rps=1e9, prompt_len=8, max_new=6, min_new=2,
             vocab_size=256, seed=3, prompt_jitter=3, shared_prefix_len=40)
# the stats that do not depend on the clock
INT_STATS = ("n_requests", "tokens", "prefilled_tokens",
             "prefix_tokens_reused", "blocks_free_end", "peak_blocks_in_use")


def _toks(done):
    return {r.rid: list(r.tokens) for r in done}


def test_shared_prefix_trace_is_the_same_draw():
    for a, b in zip(jsched.poisson_trace(6, **TRACE),
                    tsched.poisson_trace(6, **TRACE)):
        assert (a.rid, a.max_new, a.arrival_s) == (b.rid, b.max_new,
                                                   b.arrival_s)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    heads = {tuple(r.prompt[:40]) for r in tsched.poisson_trace(6, **TRACE)}
    assert len(heads) == 1


@pytest.fixture(scope="module")
def prefix_servers(setup):
    cfg, params, tcfg, tparams = setup
    jsrv = JServer(dataclasses.replace(cfg, prefix_cache=True), params,
                   max_batch=2, max_seq=80)
    tsrv = tserve.Server(dataclasses.replace(tcfg, prefix_cache=True),
                         tparams, max_batch=2, max_seq=80, device="cpu")
    off = tserve.Server(tcfg, tparams, max_batch=2, max_seq=80,
                        device="cpu")
    return jsrv, tsrv, off


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_prefix_serving_matches_jax(prefix_servers, mode):
    """Tokens identical to the JAX Server's (and to the port with the
    cache off), hits measured, and every timing-free integer stat and
    prefix-cache counter equal; no block leaks."""
    jsrv, tsrv, off = prefix_servers
    cont = mode == "continuous"
    jdone, js = jsrv.serve(jsched.poisson_trace(8, **TRACE), continuous=cont)
    tdone, ts = tsrv.serve(tsched.poisson_trace(8, **TRACE), continuous=cont)
    odone, os_ = off.serve(tsched.poisson_trace(8, **TRACE), continuous=cont)
    assert _toks(tdone) == _toks(jdone) == _toks(odone)
    assert ts["prefix_cache"]["hits"] > 0 and ts["prefix_tokens_reused"] > 0
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert ts["prefix_cache"] == js["prefix_cache"]
    assert ts["blocks_free_end"] == ts["n_blocks"]
    assert os_["prefilled_tokens"] - ts["prefilled_tokens"] == \
        ts["prefix_tokens_reused"]
    # one prefill forward per admission, none more
    assert ts["prefill_forwards"] == 8
    assert ts["prefill_forwards_headless"] == 0


def test_prefix_cache_config_is_validated(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="RoPE"):
        dataclasses.replace(tcfg, rope="sinusoidal",
                            prefix_cache=True).prefix_cache_enabled
    assert not tcfg.prefix_cache_enabled
    assert dataclasses.replace(tcfg, prefix_cache=True).prefix_cache_enabled
