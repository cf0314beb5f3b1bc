"""Horizon-M decode rounds of the port against the JAX package's.

The host replay of a round (``replay_round``) against the reference's on
seeded blocks; ``Model.decode_scan`` against the JAX ``decode_scan`` on the
same params, pools and inputs (tokens and carry identical, pools within
1e-5 in float32); the port's ``Server`` at horizons 2 and 4 against the
JAX ``Server`` at the same horizon and against itself at horizon 1
(identical tokens, equal decode steps, rounds and host syncs); budgets
that are no multiple of M; the sync drop; an EOS at each of the four
in-round offsets; the executor's round carry and fixed buffers.  All on
the reduced qwen3-8b psi8 config (JAX ``init`` + ``quantize``, carried
across by interop).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.launch import scheduler as jsched
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild_model
from repro_torch.models.kvcache import KVCache

torch.set_num_threads(1)

TRACE = dict(rate_rps=1e9, prompt_len=12, max_new=9, min_new=1,
             vocab_size=256, seed=3, prompt_jitter=4)


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


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


def _tserver(setup, horizon=1, **kw):
    _, _, tcfg, tparams = setup
    kw = {"max_batch": 3, "max_seq": 64, **kw}
    return tserve.Server(tcfg, tparams, device="cpu",
                         decode_horizon=horizon, **kw)


def _requests(specs, prompt_len=8, seed=0):
    """specs: list of max_new, all arriving at 0."""
    rng = np.random.default_rng(seed)
    return [tsched.Request(rid=i, prompt=rng.integers(
        0, 256, size=(prompt_len,)).astype(np.int32), max_new=mn)
        for i, mn in enumerate(specs)]


def _toks(done):
    return {r.rid: list(r.tokens) for r in done}


# ---------------------------------------------------------------------------
# The host replay of a round.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_replay_round_matches_reference(seed):
    rng = np.random.default_rng(seed)
    M, B = 8, 6
    toks = rng.integers(0, 6, size=(M, B)).astype(np.int32)
    act = rng.random(B) < 0.7
    act[0], act[1] = True, False               # one live, one inactive row
    rem = rng.integers(1, 10, size=B).astype(np.int32)
    rem[2] = 3                                  # a budget ends mid-round
    act[2] = True
    eos = int(toks[2, 0])                       # an EOS mid-round somewhere
    want = jsched.replay_round(toks, act.copy(), rem.copy(), eos)
    got = tsched.replay_round(toks, act.copy(), rem.copy(), eos)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0][1] == [] and got[2][1] == rem[1]


# ---------------------------------------------------------------------------
# Model.decode_scan against the JAX decode_scan.
# ---------------------------------------------------------------------------
def test_decode_scan_matches_jax(setup):
    cfg, params, tcfg, tparams = setup
    jm, tm = build_model(cfg), tbuild_model(tcfg)
    rng = np.random.default_rng(2)
    B, S, n_bt, bs, M = 3, 16, 4, 16, 4
    tl = np.array([13, 9, 11], np.int32)
    prompts = np.zeros((B, S), np.int32)
    for b in range(B):
        prompts[b, :tl[b]] = rng.integers(0, 256, size=tl[b])
    bt = np.array([[3, 0, -1, -1], [1, 5, -1, -1], [2, 4, -1, -1]],
                  np.int32)
    jl, jseq = jax.jit(lambda p, t, n: jm.prefill(
        p, {"tokens": t}, true_lens=n))(params, jnp.asarray(prompts),
                                         jnp.asarray(tl))
    _, tseq = tm.prefill(tparams, torch.from_numpy(prompts),
                         true_lens=torch.from_numpy(tl))
    jcache = jm.init_cache(B, n_bt * bs, dtype=jnp.float32, layout="paged",
                           block_size=bs, n_blocks=8)
    tcache = tm.init_cache(B, n_bt * bs, device="cpu", block_size=bs,
                           n_blocks=8)
    for b in range(B):
        jcache = jm.insert_cache(jcache, jm.slice_cache(jseq, b), b,
                                 block_row=jnp.asarray(bt[b]))
        tm.insert_cache(tcache, KVCache([{k: t[b:b + 1] for k, t in
                                          layer.items()}
                                         for layer in tseq.kv]),
                        b, torch.from_numpy(bt[b]))
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)

    def batch(eos, rem):
        return {"token": first[:, None], "pos": tl[:, None],
                "active": np.array([True, True, False]),
                "remaining": np.asarray(rem, np.int32),
                "eos_id": np.int32(eos), "block_table": bt}

    # the stream without EOS picks the EOS: row 0's token at step 1 (the
    # row retires mid-round); row 1's budget of 2 ends mid-round; row 2 is
    # inactive throughout
    probe, _, _ = tm.decode_scan(
        tparams, {k: torch.from_numpy(np.asarray(v))
                  for k, v in batch(-1, [8, 2, 5]).items()},
        KVCache([dict((k, t.clone()) for k, t in layer.items())
                 for layer in tcache.kv], tcache.layout, bs, 8), M)
    eos = int(probe[1, 0])
    assert eos not in probe[:1, 0].tolist()
    jb = {k: jnp.asarray(v) for k, v in batch(eos, [8, 2, 5]).items()}
    jtoks, jcarry, jcache = jax.jit(
        lambda p, b, c: jm.decode_scan(p, b, c, M))(params, jb, jcache)
    ttoks, tcarry, tcache = tm.decode_scan(
        tparams, {k: torch.from_numpy(np.asarray(v))
                  for k, v in batch(eos, [8, 2, 5]).items()}, tcache, M)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    for k in ("token", "pos", "active", "remaining"):
        np.testing.assert_array_equal(tcarry[k].numpy(),
                                      np.asarray(jcarry[k]), err_msg=k)
    assert tcarry["active"].tolist() == [False, False, False]
    assert tcarry["pos"][:, 0].tolist() == [tl[0] + 2, tl[1] + 2, tl[2]]
    groups = jcache.kv[0]
    for i, layer in enumerate(tcache.kv):
        for k, t in layer.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(groups["b0"][k][i]), rtol=0,
                atol=1e-5, err_msg=f"layer {i} {k}")


# ---------------------------------------------------------------------------
# The Server's round loop.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def horizon1(setup):
    done, stats = _tserver(setup).serve(tsched.poisson_trace(6, **TRACE))
    return _toks(done), stats


@pytest.mark.parametrize("horizon", [2, 4])
def test_server_matches_jax_and_horizon1(setup, horizon1, horizon):
    cfg, params, _, _ = setup
    jdone, js = JServer(cfg, params, max_batch=3, max_seq=64,
                        decode_horizon=horizon).serve(
        jsched.poisson_trace(6, **TRACE))
    tdone, ts = _tserver(setup, horizon).serve(
        tsched.poisson_trace(6, **TRACE))
    assert _toks(tdone) == _toks(jdone) == horizon1[0]
    for k in ("decode_steps", "decode_rounds", "host_syncs",
              "decode_horizon", "tokens"):
        assert ts[k] == js[k], k
    assert ts["decode_rounds"] > 0 and ts["decode_compiles"] == 0
    assert ts["blocks_free_end"] == ts["n_blocks"]
    assert ts["host_syncs"] < horizon1[1]["host_syncs"]


def test_max_new_not_multiple_of_horizon(setup):
    specs = [1, 3, 5, 7, 9]
    d0, _ = _tserver(setup, 1, max_batch=4).serve(_requests(specs, seed=3))
    d1, s1 = _tserver(setup, 4, max_batch=4).serve(_requests(specs, seed=3))
    assert _toks(d1) == _toks(d0)
    assert {r.rid: len(r.tokens) for r in d1} == dict(enumerate(specs))
    assert s1["blocks_free_end"] == s1["n_blocks"]


def test_sync_drop(setup):
    """4 x 17 tokens at M = 8: 16 decode emissions a slot, the 4 slots in
    lockstep -> 2 useful rounds, plus at most one trailing all-masked
    round; one sync per round, not per token."""
    srv = _tserver(setup, 8, max_batch=4)
    _, s = srv.serve(_requests([17] * 4))
    assert s["tokens"] == 68
    assert s["host_syncs_per_token"] <= 0.25, s
    assert 2 <= s["decode_rounds"] <= 3, s["decode_rounds"]
    assert s["loop_iters"] <= s["decode_rounds"] + 2


@pytest.mark.parametrize("horizon", [0, -2])
def test_horizon_below_one_raises(setup, horizon):
    with pytest.raises(ValueError, match=">= 1"):
        _tserver(setup, horizon)


def test_eos_mid_round_at_every_offset(setup):
    """M = 4: for each in-round offset 0-3, the EOS is a token that first
    occurs at that offset of the request's stream; horizon 4 retires the
    slot inside the round (the EOS itself emitted) exactly as horizon 1.
    Seed 17's stream reaches all four offsets, three of them in the second
    round."""
    mk = lambda: _requests([12], seed=17)
    d_ref, _ = _tserver(setup, 1, max_batch=1).serve(mk())
    stream = d_ref[0].tokens
    hit = 0
    for off in range(4):
        # decode emission i is stream[1 + i]; its offset at M = 4 is i % 4
        idx = next((1 + i for i in range(len(stream) - 1)
                    if i % 4 == off and stream[1 + i] not in stream[:1 + i]),
                   None)
        if idx is None:
            continue
        hit += 1
        eos = int(stream[idx])
        t1 = _toks(_tserver(setup, 1, max_batch=1, eos_id=eos).serve(mk())[0])
        t4 = _toks(_tserver(setup, 4, max_batch=1, eos_id=eos).serve(mk())[0])
        assert t1 == t4, off
        assert t4[0][-1] == eos and len(t4[0]) == idx + 1, off
    assert hit == 4


def test_cli_path_at_horizon(setup):
    args = argparse.Namespace(
        arch="qwen3-8b", reduced=True, n_layers=0, quant="psi5",
        quant_policy=None, requests=3, max_batch=2, arrival_rate=1e9,
        max_new=6, min_new=1, prompt_len=10, prompt_jitter=2, block_size=0,
        cache_blocks=None, eos_id=-1, seed=0, device="cpu", decode_horizon=4)
    server, cfg = tserve.build_server(args)
    done, stats = server.serve(tserve.trace_from_args(args, cfg))
    assert stats["decode_horizon"] == 4 and stats["decode_rounds"] > 0
    assert stats["decode_steps"] == 4 * stats["decode_rounds"]
    assert all(len(r.tokens) == r.max_new for r in done)


# ---------------------------------------------------------------------------
# The executor's fixed buffers and round carry.
# ---------------------------------------------------------------------------
def test_executor_round_carry_and_fixed_buffers(setup):
    """Chaining the carry uploads nothing and equals a rebuild from host
    mirrors; the pool and the block-table buffer never move."""
    ex = _tserver(setup, 2, max_batch=2).executor
    bt = ex.make_block_table()
    buf = bt.device().data_ptr()
    tok = np.array([[5], [7]], np.int32)
    pos = np.array([[12], [12]], np.int32)
    act = np.array([True, True])
    rem = np.array([6, 6], np.int32)

    def fill():
        cache = ex.init_cache()
        for slot in range(2):
            row = np.full((ex.n_bt,), -1, np.int32)
            row[:2] = [2 * slot, 2 * slot + 1]
            ex.prefill_insert(np.arange(16, dtype=np.int32)[None] + slot,
                              np.array([12], np.int32), cache, slot, row)
            bt[slot] = row
        return cache

    cache = fill()
    pools = [t.data_ptr() for layer in cache.kv for t in layer.values()]
    _, carry, _ = ex.decode_multi(tok, pos, act, rem, cache, bt)
    host = {k: v.clone() for k, v in carry.items()}
    staged = ex._inp_upload.host().copy()
    r2, carry2, _ = ex.decode_multi(carry["token"], carry["pos"],
                                    carry["active"], carry["remaining"],
                                    cache, bt)
    np.testing.assert_array_equal(ex._inp_upload.host(), staged)
    assert carry2 is carry and carry["pos"][:, 0].tolist() == [16, 16]
    # the same two rounds again on the re-zeroed pool, the second one
    # from host mirrors of the first one's carry
    uploads = bt.stats["full_uploads"]
    cache_b = fill()
    assert cache_b is cache and [t.data_ptr() for layer in cache.kv
                                 for t in layer.values()] == pools
    ex.decode_multi(tok, pos, act, rem, cache, bt)
    r3, _, _ = ex.decode_multi(host["token"].numpy(), host["pos"].numpy(),
                               host["active"].numpy(),
                               host["remaining"].numpy(), cache, bt)
    np.testing.assert_array_equal(np.asarray(r3), np.asarray(r2))
    assert bt.stats["full_uploads"] > uploads
    assert bt.device().data_ptr() == buf
    ex.init_cache()
    assert all(bool((t == 0).all()) for layer in cache.kv
               for t in layer.values())
    with pytest.raises(ValueError, match="own pool"):
        ex.decode_multi(tok, pos, act, rem, None, bt)
