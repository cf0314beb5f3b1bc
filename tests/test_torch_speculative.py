"""Self-speculative decoding of the port against the JAX package's.

Draft views and draft trees bit for bit (codes or planes, and scales),
the QAT precondition (quantize, dequantize) exactly, ``Model.verify_step``
against the JAX ``verify_step`` on the same pools (logits within 1e-4, the
pools after the call: untouched entries exactly, written ones within
1e-5) for float32 and int8 pools, and the port's
speculative ``Server`` against the JAX ``Server`` on one trace: identical
tokens, equal to plain decode's, and equal integer stats, for (3, 4) and
(2, 2) drafts at psi8, static mode, an int8 pool, the prefix cache (where
no draft or verify writes a shared block) and a packed psi5 target with a
psi3 draft; under SLO preemption with chunked prefill, the tokens of FIFO
plain decode.  Also the adversarial draft, the construction errors and
the ``summarize`` accounting.  All on the reduced qwen3-8b: JAX ``init``, then
``fake_quant_param_tree(., 3)``, then ``quantize``, carried across by
interop.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import psi as jpsi
from repro.core import quantizer as jquant
from repro.launch import scheduler as jsched
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro.models.kvcache import KVCache as JKVCache
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.core import quantizer as tquant
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import build_model as tbuild_model
from repro_torch.models.kvcache import KVCache

torch.set_num_threads(1)

# f32 logits of two stacks that sum in different orders (as
# test_torch_model.py)
ATOL = 1e-4


def np_tree(t):
    """The neutral numpy form of a JAX param tree (interop's input)."""
    if isinstance(t, jpsi.QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def _assert_trees_equal(got, want, where=""):
    """Two port param trees, leaf by leaf: codes or planes and scales bit
    for bit, the same format and packing; float leaves exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
    elif isinstance(want, tpsi.QuantizedTensor):
        assert isinstance(got, tpsi.QuantizedTensor), where
        assert (got.fmt.bits, got.packed) == (want.fmt.bits, want.packed), \
            where
        assert torch.equal(got.data, want.data), where
        assert torch.equal(got.scale, want.scale), where
    else:
        assert torch.equal(got, want), where


# ---------------------------------------------------------------------------
# Params: one float init, QAT-preconditioned at 3 bits, served at psi8 and
# at psi5 (packed).
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def floats():
    cfg = reduced_config(get_config("qwen3-8b"))
    return cfg, build_model(cfg).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def setups(floats):
    """{label: (JAX cfg, JAX params, port cfg, port params)} for psi8,
    psi5 packed, and psi8 over an int8 KV pool."""
    cfg, params = floats
    pre = jquant.fake_quant_param_tree(params, 3)
    model = build_model(cfg)
    out = {}
    for label, bits, pack, kvq in (("psi8", 8, False, ""),
                                   ("psi5", 5, True, ""),
                                   ("kv-int8", 8, False, "int8")):
        q = model.quantize(pre, bits, pack=pack)
        jcfg = dataclasses.replace(cfg, quant_mode=f"psi{bits}",
                                   kv_quant=kvq)
        tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                       quant_mode=f"psi{bits}",
                                       kv_quant=kvq)
        out[label] = (jcfg, q, tcfg,
                      params_from_numpy(np_tree(q), device="cpu"))
    return out


# ---------------------------------------------------------------------------
# Draft views and trees.
# ---------------------------------------------------------------------------
def _pair(w, bits, axis, pack):
    jq = jpsi.quantize_weights(jnp.asarray(w), bits, axis=axis)
    tq = tpsi.quantize_weights(torch.from_numpy(w), bits, axis=axis)
    if pack:
        jq, tq = jq.pack(), tq.pack()
    return jq, tq


@pytest.mark.parametrize("dbits", [2, 3])
@pytest.mark.parametrize("src,pack", [(8, False), (5, True), (4, True)])
@pytest.mark.parametrize("kind", ["matmul", "embed"])
def test_draft_view_bit_equal(src, pack, dbits, kind):
    """Codes (or planes) and scale of the draft view equal the JAX
    package's bit for bit: a (K, N) weight with per-column scales, and an
    embedding-like table with per-row scales."""
    rng = np.random.default_rng(src * 10 + dbits)
    w = rng.normal(size=(64, 40)).astype(np.float32)
    axis = (0,) if kind == "matmul" else (1,)
    jq, tq = _pair(w, src, axis, pack)
    jd, td = jq.draft_view(dbits), tq.draft_view(dbits)
    assert (td.fmt.bits, td.packed) == (jd.fmt.bits, jd.packed) == \
        (dbits, pack)
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))
    assert td.scale.dtype == torch.float32
    np.testing.assert_array_equal(td.unpack().codes.numpy(),
                                  np.asarray(jd.unpack().codes))


def test_draft_view_same_width_is_self_and_wider_raises():
    w = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    _, tq = _pair(w, 5, (0,), True)
    assert tq.draft_view(5) is tq
    with pytest.raises(ValueError, match="narrows only"):
        tq.draft_view(6)
    assert tq.unpack().unpack().packed is False
    assert tq.unpack().pack().data.equal(tq.data)


@pytest.mark.parametrize("label,dbits", [("psi8", 3), ("psi5", 3),
                                         ("psi5", 2)])
def test_draft_param_tree_bit_equal(setups, label, dbits):
    _, jparams, _, tparams = setups[label]
    want = params_from_numpy(np_tree(jquant.draft_param_tree(jparams, dbits)),
                             device="cpu")
    got = tquant.draft_param_tree(tparams, dbits)
    _assert_trees_equal(got, want)
    assert got["layers"][0]["attn"]["wq"].fmt.bits == dbits
    assert got["layers"][0]["norm1"]["scale"] is \
        tparams["layers"][0]["norm1"]["scale"]


def test_fake_quant_param_tree_exact(floats):
    """The QAT precondition on carried-over float params equals the JAX
    package's to the last bit (0 ulp), and the port's init applies the
    same snap leaf by leaf."""
    _, params = floats
    want = params_from_numpy(np_tree(jquant.fake_quant_param_tree(params, 3)),
                             device="cpu")
    got = tquant.fake_quant_param_tree(
        params_from_numpy(np_tree(params), device="cpu"), 3)
    _assert_trees_equal(got, want)
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"))
    tm = tbuild_model(tcfg)
    raw = tm.init(seed=1, device="cpu")
    snapped = tm.init(seed=1, device="cpu", qat_precondition=3)
    _assert_trees_equal(snapped, tquant.fake_quant_param_tree(raw, 3))


# ---------------------------------------------------------------------------
# Model.verify_step against the JAX verify_step.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", ["psi8", "kv-int8"])
def test_verify_step_matches_jax(setups, label):
    """4 slots, k = 4, 16-position blocks: slot 0 crosses a block boundary
    (14-17), slot 1 is inactive (table all -1), slot 2 has a -1 entry
    under its first two positions (30-33: scratch, then block 3), slot 3
    runs past its table (46-49: block 6, then scratch).  Pools of random
    garbage; logits of the active slots within ATOL; after the call, the
    set of written entries equal, the untouched entries bit for bit."""
    jcfg, jparams, tcfg, tparams = setups[label]
    jm, tm = build_model(jcfg), tbuild_model(tcfg)
    B, k, n_bt, bs, nb = 4, 4, 3, 16, 8
    rng = np.random.default_rng(5)
    jcache = jm.init_cache(B, n_bt * bs, dtype=jnp.float32, layout="paged",
                           block_size=bs, n_blocks=nb)
    groups = jcache.kv[0]["b0"]
    fill = {}
    for name, t in groups.items():
        if t.dtype == jnp.int8:
            fill[name] = rng.integers(-127, 128, size=t.shape).astype(np.int8)
        elif name.endswith("scale"):
            fill[name] = rng.uniform(1e-3, 0.05, size=t.shape).astype(
                np.float32)
        else:
            fill[name] = rng.normal(size=t.shape).astype(np.float32)
    jcache = JKVCache(({"b0": {n: jnp.asarray(a) for n, a in fill.items()}},
                       []), None, jcache.layout, bs, nb)
    tcache = KVCache([{n: torch.from_numpy(a[i].copy())
                       for n, a in fill.items()}
                      for i in range(tcfg.n_layers)], "paged", bs, nb)
    tokens = rng.integers(0, tcfg.vocab_size, size=(B, k)).astype(np.int32)
    pos0 = np.array([[14], [3], [30], [46]], np.int32)
    active = np.array([True, False, True, True])
    bt = np.array([[0, 1, -1], [-1, -1, -1], [2, -1, 3], [4, 5, 6]],
                  np.int32)
    batch = {"tokens": tokens, "pos0": pos0, "active": active,
             "block_table": bt}
    jl, jcache = jax.jit(jm.verify_step)(
        jparams, {n: jnp.asarray(v) for n, v in batch.items()}, jcache)
    tl, tcache = tm.verify_step(
        tparams, {n: torch.from_numpy(v) for n, v in batch.items()}, tcache)
    assert tl.shape == (B, k, tcfg.vocab_size)
    rows = [b for b in range(B) if active[b]]
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               rtol=0, atol=ATOL)
    # the writes landed where the routing says: block 0 offsets 14-15,
    # block 1 offsets 0-1, block 3 offsets 0-1, block 6 offsets 14-15, and
    # the scratch blocks of slots 1-3
    written = np.zeros((nb + B, bs), bool)
    for blk, offs in ((0, [14, 15]), (1, [0, 1]), (3, [0, 1]), (6, [14, 15]),
                      (nb + 1, [3, 4, 5, 6]), (nb + 2, [14, 15]),
                      (nb + 3, [0, 1])):
        written[blk, offs] = True
    jkv = jcache.kv[0]["b0"]
    for i, layer in enumerate(tcache.kv):
        for name, t in layer.items():
            got, want = t.numpy(), np.asarray(jkv[name][i])
            moved = (got != fill[name][i]).any(axis=(2, 3))
            np.testing.assert_array_equal(moved, written,
                                          err_msg=f"layer {i} {name}")
            # every entry no write reached, bit for bit; the written ones
            # come from the two stacks' K/V projections, which sum in other
            # orders (a few 1e-7 in f32): 1e-5, as the decode block's test
            np.testing.assert_array_equal(got[~written], want[~written],
                                          err_msg=f"layer {i} {name}")
            np.testing.assert_allclose(got[written], want[written], rtol=0,
                                       atol=1e-5 if got.dtype != np.int8
                                       else 0, err_msg=f"layer {i} {name}")


# ---------------------------------------------------------------------------
# The speculative Server against the JAX Server.
# ---------------------------------------------------------------------------
def _trace(mod, seed=0, n=4, budgets=(4, 7, 3, 6)):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(
        0, 256, size=(5 + 3 * i,)).astype(np.int32),
        max_new=budgets[i % len(budgets)], arrival_s=0.001 * i)
        for i in range(n)]


def _prefix_trace(mod):
    """5 requests sharing a 32-token prefix (two blocks), 4-token tails."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, size=(32,)).astype(np.int32)
    return [mod.Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, 256, size=(4,)).astype(np.int32)]),
        max_new=3 + i % 4, arrival_s=0.001 * i) for i in range(5)]


def _toks(done):
    return {r.rid: list(r.tokens) for r in done}


def jax_serve(server, trace, **kw):
    """The JAX ``Server.serve`` with the stat it does not report:
    ``prefill_forwards``, its executor's prefill and prefill-insert calls
    after warmup (one forward each, a burst's included)."""
    ex = server.executor
    calls = [0]

    def counted(fn):
        def call(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return call

    ex.prefill, ex.prefill_insert = (counted(ex.prefill),
                                     counted(ex.prefill_insert))
    try:
        server.warmup(trace, verbose=False)
        calls[0] = 0
        done, stats = server.serve(trace, warmup=False, **kw)
    finally:
        del ex.prefill, ex.prefill_insert
    stats["prefill_forwards"] = calls[0]
    return done, stats


CASES = {
    # label: (params, speculative, continuous, prefix cache, max_seq)
    "psi8-3:4": ("psi8", (3, 4), True, False, 64),
    "psi8-2:2": ("psi8", (2, 2), True, False, 64),
    "psi8-3:4-static": ("psi8", (3, 4), False, False, 64),
    "kv-int8-3:4": ("kv-int8", (3, 4), True, False, 64),
    "psi8-3:4-prefix": ("psi8", (3, 4), True, True, 96),
    "psi5-3:4": ("psi5", (3, 4), True, False, 64),
}
INT_STATS = ("decode_steps", "host_syncs", "blocks_free_end", "tokens",
             "prefill_forwards")


@pytest.fixture(scope="module")
def plain(setups):
    """The port's plain-decode tokens: the oracle of every case."""
    out = {}

    def get(label, prefix):
        key = (label, prefix)
        if key not in out:
            _, _, tcfg, tparams = setups[label]
            tcfg = dataclasses.replace(tcfg, prefix_cache=prefix)
            server = tserve.Server(tcfg, tparams, max_batch=2,
                                   max_seq=96 if prefix else 64,
                                   device="cpu")
            trace = _prefix_trace if prefix else _trace
            out[key] = _toks(server.serve(trace(tsched))[0])
        return out[key]
    return get


def _spec_prefix_guard(monkeypatch, server):
    """Check, before every draft and verify, that no active slot writes a
    block the prefix cache holds: [pos, pos + k) through the slot's table.
    Returns a dict counting the rounds whose tables held a shared block."""
    seen = {"caches": [], "rounds_over_shared": 0}

    class Recorded(tserve.PrefixCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["caches"].append(self)

    monkeypatch.setattr(tserve, "PrefixCache", Recorded)
    ex = server.executor
    k, bs = ex.spec_k, ex.block_size

    def guard(fn, pos_i, act_i):
        def wrapped(*a):
            pos, active = np.asarray(a[pos_i]), np.asarray(a[act_i])
            table = getattr(a[-1], "host", a[-1])   # warmup: an ndarray
            caches = seen["caches"]
            shared = set(caches[-1].cached_blocks) if caches else set()
            over = False
            for slot in np.flatnonzero(active):
                row = table[slot]
                for p in range(int(pos[slot, 0]), int(pos[slot, 0]) + k):
                    if p // bs < len(row) and row[p // bs] >= 0:
                        assert row[p // bs] not in shared, (slot, p)
                over |= bool(set(row[row >= 0].tolist()) & shared)
            seen["rounds_over_shared"] += int(over and pos_i == 2)
            return fn(*a)
        return wrapped

    ex.draft = guard(ex.draft, 1, 2)
    ex.verify = guard(ex.verify, 2, 3)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_server_matches_jax_and_plain_decode(setups, plain, case,
                                             monkeypatch):
    label, spec, continuous, prefix, max_seq = CASES[case]
    jcfg, jparams, tcfg, tparams = setups[label]
    jcfg = dataclasses.replace(jcfg, prefix_cache=prefix)
    tcfg = dataclasses.replace(tcfg, prefix_cache=prefix)
    trace = _prefix_trace if prefix else _trace
    jdone, js = jax_serve(JServer(jcfg, jparams, max_batch=2,
                                  max_seq=max_seq, speculative=spec),
                          trace(jsched), continuous=continuous)
    server = tserve.Server(tcfg, tparams, max_batch=2, max_seq=max_seq,
                           device="cpu", speculative=spec)
    guard = _spec_prefix_guard(monkeypatch, server) if prefix else None
    tdone, ts = server.serve(trace(tsched), continuous=continuous)
    assert _toks(tdone) == _toks(jdone) == plain(label, prefix)
    for k in ("rounds", "accepted_draft_tokens", "draft_bits", "k"):
        assert ts["speculative"][k] == js["speculative"][k], k
    for k in INT_STATS:
        assert ts[k] == js[k], k
    assert ts["speculative"]["rounds"] > 0
    assert ts["speculative"]["spec_compiles"] == {"draft": 0, "verify": 0,
                                                  "decode": 0}    # eager
    assert ts["accepted_per_step"] == pytest.approx(js["accepted_per_step"])
    assert ts["blocks_free_end"] == ts["n_blocks"]
    if prefix:
        assert ts["prefix_cache"]["hits"] == js["prefix_cache"]["hits"] > 0
        assert guard["rounds_over_shared"] > 0
    if case == "psi8-3:4":
        # the QAT precondition makes multi-token acceptance real
        assert ts["speculative"]["mean_accepted"] > 1


def test_spec_under_slo_preemption_and_chunks(setups):
    """--speculative 3:4 with --slo, --prefill-chunk 16 and the prefix
    cache on the tight pool (8 blocks) of test_torch_slo.py: preemptions
    and restores happen between rounds (a victim publishes only its
    verified KV, below its feed position), and the tokens are the FIFO
    plain-decode run's; no block leaks."""
    _, _, tcfg, tparams = setups["psi8"]
    pol = "default@aging=5@reserve=0.1"

    def bursty():
        return tslo.bursty_heavy_tail_trace(
            16, vocab_size=256, seed=7, burst_size=8, burst_gap_s=0.3,
            long_frac=0.6, mix=tslo.parse_slo_spec(pol).mix([3.0, 2.0, 1.0]))

    fifo, _ = tserve.Server(tcfg, tparams, max_batch=4, max_seq=112,
                            n_blocks=8, device="cpu").serve(bursty())
    srv = tserve.Server(dataclasses.replace(tcfg, prefix_cache=True),
                        tparams, max_batch=4, max_seq=112, n_blocks=8,
                        prefill_chunk=16, slo=tslo.parse_slo_spec(pol),
                        speculative=(3, 4), device="cpu")
    done, stats = srv.serve(bursty())
    assert _toks(done) == _toks(fifo)
    assert stats["preemptions"] > 0 and stats["prefix_cache"]["restores"] > 0
    assert stats["prefill_chunks"] > 0
    assert stats["speculative"]["mean_accepted"] > 1
    assert stats["blocks_free_end"] == stats["n_blocks"] == 8


def test_draft_reaches_kernel_2_plain_version_at_3_bits(setups):
    """A packed psi5 target's draft tree is packed psi3: the draft's
    matmuls take kernel 2's route (the plain version on the CPU)."""
    _, _, tcfg, tparams = setups["psi5"]
    server = tserve.Server(tcfg, tparams, max_batch=2, max_seq=64,
                           device="cpu", speculative=(3, 4))
    wq = server.executor.draft_params["layers"][0]["attn"]["wq"]
    assert wq.packed and wq.fmt.bits == 3 and wq.data.shape[0] == 3
    calls = []
    real = tserve.ops._ref.psi_matmul_packed_ref

    def counted(x, planes, scale, bits):
        calls.append(bits)
        return real(x, planes, scale, bits)

    tserve.ops._ref.psi_matmul_packed_ref = counted
    try:
        server.executor.draft(np.zeros((2, 1), np.int32),
                              np.zeros((2, 1), np.int32),
                              np.array([True, False]),
                              server.executor.init_cache(),
                              np.full((2, server.executor.n_bt), -1,
                                      np.int32))
    finally:
        tserve.ops._ref.psi_matmul_packed_ref = real
    # k = 4 draft steps of 7 matmuls per layer plus the lm-head, all psi3
    assert calls == [3] * 4 * (7 * tcfg.n_layers + 1)


def test_adversarial_draft_degrades_to_plain_decode(setups, plain):
    """Drafts forced to -1 (never an argmax; the embedding reads row -1,
    the last row, in both packages) are all rejected: one verified token a
    round, the plain stream, no leaked block.  CPU only."""
    _, _, tcfg, tparams = setups["psi8"]
    server = tserve.Server(tcfg, tparams, max_batch=2, max_seq=64,
                           device="cpu", speculative=(3, 4))
    real = server.executor.draft

    def hostile(token, pos, active, cache, block_table):
        drafts, cache = real(token, pos, active, cache, block_table)
        return torch.full_like(torch.from_numpy(np.asarray(drafts)), -1), \
            cache

    server.executor.draft = hostile
    done, stats = server.serve(_trace(tsched))
    sp = stats["speculative"]
    assert _toks(done) == plain("psi8", False)
    assert sp["accepted_draft_tokens"] == 0 and sp["mean_accepted"] == 0.0
    assert stats["accepted_per_step"] == 0.0
    assert sp["rounds"] == sum(len(r.tokens) - 1 for r in done)
    assert stats["blocks_free_end"] == stats["n_blocks"]


# ---------------------------------------------------------------------------
# Construction errors.
# ---------------------------------------------------------------------------
def test_parse_spec_spec():
    assert tserve.parse_spec_spec(None) is None
    assert tserve.parse_spec_spec("off") is None
    assert tserve.parse_spec_spec("3:4") == (3, 4)
    assert tserve.parse_spec_spec("2:8") == (2, 8)
    for bad in ("3", "3:0", "a:b", "3:4:5"):
        with pytest.raises(ValueError):
            tserve.parse_spec_spec(bad)


@pytest.mark.parametrize("what", ["k_over_block", "float_params",
                                  "horizon"])
def test_construction_errors(setups, what):
    _, _, tcfg, tparams = setups["psi8"]
    kw = dict(max_batch=2, max_seq=64, device="cpu", speculative=(3, 4))
    if what == "k_over_block":
        kw["speculative"] = (3, tcfg.cache_block_size + 1)
        match = "block"
    elif what == "float_params":
        tparams = tbuild_model(tcfg).init(seed=0, device="cpu")
        match = "[Qq]uantize"
    else:
        kw["decode_horizon"] = 4
        match = "horizon"
    with pytest.raises(ValueError, match=match):
        tserve.Server(tcfg, tparams, **kw)


def _cli(**kw):
    base = dict(arch="qwen3-8b", reduced=True, n_layers=0, quant="psi8",
                quant_policy=None, requests=3, max_batch=2,
                arrival_rate=1e9, max_new=6, min_new=1, prompt_len=10,
                prompt_jitter=2, block_size=0, cache_blocks=None, eos_id=-1,
                seed=0, device="cpu", speculative="3:4", qat_precondition=3)
    base.update(kw)
    return argparse.Namespace(**base)


def test_cli_draft_must_be_narrower():
    with pytest.raises(ValueError, match="wider serving format"):
        tserve.build_server(_cli(quant="psi5", speculative="5:4"))


def test_cli_speculative_serve():
    """--speculative 3:4 --qat-precondition 3 through build_server: max_seq
    takes the k-1 overhang, tokens equal the plain CLI serve's."""
    server, cfg = tserve.build_server(_cli())
    plain_server, _ = tserve.build_server(_cli(speculative=None))
    assert server.max_seq >= plain_server.max_seq
    assert server.spec == (3, 4) and server._spec_overhang == 3
    done, stats = server.serve(tserve.trace_from_args(_cli(), cfg))
    want, _ = plain_server.serve(tserve.trace_from_args(_cli(), cfg))
    assert _toks(done) == _toks(want)
    assert stats["speculative"]["rounds"] > 0


# ---------------------------------------------------------------------------
# summarize accounting (the reference's three cases).
# ---------------------------------------------------------------------------
def test_summarize_zero_finished_is_strict_json():
    stats = tsched.summarize([], wall_s=1.0)
    assert stats["accepted_per_step"] == 0.0
    assert stats["draft_overhead_s"] == 0.0


def _finished(rounds, accepted, n_tokens=2, draft_s=0.25):
    r = tsched.Request(rid=0, prompt=np.zeros((4,), np.int32), max_new=4,
                       arrival_s=0.0)
    r.admit_s, r.first_token_s, r.finish_s = 0.1, 0.2, 1.0
    r.tokens = list(range(1, n_tokens + 1))
    r.spec_rounds, r.spec_accepted, r.draft_s = rounds, accepted, draft_s
    return r


def test_summarize_skips_nonspeculative_requests():
    reqs = [_finished(r, a) for r, a in [(0, 0), (4, 12), (2, 2)]]
    assert np.isnan(reqs[0].accepted_per_step)
    stats = tsched.summarize(reqs, wall_s=2.0)
    assert stats["accepted_per_step"] == pytest.approx(2.0)   # (3 + 1) / 2
    assert stats["draft_overhead_s"] == pytest.approx(0.75)


def test_all_nonspeculative_degrades_to_zero():
    stats = tsched.summarize([_finished(0, 0, n_tokens=1, draft_s=0.0)],
                             wall_s=1.0)
    assert stats["accepted_per_step"] == 0.0
    assert stats["draft_overhead_s"] == 0.0
