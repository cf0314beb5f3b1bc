"""The dense cache layout (per-slot slabs, the SWA ring) and burst prefill
of the port against the JAX package's.

The config's layout guards with their errors; ``_states_to_cache`` (pad,
identity and the SWA roll; float32 within 1e-5, int8 codes and ``k_pos``
exact); ``decode_attention_block`` on full and wrapped-ring slabs with a
mixed ``active`` mask (inactive rows untouched bit for bit); the cache
splitting of a burst (``slice_cache``, the dense ``insert_cache``,
``insert_burst`` in both layouts with a ``valid`` mask); the port's
``Server`` on dense against the JAX ``Server`` (tokens and integer stats,
``prefill_forwards`` included: continuous and static, horizon 1 and 4,
int8 KV, a wrapped SWA ring, a burst that takes the one-by-one fallback)
and on paged with burst prefill; a burst row against its prefill alone,
bit for bit; the refusals on dense.  All on the reduced qwen3-8b (JAX
``init`` + ``quantize`` at psi8, carried across by interop); SWA through
``dataclasses.replace(cfg, attn_type="swa", window=W)`` in both packages.
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
from repro.launch import slo as jslo
from repro.launch.serve import Server as JServer
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.models.kvcache import KVCache as JKVCache
from repro.runtime.executor import Executor as JExecutor
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.kvcache import KVCache
from repro_torch.runtime import Executor

torch.set_num_threads(1)

ATOL = 1e-4                 # logits tolerance of test_torch_model.py
FLOAT_TOL = 1e-5            # cache floats written by either package
TRACE = dict(rate_rps=1e9, prompt_len=12, max_new=8, min_new=2,
             vocab_size=256, seed=3, prompt_jitter=4)
INT_STATS = ("n_requests", "tokens", "decode_steps", "host_syncs",
             "prefill_forwards", "prefilled_tokens", "peak_concurrency")


def np_tree(t):
    """The neutral numpy form of a JAX param tree (interop's input)."""
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


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


def _cfgs(**over):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-8b")), **over)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("qwen3-8b")), **over)
    return cfg, tcfg


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = _cfgs(quant_mode="psi8")
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    return cfg, params, tcfg, params_from_numpy(np_tree(params),
                                                device="cpu")


# ---------------------------------------------------------------------------
# Config guards.
# ---------------------------------------------------------------------------
def _resolve(cfg):
    try:
        return ("ok", cfg.resolved_cache_layout, cfg.paged_capable)
    except ValueError as e:
        return ("error", str(e), cfg.paged_capable)


@pytest.mark.parametrize("layout", ["auto", "dense", "paged", "ring"])
@pytest.mark.parametrize("attn", ["full", "swa"])
def test_layout_resolution_matches_jax(attn, layout):
    over = dict(cache_layout=layout, attn_type=attn,
                window=16 if attn == "swa" else 0)
    cfg, tcfg = _cfgs(**over)
    assert _resolve(tcfg) == _resolve(cfg)
    for full in (False, True):
        got = tconfigs.get_config("qwen3-8b", **over)
        want = get_config("qwen3-8b", **over)
        if not full:
            got, want = tconfigs.reduced_config(got), reduced_config(want)
        assert (got.window, _resolve(got)) == (want.window, _resolve(want))


def test_reduced_window_matches_jax():
    for w in (8, 32, 4096):
        got = tconfigs.reduced_config(tconfigs.get_config(
            "qwen3-8b", attn_type="swa", window=w))
        want = reduced_config(get_config("qwen3-8b", attn_type="swa",
                                         window=w))
        assert got.window == want.window == min(w, 32)


# ---------------------------------------------------------------------------
# Prefill states -> the dense (ring) cache.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("case", ["pad", "equal", "roll"])
def test_states_to_cache_matches_jax(case, kv_quant):
    S, cache_len, over = {"pad": (10, 16, {}), "equal": (16, 16, {}),
                          "roll": (27, 40, {"attn_type": "swa",
                                            "window": 16})}[case]
    cfg, tcfg = _cfgs(kv_quant=kv_quant, **over)
    B, H, D = 2, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(1)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, H, D)).astype(np.float32)
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jst = {"b0": {"k": jnp.asarray(k)[None], "v": jnp.asarray(v)[None],
                  "k_pos": jnp.asarray(kp)[None]}}
    want = jmodel._states_to_cache(cfg, (jst, []), S, cache_len)[0]["b0"]
    got = tmodel._states_to_cache(
        tcfg, {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
               "k_pos": torch.from_numpy(kp)}, S, cache_len)
    assert set(got) == set(want)
    for name in got:
        w = np.asarray(want[name])[0]
        if got[name].dtype == torch.float32:
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                       atol=FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name].numpy(), w,
                                          err_msg=name)
    C = got["k_pos"].shape[1]
    assert C == (16 if case == "roll" else cache_len)
    if case == "roll":        # the tail window at slots pos % C
        assert sorted(got["k_pos"][0].tolist()) == list(range(S - C, S))
        assert got["k_pos"][0, (S - 1) % C] == S - 1


# ---------------------------------------------------------------------------
# The dense decode block.
# ---------------------------------------------------------------------------
def _block_params(cfg):
    p = jattn.init_attention(cfg, jax.random.PRNGKey(2))
    tp = params_from_numpy({"embed": np.zeros((1, 1), np.float32),
                            "norm_f": {},
                            "stack": {"groups": {"b0_attn": {
                                k: np.asarray(v)[None]
                                for k, v in p.items()}}}},
                           device="cpu")["layers"][0]
    return p, tp


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_block_matches_jax(ring, kv_quant):
    """Three rows, the middle one inactive: the active rows write at slot
    ``pos % C`` (past C on the ring: it wraps and evicts the oldest
    entry), the inactive row's slab entries stay bit for bit."""
    over = {"attn_type": "swa", "window": 16} if ring else {}
    cfg, tcfg = _cfgs(kv_quant=kv_quant, **over)
    p, tp = _block_params(cfg)
    B, C = 3, 16 if ring else 24
    rng = np.random.default_rng(4)
    jc = jattn.init_kv_cache(cfg, B, C, jnp.float32)
    jc = {k: (jnp.asarray(rng.normal(size=v.shape), v.dtype)
              if k != "k_pos" else v) for k, v in jc.items()}
    # positions held: row b has its first n_b positions (ring: the last C)
    pos = np.array([[21], [9], [33]] if ring else [[13], [9], [20]],
                   np.int32)
    kp = np.full((B, C), -1, np.int32)
    for b in range(B):
        for q in range(max(0, pos[b, 0] - C), pos[b, 0]):
            kp[b, q % C] = q
    jc["k_pos"] = jnp.asarray(kp)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    act = np.array([True, False, True])
    jy, jc2 = jattn.decode_attention_block(
        p, jnp.asarray(x), cfg, jnp.asarray(pos), jc,
        active=jnp.asarray(act))
    ty, tc2 = tattn.decode_attention_block(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos), tc,
        active=torch.from_numpy(act))
    assert tc2 is tc                                   # in place
    rows = np.flatnonzero(act)
    np.testing.assert_allclose(ty.numpy()[rows], np.asarray(jy)[rows],
                               rtol=0, atol=ATOL)
    for k in jc2:
        got, want = tc2[k].numpy(), np.asarray(jc2[k])
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert torch.equal(tc2[k][1], before[k][1]), k   # inactive row
    for b in rows:
        slot = pos[b, 0] % C
        assert tc2["k_pos"][b, slot] == pos[b, 0]
    if ring:
        assert pos[0, 0] > C and tc2["k_pos"][0, pos[0, 0] % C] != \
            before["k_pos"][0, pos[0, 0] % C]             # wrapped


# ---------------------------------------------------------------------------
# Splitting a burst's cache: slice, insert, insert_burst.
# ---------------------------------------------------------------------------
def _jkv_to_layers(kv):
    """A JAX (groups, tail) stack cache -> the port's per-layer dicts."""
    g = kv[0]["b0"]
    L = next(iter(g.values())).shape[0]
    return [{k: torch.from_numpy(np.array(v[i])) for k, v in g.items()}
            for i in range(L)]


def _random_seq_kv(cfg, B, C, rng):
    kv = jtransformer.init_stack_cache(cfg, B, C, jnp.float32)
    kv = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rng.integers(-1, C, size=a.shape), a.dtype)
                   if a.dtype == jnp.int32 else
                   jnp.asarray(rng.normal(size=a.shape), a.dtype)), kv)
    return kv


def _assert_layers_equal(got, want, skip_blocks=()):
    for gl, wl in zip(got, want):
        assert set(gl) == set(wl)
        for k in gl:
            keep = [i for i in range(gl[k].shape[0]) if i not in skip_blocks]
            assert torch.equal(gl[k][keep], wl[k][keep]), k


def test_slice_and_dense_insert_match_jax(setup):
    cfg, params, tcfg, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, cache_layout="dense")
                 for c in (cfg, tcfg))
    jm, tm = build_model(cfg), tmodel.Model(tcfg)
    rng = np.random.default_rng(7)
    seq = JKVCache(_random_seq_kv(cfg, 3, 32, rng))
    tseq = KVCache(_jkv_to_layers(seq.kv))
    for row in range(3):
        _assert_layers_equal(tm.slice_cache(tseq, row).kv,
                             _jkv_to_layers(jm.slice_cache(seq, row).kv))
    big = jm.init_cache(4, 32, dtype=jnp.float32)
    tbig = KVCache(_jkv_to_layers(big.kv))
    for slot, row in ((2, 0), (0, 2)):
        big = jm.insert_cache(big, jm.slice_cache(seq, row), slot)
        got = tm.insert_cache(tbig, tm.slice_cache(tseq, row), slot)
        assert got is tbig                                  # in place
    _assert_layers_equal(tbig.kv, _jkv_to_layers(big.kv))
    assert (tbig.kv[0]["k_pos"][[1, 3]] == -1).all()        # untouched
    with pytest.raises(ValueError, match="paged"):
        tm.slice_cache(KVCache(tbig.kv, "paged", 16, 4), 0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_insert_burst_matches_jax(setup, layout):
    """Rows 0 and 2 of a 3-row burst into slots 2 and 0 (row 1 invalid);
    paged: through block rows that end in -1 (the burst's padding goes to
    the slot's scratch block, whose contents neither package reads)."""
    cfg, params, tcfg, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, cache_layout=layout)
                 for c in (cfg, tcfg))
    jex = JExecutor(cfg, params, max_batch=3, max_seq=48)
    tex = Executor(tcfg, tparams, max_batch=3, max_seq=48, device="cpu")
    rng = np.random.default_rng(8)
    C = 48 if layout == "dense" else 32
    seq = JKVCache(_random_seq_kv(cfg, 3, C, rng))
    tseq = KVCache(_jkv_to_layers(seq.kv))
    slots = np.array([2, 1, 0], np.int32)
    valid = np.array([True, False, True])
    rows = None
    if layout == "paged":
        rows = np.full((3, tex.n_bt), -1, np.int32)
        rows[0, :2] = [4, 0]
        rows[1, :2] = [1, 2]
        rows[2, :1] = [7]
    jc = jex.insert_burst(jex.init_cache(), seq, slots, valid,
                          block_rows=rows)
    tc = tex.insert_burst(tex.init_cache(), tseq, slots, valid,
                          block_rows=rows)
    scratch = (range(tex.n_blocks, tex.n_blocks + 3) if layout == "paged"
               else ())
    _assert_layers_equal(tc.kv, _jkv_to_layers(jc.kv), skip_blocks=scratch)


# ---------------------------------------------------------------------------
# The Server on dense (and paged with bursts) against the JAX Server.
# ---------------------------------------------------------------------------
SERVES = {
    # label: (config overrides, Server kwargs, continuous, trace overrides)
    "dense": ({"cache_layout": "dense"}, {}, True, {}),
    "dense-static": ({"cache_layout": "dense"}, {}, False, {}),
    "dense-h4": ({"cache_layout": "dense"}, {"decode_horizon": 4}, True, {}),
    "dense-h4-static": ({"cache_layout": "dense"}, {"decode_horizon": 4},
                        False, {}),
    "dense-kv-int8": ({"cache_layout": "dense", "kv_quant": "int8"}, {},
                      False, {}),
    # prompt + new tokens pass the window: the ring wraps while decoding
    "swa-16": ({"attn_type": "swa", "window": 16}, {}, False, {}),
    # prompts past the window at different exact lengths: the burst
    # prefills one by one (pad_safe), each prompt rolling the ring
    "swa-16-fallback": ({"attn_type": "swa", "window": 16}, {}, False,
                        {"prompt_len": 20, "prompt_jitter": 3}),
    "paged": ({}, {}, True, {}),
    "paged-static": ({}, {}, False, {}),
}


@pytest.mark.parametrize("case", list(SERVES))
def test_server_matches_jax(setup, case, monkeypatch):
    over, kw, continuous, tover = SERVES[case]
    cfg, params, tcfg, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, **over) for c in (cfg, tcfg))
    trace = dict(TRACE, **tover)
    jdone, js = jax_serve(JServer(cfg, params, max_batch=3, max_seq=48,
                                  **kw),
                          jsched.poisson_trace(7, **trace),
                          continuous=continuous)
    server = tserve.Server(tcfg, tparams, max_batch=3, max_seq=48,
                           device="cpu", **kw)
    forwards = []
    prefill = server.executor.prefill
    monkeypatch.setattr(server.executor, "prefill", lambda toks, *a, **k: (
        forwards.append(np.asarray(toks).shape[0]), prefill(toks, *a, **k))[1])
    tdone, ts = server.serve(tsched.poisson_trace(7, **trace),
                             continuous=continuous)
    assert _toks(tdone) == _toks(jdone)
    for k in INT_STATS:
        assert ts[k] == js[k], k
    assert ts["cache_layout"] == js["cache_layout"]
    if js["cache_layout"] == "paged":
        assert ts["blocks_free_end"] == js["blocks_free_end"] == \
            ts["n_blocks"]
    else:
        assert "n_blocks" not in ts and "blocks_free_end" not in ts
    if "fallback" in case:
        assert max(forwards, default=1) == 1             # one by one
    elif not continuous:
        assert max(forwards) > 1                         # a real burst
    if case.startswith("swa"):
        done = {r.rid: r for r in tdone}
        assert any(len(r.prompt) + len(r.tokens) > 16 for r in done.values())
        assert ts["cache_bytes"] == server.executor.max_batch * 16 * \
            tcfg.n_kv_heads * tcfg.resolved_head_dim * 4 * 2 * \
            tcfg.n_layers + server.executor.max_batch * 16 * 4 * \
            tcfg.n_layers


def test_dense_tokens_equal_paged(setup):
    """Both layouts serve the same greedy tokens (the reference's
    layout-equivalence rule)."""
    _, _, tcfg, tparams = setup
    out = {}
    for layout in ("dense", "paged"):
        srv = tserve.Server(dataclasses.replace(tcfg, cache_layout=layout),
                            tparams, max_batch=3, max_seq=48, device="cpu")
        out[layout] = _toks(srv.serve(tsched.poisson_trace(7, **TRACE))[0])
    assert out["dense"] == out["paged"]


# ---------------------------------------------------------------------------
# A burst row against its prefill alone, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "paged", "swa"])
def test_burst_rows_equal_alone(setup, layout, dtype):
    """Three prompts of three buckets (16, 32, 48; the SWA ring at window
    64 holds them all) in one forward: each row's first token and the cache
    rows of its bucket equal that prompt's prefill alone exactly, and its
    ``k_pos`` over the whole extent."""
    _, _, tcfg, tparams = setup
    over = ({"attn_type": "swa", "window": 64} if layout == "swa"
            else {"cache_layout": layout})
    tcfg = dataclasses.replace(tcfg, dtype=dtype, **over)
    ex = Executor(tcfg, tparams, max_batch=3, max_seq=80, device="cpu")
    rng = np.random.default_rng(11)
    lens = [13, 40, 22]
    buckets = [16, 48, 32]
    toks = np.zeros((3, 48), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, size=n)
    first, burst = ex.prefill(toks, np.asarray(lens, np.int32),
                              row_lens=buckets)
    for i, (n, sb) in enumerate(zip(lens, buckets)):
        f1, alone = ex.prefill(toks[i:i + 1, :sb], np.asarray([n], np.int32))
        assert int(f1[0]) == int(first[i])
        for lb, la in zip(burst.kv, alone.kv):
            for name in la:
                if name == "k_pos" and la[name].shape[1] == lb[name].shape[1]:
                    assert torch.equal(lb[name][i], la[name][0]), name
                assert torch.equal(lb[name][i, :sb], la[name][0, :sb]), name


# ---------------------------------------------------------------------------
# Refusals on dense, and the CLI.
# ---------------------------------------------------------------------------
REFUSALS = {
    "prefix-cache": ({"prefix_cache": True}, {}),
    "slo": ({}, {"slo": "default"}),
    "prefill-chunk": ({}, {"prefill_chunk": 16}),
    "speculative": ({}, {"speculative": (3, 4)}),
    "n-blocks": ({}, {"n_blocks": 8}),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_dense_refusals_match_jax(setup, what):
    over, kw = REFUSALS[what]
    cfg, params, tcfg, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, cache_layout="dense", **over)
                 for c in (cfg, tcfg))
    jkw, tkw = dict(kw), dict(kw)
    if "slo" in kw:
        jkw["slo"] = jslo.parse_slo_spec(kw["slo"])
        tkw["slo"] = tslo.parse_slo_spec(kw["slo"])
    with pytest.raises(ValueError) as want:
        JServer(cfg, params, max_batch=2, max_seq=48, **jkw)
    with pytest.raises(ValueError) as got:
        tserve.Server(tcfg, tparams, max_batch=2, max_seq=48, device="cpu",
                      **tkw)
    assert str(got.value) == str(want.value)


def test_dense_cache_refuses_the_paged_only_paths(setup):
    _, _, tcfg, tparams = setup
    tcfg = dataclasses.replace(tcfg, cache_layout="dense")
    ex = Executor(tcfg, tparams, max_batch=2, max_seq=32, device="cpu")
    cache = ex.init_cache()
    assert not cache.paged and ex.n_bt == 0
    with pytest.raises(ValueError, match="dense"):
        ex.model.gather_prefix_ctx(cache, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="paged"):
        ex.model.verify_step(tparams, {
            "tokens": torch.zeros((2, 2), dtype=torch.int32),
            "pos0": torch.zeros((2, 1), dtype=torch.int32)}, cache)
    with pytest.raises(ValueError, match="dense"):
        ex.make_block_table()
    with pytest.raises(ValueError, match="block table"):
        ex.decode(np.zeros((2, 1), np.int32), np.zeros((2, 1), np.int32),
                  np.zeros(2, bool), cache, np.zeros((2, 1), np.int32))
    # init_cache resets the slab in place: zeros, k_pos -1
    cache.kv[0]["k"].fill_(3.0)
    cache.kv[0]["k_pos"].fill_(5)
    again = ex.init_cache()
    assert again is cache and not cache.kv[0]["k"].any()
    assert (cache.kv[0]["k_pos"] == -1).all()


def test_cli_path_serves_dense_on_cpu():
    args = argparse.Namespace(
        arch="qwen3-8b", reduced=True, n_layers=0, quant="psi8",
        quant_policy=None, requests=4, max_batch=2, arrival_rate=1e9,
        max_new=4, min_new=1, prompt_len=10, prompt_jitter=2, block_size=0,
        cache_blocks=None, eos_id=-1, seed=0, device="cpu",
        cache_layout="dense")
    server, cfg = tserve.build_server(args)
    assert not server.paged and server.max_seq % cfg.cache_block_size == 0
    done_c, sc = server.serve(tserve.trace_from_args(args, cfg))
    done_s, ss = server.serve(tserve.trace_from_args(args, cfg),
                              continuous=False)
    assert _toks(done_c) == _toks(done_s)
    assert sc["cache_layout"] == ss["cache_layout"] == "dense"
    assert ss["prefill_forwards"] < sc["n_requests"]   # static: bursts
