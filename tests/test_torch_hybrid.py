"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package's,
at the reduced size: 3 layers (one scanned (rec, rec, attn) group, no
tail), and 5 layers (one group and a tail of two rec layers, the layout
full width has at 12 groups) through a ``reduced_config`` override on
both sides.

Config fields equal the JAX registry's, full, reduced and at 5 layers;
``rglru_block`` (with and without a carried ``h``), ``rglru_decode_step``
and ``_freeze_inactive_state`` against the reference, state ``h`` and
``conv`` within 1e-5 and outputs within 1e-5 in float32; the rec codes
and scales bit-equal, the f32 leaves (``conv1d_*``, biases,
``rglru_lambda``) passed through exactly; interop's order of groups and
tail; prefill and decode logits within 1e-4; the ``Server``'s greedy
tokens and timing-free integer stats (``prefill_forwards`` included)
equal the JAX ``Server``'s continuous, static with prompts of unequal
lengths (one forward a request) and at horizon 4, on a 32-position ring
that wraps; the paged layout and the context-serving and speculative
paths refused by both packages with one message.  Params come from the
JAX package's ``init`` + ``quantize`` at psi8, carried across by interop.
"""
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
from repro.models import build_model
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
STATE_TOL = 1e-5            # h and conv state, f32
# prompts of 25-28 tokens (each length a prefill shape of the JAX
# package's) and 6-10 new ones: a 32-position ring wraps
TRACE = dict(rate_rps=1e9, prompt_len=26, max_new=10, min_new=6,
             vocab_size=256, seed=3, prompt_jitter=2)
INT_STATS = ("n_requests", "tokens", "decode_steps", "host_syncs",
             "prefill_forwards", "prefilled_tokens", "peak_concurrency")
REC_F32 = ("conv1d_w", "conv1d_b", "rglru_ba", "rglru_bx", "rglru_lambda")
REC_PSI = ("w_in_rec", "w_in_gate", "rglru_wa", "rglru_wx", "w_out")


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
    """The JAX ``Server.serve`` with ``prefill_forwards``: its executor's
    prefill and prefill-insert calls after warmup."""
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


def _cfgs(n_layers):
    over = dict(quant_mode="psi8", n_layers=n_layers)
    return (reduced_config(get_config(ARCH), **over),
            tconfigs.reduced_config(tconfigs.get_config(ARCH), **over))


_SETUPS = {}


def _setup(n_layers):
    if n_layers not in _SETUPS:
        cfg, tcfg = _cfgs(n_layers)
        model = build_model(cfg)
        params = model.quantize(model.init(jax.random.PRNGKey(n_layers)), 8)
        _SETUPS[n_layers] = (cfg, params, tcfg, params_from_numpy(
            np_tree(params), device="cpu"))
    return _SETUPS[n_layers]


@pytest.mark.parametrize("n_layers", [0, 3, 5, 38])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced, n_layers):
    over = {"n_layers": n_layers} if n_layers else {}
    want, got = get_config(ARCH), tconfigs.get_config(ARCH)
    if reduced:
        want = reduced_config(want, **over)
        got = tconfigs.reduced_config(got, **over)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.resolved_d_rnn == want.resolved_d_rnn
    assert not got.paged_capable and not want.paged_capable
    assert got.resolved_cache_layout == want.resolved_cache_layout == "dense"
    assert ttransformer.layer_kinds(got) == jtransformer.layer_kinds(want)


# ---------------------------------------------------------------------------
# The rec block against the reference.
# ---------------------------------------------------------------------------
def _group(tree, g):
    """Group ``g`` of a scanned JAX subtree (QuantizedTensor leaves
    included)."""
    def one(a):
        if isinstance(a, QuantizedTensor):
            return QuantizedTensor(a.data[g], a.scale[g], a.fmt, a.packed)
        return a[g]
    return jax.tree_util.tree_map(
        one, tree, is_leaf=lambda x: isinstance(x, QuantizedTensor))


def _rec_params(n_layers=3, layer=0):
    """(JAX rec params of group 0's block ``b{layer}``, the port's)."""
    cfg, params, tcfg, tparams = _setup(n_layers)
    jp = _group(params["stack"]["groups"][f"b{layer}_rec"]["rec"], 0)
    return cfg, jp, tcfg, tparams["layers"][layer]["rec"]


@pytest.mark.parametrize("S", [1, 5, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_matches_jax(S, carried):
    cfg, jp, tcfg, tp = _rec_params()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((2, cfg.resolved_d_rnn)).astype(np.float32)
          if carried else None)
    jy, js = jrglru.rglru_block(
        jp, jnp.asarray(x), cfg,
        state=None if h0 is None else {"h": jnp.asarray(h0)})
    ty, ts = trglru.rglru_block(
        tp, torch.from_numpy(x), tcfg,
        state=None if h0 is None else {"h": torch.from_numpy(h0)})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(ts["h"].numpy(), np.asarray(js["h"]), rtol=0,
                               atol=STATE_TOL)
    want_conv = np.asarray(js["conv"])
    if S < cfg.ssm_conv - 1:      # the reference keeps only the S rows
        want_conv = np.concatenate([np.zeros(
            (2, cfg.ssm_conv - 1 - S, want_conv.shape[2]), np.float32),
            want_conv], 1)
    np.testing.assert_allclose(ts["conv"].numpy(), want_conv, rtol=0,
                               atol=STATE_TOL)
    assert ts["h"].dtype == ts["conv"].dtype == torch.float32


def test_scan_at_a_length_past_the_chunk():
    """S = 512 runs the reference's chunked scan over two chunks of 256;
    the port's doubling scan agrees within 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 1.0, (1, 512, 8)).astype(np.float32)
    b = rng.standard_normal((1, 512, 8)).astype(np.float32)
    h0 = rng.standard_normal((1, 8)).astype(np.float32)
    jh, jlast = jrglru._scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0))
    th, tlast = trglru._scan(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                               atol=STATE_TOL)


def test_rglru_decode_step_matches_jax():
    """Four decode steps from a prefill's state, each against the
    reference's step from the same (port) state."""
    cfg, jp, tcfg, tp = _rec_params()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    _, st = trglru.rglru_block(tp, torch.from_numpy(x), tcfg)
    for i in range(4):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, js = jrglru.rglru_decode_step(
            jp, jnp.asarray(xt), cfg,
            {k: jnp.asarray(v.numpy()) for k, v in st.items()})
        ty, st = trglru.rglru_decode_step(tp, torch.from_numpy(xt), tcfg, st)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=STATE_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(js[k]),
                                       rtol=0, atol=STATE_TOL)


def test_freeze_inactive_state_matches_jax():
    rng = np.random.default_rng(3)
    new = {"h": rng.standard_normal((4, 8)).astype(np.float32),
           "conv": rng.standard_normal((4, 3, 8)).astype(np.float32)}
    old = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in new.items()}
    active = np.array([True, False, False, True])
    want = jtransformer._freeze_inactive_state(
        {k: jnp.asarray(v) for k, v in new.items()},
        {k: jnp.asarray(v) for k, v in old.items()}, jnp.asarray(active))
    got = ttransformer._freeze_inactive_state(
        {k: torch.from_numpy(v) for k, v in new.items()},
        {k: torch.from_numpy(v) for k, v in old.items()},
        torch.from_numpy(active))
    for k in new:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    same = ttransformer._freeze_inactive_state(
        {k: torch.from_numpy(v) for k, v in new.items()}, None, None)
    assert all(torch.equal(same[k], torch.from_numpy(new[k])) for k in new)


# ---------------------------------------------------------------------------
# Interop: codes, f32 leaves, the order of groups and tail.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", [3, 5])
def test_interop_order_and_leaves(n_layers):
    """Layer i of the port is group i // 3's block b{i % 3} for the
    scanned groups, then the tail blocks in order: rec codes and scales
    bit-equal, f32 leaves exact, attention leaves where the kinds say."""
    cfg, params, tcfg, tparams = _setup(n_layers)
    kinds = ttransformer.layer_kinds(tcfg)
    layers = tparams["layers"]
    assert len(layers) == n_layers
    stack = params["stack"]
    assert len(stack["tail"]) == n_layers - 3
    want = [_group(stack["groups"][f"b{i}_{kind}"], 0)
            for i, kind in enumerate(cfg.block_pattern)] + list(stack["tail"])
    for i, (layer, ref, kind) in enumerate(zip(layers, want, kinds)):
        assert set(layer) == set(ref), i
        assert (kind in layer) and kind in ("rec", "attn"), i
        if kind != "rec":
            np.testing.assert_array_equal(layer["attn"]["wq"].data.numpy(),
                                          np.asarray(ref["attn"]["wq"].data))
            continue
        for name in REC_PSI:
            got, exp = layer["rec"][name], ref["rec"][name]
            assert isinstance(got, tpsi.QuantizedTensor), name
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(exp.data))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(exp.scale))
        for name in REC_F32:
            got = layer["rec"][name]
            assert isinstance(got, torch.Tensor) and got.dtype == \
                torch.float32, name
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(ref["rec"][name]))
        np.testing.assert_array_equal(layer["mlp"]["w_down"].data.numpy(),
                                      np.asarray(ref["mlp"]["w_down"].data))
    assert "lm_head" not in tparams               # tied


@pytest.mark.parametrize("n_layers", [3, 5])
def test_prefill_and_decode_match_jax(n_layers):
    """A batch-2 prefill of 20 tokens, then 3 decode steps with row 1
    inactive on the second: logits within 1e-4, rec state within 1e-5,
    and the inactive row's state frozen exactly."""
    cfg, params, tcfg, tparams = _setup(n_layers)
    jm, tm = build_model(cfg), tbuild_model(tcfg)
    rng = np.random.default_rng(n_layers)
    toks = rng.integers(0, 256, size=(2, 20)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    kinds = ttransformer.layer_kinds(tcfg)
    for step in range(3):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        pos = np.full((2, 1), 20 + step, np.int32)
        active = np.array([True, step != 1])
        before = [{k: v.clone() for k, v in layer.items()}
                  for layer in tc.kv]
        jl, jc = jm.decode_step(params, {
            "token": jnp.asarray(tok), "pos": jnp.asarray(pos),
            "active": jnp.asarray(active)}, jc)
        tl, tc = tm.decode_step(tparams, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
            "active": torch.from_numpy(active)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        g, tail = jc.kv
        for i, kind in enumerate(kinds):
            if kind != "rec":
                continue
            ref = (jax.tree_util.tree_map(lambda a: a[0], g[f"b{i}"])
                   if i < 3 else tail[i - 3])
            for k in ("h", "conv"):
                np.testing.assert_allclose(tc.kv[i][k].numpy(),
                                           np.asarray(ref[k]), rtol=0,
                                           atol=STATE_TOL)
                if not active[1]:
                    assert torch.equal(tc.kv[i][k][1], before[i][k][1])


# ---------------------------------------------------------------------------
# The Server against the JAX Server, and the refusals.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("n_layers", [3, 5])
def test_server_matches_jax(n_layers, horizon, monkeypatch):
    """Continuous, then static on the same two servers (one JAX compile
    of each shape), at horizon 1 and 4."""
    cfg, params, tcfg, tparams = _setup(n_layers)
    kw = {"decode_horizon": horizon}
    jserver = JServer(cfg, params, max_batch=3, max_seq=48, **kw)
    server = tserve.Server(tcfg, tparams, max_batch=3, max_seq=48,
                           device="cpu", **kw)
    forwards = []
    prefill = server.executor.prefill
    monkeypatch.setattr(server.executor, "prefill", lambda toks, *a, **k: (
        forwards.append(np.asarray(toks).shape[0]), prefill(toks, *a, **k))[1])
    for continuous in (True, False):
        jdone, js = jax_serve(jserver, jsched.poisson_trace(5, **TRACE),
                              continuous=continuous)
        tdone, ts = server.serve(tsched.poisson_trace(5, **TRACE),
                                 continuous=continuous)
        assert _toks(tdone) == _toks(jdone), continuous
        for k in INT_STATS:
            assert ts[k] == js[k], (continuous, k)
        assert ts["cache_layout"] == js["cache_layout"] == "dense"
    lens = [len(r.prompt) for r in tdone]
    assert len(set(lens)) > 1                      # prompts of unequal length
    assert max(forwards) == 1                      # ... prefilled one by one
    assert ts["prefill_forwards"] == len(lens)     # ... in static mode too
    assert any(len(r.prompt) + len(r.tokens) > tcfg.window for r in tdone)
    assert server._bucket_len(27) == 27            # exact-length prefill


REFUSALS = {
    "paged": ({"cache_layout": "paged"}, {}),
    "speculative": ({}, {"speculative": (3, 4)}),
    "prefix-cache": ({"prefix_cache": True}, {}),
    "slo": ({}, {"slo": "default"}),
    "prefill-chunk": ({}, {"prefill_chunk": 16}),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_match_jax(what):
    over, kw = REFUSALS[what]
    cfg, params, tcfg, tparams = _setup(3)
    cfg, tcfg = (dataclasses.replace(c, **over) for c in (cfg, tcfg))
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
