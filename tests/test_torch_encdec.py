"""The port's encoder-decoder (whisper-base) against the JAX package's, at
the reduced size (2 encoder layers over 16 frames, 2 decoder layers,
d_model 64, 4 heads of 16, 2 kv heads).

Config fields equal the JAX registry's, full and reduced; the port's init
draws the JAX init's leaves and shapes (LayerNorm biases, ``norm_x`` /
``xattn``, the encoder's blocks, ``enc_norm_f``, no ``lm_head``);
LayerNorm in float32 within 1e-6 and in bfloat16 within one bf16 ulp of
``repro.models.layers.apply_norm``; the sinusoidal tables within 1e-6 of
the reference's plus two f32 ulps of the angle (XLA's sin / cos of a
large angle);
``apply_rope`` the identity for "sinusoidal" and "none"; the encoder
output and a prefill's logits within 1e-4 of the reference's ``prefill``
with ``frames`` (random frames and the serving path's zeros), and decode
logits too, an inactive row's KV untouched; interop's encoder order,
``enc_norm_f`` and codes bit-equal; the ``Server``'s greedy tokens and
timing-free integer stats (``prefill_forwards`` included) equal the JAX
``Server``'s continuous, static with prompts of unequal lengths (one
forward a request) and at horizon 4, at psi8 and psi5; the paged layout
and the context-serving and speculative paths refused by both packages
with one message.  Params come from the JAX package's ``init`` (jitted) +
``quantize``, carried across by interop.
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
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

ARCH = "whisper-base"
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
# sinusoidal rows, f32 (|values| <= 1): both packages form the same f32
# angle pos x freq, but XLA's sin / cos reduce a large angle less exactly
# than torch's, as if the angle were an ulp off: 1e-6 plus two f32 ulps of
# the angle (2^-22 pos)
SIN_TOL = 1e-6
SIN_ULP = 2.0 ** -22
# prompts of 11-13 tokens (three prefill shapes of the JAX package's to
# compile), 2-8 new ones
TRACE = dict(rate_rps=1e9, prompt_len=12, max_new=8, min_new=2,
             vocab_size=256, seed=3, prompt_jitter=1)
INT_STATS = ("n_requests", "tokens", "decode_steps", "host_syncs",
             "prefill_forwards", "prefilled_tokens", "peak_concurrency")
ATTN = ("wq", "wk", "wv", "wo")


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


_SETUPS = {}
_FLOATS = {}


def _floats(cfg):
    """The JAX init's float params (one jitted draw, shared by every
    width)."""
    if not _FLOATS:
        _FLOATS[0] = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(1))
    return _FLOATS[0]


def _setup(bits=8):
    """(JAX cfg, JAX params, port cfg, port params) at the reduced size,
    quantized at psi``bits`` (packed below 8)."""
    if bits not in _SETUPS:
        over = dict(quant_mode=f"psi{bits}")
        cfg = reduced_config(get_config(ARCH), **over)
        tcfg = tconfigs.reduced_config(tconfigs.get_config(ARCH), **over)
        params = build_model(cfg).quantize(_floats(cfg), bits,
                                           pack=bits < 8)
        _SETUPS[bits] = (cfg, params, tcfg,
                         params_from_numpy(np_tree(params), device="cpu"))
    return _SETUPS[bits]


def _index(tree, i):
    """Entry ``i`` of a stacked JAX subtree (QuantizedTensor leaves
    included)."""
    def one(a):
        if isinstance(a, QuantizedTensor):
            return QuantizedTensor(a.data[i], a.scale[i], a.fmt, a.packed)
        return a[i]
    return jax.tree_util.tree_map(
        one, tree, is_leaf=lambda x: isinstance(x, QuantizedTensor))


def _shapes(tree):
    """{path: shape} of a param tree, JAX or port."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            out[path] = tuple(node.shape)
    walk(tree, "")
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    want, got = get_config(ARCH), tconfigs.get_config(ARCH)
    if reduced:
        want, got = reduced_config(want), tconfigs.reduced_config(got)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert not got.paged_capable and not want.paged_capable
    assert got.resolved_cache_layout == want.resolved_cache_layout == "dense"
    assert not got.is_attention_free
    assert ttransformer.layer_kinds(got) == jtransformer.layer_kinds(want)
    assert (got.n_enc_layers, got.enc_frames) == (
        (2, 16) if reduced else (6, 1500))


def test_param_specs_match_jax_tree():
    """The port's float init has the JAX init's leaves at its shapes,
    layer by layer and encoder block by block, LayerNorm biases zeros."""
    cfg, _, tcfg, _ = _setup()
    jp = _floats(cfg)
    tp = tbuild_model(tcfg).init(seed=0, device="cpu")
    assert set(tp) == set(jp) - {"stack"} | {"layers"}
    assert "lm_head" not in tp
    for i, layer in enumerate(tp["layers"]):
        want = _index(jp["stack"]["groups"]["b0_xattn"], i)
        assert _shapes(layer) == _shapes(want)
    for i, block in enumerate(tp["encoder"]):
        assert _shapes(block) == _shapes(_index(jp["encoder"], i))
    assert _shapes(tp["enc_norm_f"]) == _shapes(jp["enc_norm_f"])
    assert torch.equal(tp["layers"][0]["norm_x"]["bias"],
                       torch.zeros(tcfg.d_model))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """f32 statistics, then ``(x - mu) * inv * scale + bias`` rounded in
    the activation dtype step by step, in both packages."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(ARCH)), dtype=dtype)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.apply_norm({"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)},
                              jnp.asarray(x).astype(jd), cfg)
    got = tlayers.apply_norm({"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)},
                             torch.from_numpy(x).to(td), tcfg)
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    # bf16: one ulp of the value (2^-7 relative at worst) for a rounding
    # that lands on the other side
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(want) + 1e-6
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("D", [64, 512])
def test_sinusoidal_matches_jax(D):
    pos = np.array([[0, 1, 7, 1499], [3, 100, 511, 20]], np.int32)
    want = jlayers.sinusoidal_from_positions(jnp.asarray(pos), D)
    got = tlayers.sinusoidal_from_positions(torch.from_numpy(pos), D)
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.all(err <= SIN_TOL + SIN_ULP * pos[..., None])
    table = tlayers.sinusoidal_embedding(16, D, offset=3)
    np.testing.assert_allclose(
        table.numpy(), np.asarray(jlayers.sinusoidal_embedding(16, D, 3)),
        rtol=0, atol=SIN_TOL + SIN_ULP * 19)
    bf = tlayers.sinusoidal_from_positions(torch.from_numpy(pos), D,
                                           torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("rope", ["sinusoidal", "none"])
def test_apply_rope_is_identity(rope):
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(ARCH)), rope=rope)
    x = torch.randn(2, 3, 4, 16)
    assert tlayers.apply_rope(x, torch.zeros(2, 3, dtype=torch.int32),
                              tcfg) is x


@pytest.mark.parametrize("frames", ["random", "zeros"])
def test_prefill_and_decode_match_jax(frames):
    """A batch-2 prefill of 9 tokens over ``frames``: the encoder output
    and the logits within 1e-4 of the reference's; then 3 decode steps on
    a 3-slot cache holding both rows (slot 2 empty), row 1 inactive on the
    second: logits within 1e-4, the inactive row's KV and ``enc_out``
    untouched."""
    cfg, params, tcfg, tparams = _setup()
    jm, tm = build_model(cfg), tbuild_model(tcfg)
    rng = np.random.default_rng(0)
    fr = (rng.standard_normal((2, cfg.enc_frames, cfg.d_model))
          .astype(np.float32) if frames == "random"
          else np.zeros((2, cfg.enc_frames, cfg.d_model), np.float32))
    toks = rng.integers(0, 256, size=(2, 9)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(fr)}, cache_len=16)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), cache_len=16,
                        frames=torch.from_numpy(fr))
    np.testing.assert_allclose(tc.enc_out.numpy(), np.asarray(jc.enc_out),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    if frames == "zeros":             # the serving path's default
        zl, _ = tm.prefill(tparams, torch.from_numpy(toks), cache_len=16)
        assert torch.equal(zl, tl)
    cache = tm.init_cache(3, 16, device="cpu")
    assert cache.enc_out.shape == (3, cfg.enc_frames, cfg.d_model)
    for row in range(2):
        tm.insert_cache(cache, tm.slice_cache(tc, row), row)
    assert torch.equal(cache.enc_out[:2], tc.enc_out)
    for step in range(3):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        pos = np.full((2, 1), 9 + step, np.int32)
        active = np.array([True, step != 1])
        before = [{k: v.clone() for k, v in layer.items()}
                  for layer in cache.kv]
        enc_before = cache.enc_out.clone()
        jl, jc = jm.decode_step(params, {
            "token": jnp.asarray(tok), "pos": jnp.asarray(pos),
            "active": jnp.asarray(active)}, jc)
        pad = lambda a, v: np.concatenate([a, np.full_like(a[:1], v)])
        tl, cache = tm.decode_step(tparams, {
            "token": torch.from_numpy(pad(tok, 0)),
            "pos": torch.from_numpy(pad(pos, 0)),
            "active": torch.from_numpy(pad(active, False))}, cache)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        assert torch.equal(cache.enc_out, enc_before)
        for i, layer in enumerate(cache.kv):
            for k, v in layer.items():
                assert torch.equal(v[2], before[i][k][2]), (i, k)
                if not active[1]:
                    assert torch.equal(v[1], before[i][k][1]), (i, k)


@pytest.mark.parametrize("bits", [8, 5])
def test_interop_encoder_order_and_leaves(bits):
    """Encoder block i of the port is entry i of the stacked JAX encoder,
    decoder layer i entry i of ``b0_xattn``: codes (planes at psi5) and
    scales bit-equal, LayerNorm scales and biases exact; ``enc_norm_f``
    carried; no ``lm_head`` (tied)."""
    cfg, params, tcfg, tparams = _setup(bits)
    assert len(tparams["encoder"]) == cfg.n_enc_layers == 2
    pairs = ([(b, _index(params["encoder"], i))
              for i, b in enumerate(tparams["encoder"])]
             + [(layer, _index(params["stack"]["groups"]["b0_xattn"], i))
                for i, layer in enumerate(tparams["layers"])])
    for got, want in pairs:
        assert set(got) == set(want)
        for sub in ("attn", "xattn"):
            for name in ATTN if sub in got else ():
                g, w = got[sub][name], want[sub][name]
                assert isinstance(g, tpsi.QuantizedTensor)
                assert g.packed == (bits < 8)
                np.testing.assert_array_equal(g.data.numpy(),
                                              np.asarray(w.data))
                np.testing.assert_array_equal(g.scale.numpy(),
                                              np.asarray(w.scale))
        for norm in ("norm1", "norm2", "norm_x"):
            for k in ("scale", "bias") if norm in got else ():
                np.testing.assert_array_equal(got[norm][k].numpy(),
                                              np.asarray(want[norm][k]))
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(tparams["enc_norm_f"][k].numpy(),
                                      np.asarray(params["enc_norm_f"][k]))
    assert "lm_head" not in tparams and "lm_head" not in params


# ---------------------------------------------------------------------------
# The Server against the JAX Server, and the refusals.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,horizon", [(8, 1), (8, 4), (5, 1)])
def test_server_matches_jax(bits, horizon, monkeypatch):
    """Continuous, then static on the same two servers (one JAX compile
    of each shape); static admits prompts of unequal lengths at once,
    which prefill one by one in both packages."""
    cfg, params, tcfg, tparams = _setup(bits)
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
        assert ts["cache_bytes"] == js["cache_bytes"]    # enc_out counted
    lens = [len(r.prompt) for r in tdone]
    assert len(set(lens)) > 1                      # prompts of unequal length
    assert max(forwards) == 1                      # ... prefilled one by one
    assert ts["prefill_forwards"] == len(lens)     # ... in static mode too


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
    cfg, params, tcfg, tparams = _setup()
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
