"""The port's VLM backbone (qwen2-vl-2b) against the JAX package's, at the
reduced size.

Config fields equal the JAX registry's, full and reduced; M-RoPE with
distinct (t, h, w) streams within 1e-6 of ``repro.models.layers.
apply_rope`` in float32, and with three equal streams bit-equal to plain
RoPE; a prefill with spliced vision embeddings and distinct streams within
1e-4 of the reference's logits, its cache too; the tied lm-head built once
(``Model.serving_params``) bit-equal to ``codes.t()`` and its logits equal
to the per-call transpose's, and no ``lm_head`` in the carried tree; the
``Server``'s greedy tokens and timing-free integer stats equal the JAX
``Server``'s continuous, static, at horizon 4 and on the dense layout; the
refusals of speculative decoding, the prefix cache, SLO scheduling and
chunked prefill for M-RoPE, made by both packages with one message.
Params come from the JAX package's ``init`` + ``quantize`` at psi8,
carried across by interop.
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
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as tlayers
from repro_torch.quant import tied_head

torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
ROPE_TOL = 1e-6
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


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              quant_mode="psi8")
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(ARCH)),
        quant_mode="psi8")
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    return cfg, params, tcfg, params_from_numpy(np_tree(params),
                                                device="cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    want, got = get_config(ARCH), tconfigs.get_config(ARCH)
    if reduced:
        want, got = reduced_config(want), tconfigs.reduced_config(got)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.paged_capable == want.paged_capable
    assert got.resolved_cache_layout == want.resolved_cache_layout == "paged"


# ---------------------------------------------------------------------------
# M-RoPE.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [16, 128])
def test_mrope_distinct_streams_match_jax(D):
    """Three different streams (t, h, w), f32: within 1e-6 of the
    reference; the section split is 2:1:1 of the D/2 frequencies."""
    cfg = tconfigs.get_config(ARCH)
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, 900, size=(2, 3, 7)).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         get_config(ARCH)))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_TOL)
    # only the w stream moves the last quarter of the frequencies
    moved = pos.copy()
    moved[:, 2] += 5
    other = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(moved),
                               cfg).numpy()
    nf = D // 2
    same = np.r_[0:nf // 2 + nf // 4, nf:nf + nf // 2 + nf // 4]
    np.testing.assert_array_equal(other[..., same], got[..., same])
    assert not np.array_equal(other, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_equal_streams_is_rope(dtype):
    """Serving's three equal streams: bit-equal to plain RoPE."""
    cfg = tconfigs.get_config(ARCH)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 4, 128, generator=g).to(dtype)
    pos = torch.randint(0, 5000, (2, 9), generator=g, dtype=torch.int32)
    got = tlayers.apply_rope(x, pos[:, None].expand(2, 3, 9), cfg)
    want = tlayers.apply_rope(x, pos, dataclasses.replace(cfg, rope="rope"))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The vision-embed splice, the tied head.
# ---------------------------------------------------------------------------
def test_prefill_with_vision_embeds_matches_jax(setup):
    """8 spliced patch embeddings and distinct (t, h, w) streams (the
    patches on a 2 x 4 grid at t = 0, text after them on all three):
    last logits within 1e-4 of the reference's, cache within 1e-5."""
    cfg, params, tcfg, tparams = setup
    rng = np.random.default_rng(4)
    B, S, P = 2, 20, cfg.vision_patches
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    vis = (rng.standard_normal((B, P, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.zeros((B, 3, S), np.int32)
    pos[:, 1, :P] = np.arange(P) // 4
    pos[:, 2, :P] = np.arange(P) % 4
    pos[:, :, P:] = np.arange(S - P) + 4
    jl, jc = build_model(cfg).prefill(
        params, {"tokens": jnp.asarray(toks), "vision_embeds":
                 jnp.asarray(vis), "positions": jnp.asarray(pos)})
    tl, tc = tbuild_model(tcfg).prefill(
        tparams, torch.from_numpy(toks), positions=torch.from_numpy(pos),
        vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    g = jc.kv[0]["b0"]
    for i, layer in enumerate(tc.kv):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(g[name][i]), rtol=0,
                                       atol=1e-5)
        np.testing.assert_array_equal(layer["k_pos"].numpy(),
                                      np.asarray(g["k_pos"][i]))
    # without the splice the logits move
    plain, _ = tbuild_model(tcfg).prefill(tparams, torch.from_numpy(toks),
                                          positions=torch.from_numpy(pos))
    assert not torch.allclose(plain, tl)


def test_vision_embeds_refused_outside_vlm(setup):
    _, _, tcfg, tparams = setup
    model = tbuild_model(dataclasses.replace(tcfg, family="dense"))
    with pytest.raises(ValueError, match="vlm"):
        model.prefill(tparams, torch.zeros((1, 12), dtype=torch.int32),
                      vision_embeds=torch.zeros((1, 4, tcfg.d_model)))


def test_tied_head_built_once(setup):
    """The carried tree has no lm_head; ``serving_params`` adds the (D, V)
    head once, bit-equal to ``codes.t()``, and the logits through it equal
    the per-call transpose's exactly."""
    _, params, tcfg, tparams = setup
    assert "lm_head" not in params and "lm_head" not in tparams
    model = tbuild_model(tcfg)
    sp = model.serving_params(tparams)
    assert "tied_head" not in tparams and sp["embed"] is tparams["embed"]
    head = sp["tied_head"]
    assert torch.equal(head.data, tparams["embed"].codes.t())
    assert head.data.is_contiguous()
    assert torch.equal(head.scale, tparams["embed"].scale.reshape(-1))
    assert torch.equal(tied_head(tparams["embed"]).data, head.data)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, size=(2, 16)).astype(np.int32))
    a, _ = model.forward(tparams, toks)
    b, _ = model.forward(sp, toks)
    assert torch.equal(a, b)
    assert model.serving_params(sp) is sp            # built once


# ---------------------------------------------------------------------------
# The Server against the JAX Server, and the refusals.
# ---------------------------------------------------------------------------
SERVES = {
    # label: (config overrides, Server kwargs, continuous)
    "continuous": ({}, {}, True),
    "static": ({}, {}, False),
    "horizon-4": ({}, {"decode_horizon": 4}, True),
    "dense": ({"cache_layout": "dense"}, {}, True),
}


@pytest.mark.parametrize("case", list(SERVES))
def test_server_matches_jax(setup, case):
    over, kw, continuous = SERVES[case]
    cfg, params, tcfg, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, **over) for c in (cfg, tcfg))
    jdone, js = jax_serve(JServer(cfg, params, max_batch=3, max_seq=48,
                                  **kw),
                          jsched.poisson_trace(7, **TRACE),
                          continuous=continuous)
    server = tserve.Server(tcfg, tparams, max_batch=3, max_seq=48,
                           device="cpu", **kw)
    tdone, ts = server.serve(tsched.poisson_trace(7, **TRACE),
                             continuous=continuous)
    assert _toks(tdone) == _toks(jdone)
    for k in INT_STATS:
        assert ts[k] == js[k], k
    assert ts["cache_layout"] == js["cache_layout"]
    if ts["cache_layout"] == "paged":
        assert ts["blocks_free_end"] == js["blocks_free_end"] == \
            ts["n_blocks"]
    assert "tied_head" in server.executor.params


REFUSALS = {
    "speculative": ({}, {"speculative": (3, 4)}),
    "prefix-cache": ({"prefix_cache": True}, {}),
    "slo": ({}, {"slo": "default"}),
    "prefill-chunk": ({}, {"prefill_chunk": 16}),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_mrope_refusals_match_jax(setup, what):
    over, kw = REFUSALS[what]
    cfg, params, tcfg, tparams = setup
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
    assert "mrope" in str(got.value)
