"""The port's other dense configs against the JAX package: phi3-medium-14b
(plain RoPE, no qk-norm), granite-34b (2-matrix GELU MLP, one kv head)
and chatglm3-6b (2-D RoPE), at the reduced sizes.

Config fields equal the JAX registry's; the GELU MLP and the 2-D RoPE
within 1e-6 in float32 (tight enough that torch's exact erf GELU fails
where the JAX package's tanh form is the spec); prefill and decode logits
within 1e-4 at psi8 and packed psi5; the ``Server``'s greedy tokens and
timing-free integer stats equal the JAX ``Server``'s, continuous and
static; a horizon-4 and a ``--speculative 3:4`` serve of granite; and the
context-serving flags refused for 2-D RoPE in both packages.  Params come
from the JAX package's ``init`` + ``quantize``, carried across by interop.
"""
import argparse
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import quantizer as jquant
from repro.core.psi import QuantizedTensor
from repro.launch import scheduler as jsched
from repro.launch.serve import Server as JServer
from repro.launch.slo import parse_slo_spec as jparse_slo
from repro.models import build_model
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as tlayers
from repro_torch.models.kvcache import KVCache

torch.set_num_threads(1)

ARCHS = ["phi3-medium-14b", "granite-34b", "chatglm3-6b"]
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
TIGHT = 1e-6                # one layer in f32: a few ulp of O(1) values
TRACE = dict(rate_rps=1e9, prompt_len=12, max_new=6, min_new=2,
             vocab_size=256, seed=3, prompt_jitter=4)
# the stats that do not depend on the clock
INT_STATS = ("n_requests", "tokens", "decode_steps", "host_syncs",
             "blocks_free_end", "prefilled_tokens", "prefill_forwards")


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


_FLOATS, _SETUPS = {}, {}


def _floats(arch):
    """(JAX cfg, JAX float params) of the reduced arch, drawn once."""
    if arch not in _FLOATS:
        cfg = reduced_config(get_config(arch))
        _FLOATS[arch] = cfg, build_model(cfg).init(jax.random.PRNGKey(0))
    return _FLOATS[arch]


def _setup(arch, bits, qat=0):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced arch,
    quantized at ``bits`` (psi5 bit-plane packed), after a QAT snap to
    psi``qat`` when ``qat``; built once per module."""
    key = (arch, bits, qat)
    if key not in _SETUPS:
        cfg, params = _floats(arch)
        model = build_model(cfg)
        if qat:
            params = jquant.fake_quant_param_tree(params, qat)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params = model.quantize(params, bits, pack=bits < 8)
        mode = f"psi{bits}"
        tcfg = tconfigs.reduced_config(tconfigs.get_config(arch),
                                       quant_mode=mode)
        _SETUPS[key] = (dataclasses.replace(cfg, quant_mode=mode), params,
                        tcfg, params_from_numpy(np_tree(params),
                                                device="cpu"))
    return _SETUPS[key]


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    """Every field the port keeps equals the JAX registry's, full and
    reduced (granite keeps its one kv head: MQA with a group of 4)."""
    for full in (True, False):
        want = get_config(arch)
        got = tconfigs.get_config(arch)
        if not full:
            want, got = reduced_config(want), tconfigs.reduced_config(got)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.resolved_head_dim == want.resolved_head_dim
        assert got.resolved_cache_layout == want.resolved_cache_layout
    red = tconfigs.reduced_config(tconfigs.get_config(arch))
    assert red.n_heads % red.n_kv_heads == 0
    if arch == "granite-34b":
        assert (red.n_kv_heads, red.act) == (1, "gelu")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_tree(arch):
    """The port's init draws the JAX init's leaves and shapes: no w_gate
    for the 2-matrix GELU MLP; the quantizer takes both of its matrices."""
    cfg, jp = _floats(arch)
    g = jp["stack"]["groups"]["b0_attn"]
    tm = tbuild_model(tconfigs.reduced_config(tconfigs.get_config(arch)))
    tp = tm.init(seed=0, device="cpu", bits=5, pack=True)
    layer = tp["layers"][0]
    assert set(layer["mlp"]) == set(g["mlp"])
    assert ("w_gate" in layer["mlp"]) == (cfg.act != "gelu")
    for name, leaf in layer["mlp"].items():
        assert tuple(leaf.shape) == tuple(g["mlp"][name].shape[1:]), name
        assert leaf.fmt.bits == 5 and leaf.packed, name
    assert set(layer["attn"]) == set(g["attn"])
    assert len(tp["layers"]) == cfg.n_layers


# ---------------------------------------------------------------------------
# The new layers: GELU MLP and 2-D RoPE.
# ---------------------------------------------------------------------------
def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the exact erf form
    differs by up to ~5e-4 over [-4, 4], far outside the tolerance."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIGHT)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 100 * TIGHT


@pytest.mark.parametrize("act", ["gelu", "geglu", "swiglu"])
def test_apply_mlp_matches_jax(act):
    """The MLP of a reduced granite (float weights) under each activation,
    on O(1) activations: within 1e-6 of the JAX package's."""
    cfg = dataclasses.replace(reduced_config(get_config("granite-34b")),
                              act=act)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("granite-34b")), act=act)
    p = jlayers.init_mlp(cfg, jax.random.PRNGKey(7))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(1).normal(
        size=(3, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(p, jnp.asarray(x), cfg))
    got = tlayers.apply_mlp(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIGHT)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("arch", ["chatglm3-6b", "phi3-medium-14b"])
def test_apply_rope_matches_jax(arch):
    """rope2d (chatglm3) and plain rope (phi3) on (B, S, H, D) at
    positions up to 2000, within 1e-6; rope2d leaves the second half of
    the head dims untouched."""
    cfg = reduced_config(get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, cfg.resolved_head_dim)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(2, 7)).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         cfg))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIGHT)
    half = x.shape[-1] // 2
    if cfg.rope == "rope2d":
        np.testing.assert_array_equal(got[..., half:], x[..., half:])
    assert np.abs(got[..., :half] - x[..., :half]).max() > 0.1


# ---------------------------------------------------------------------------
# Prefill and decode logits.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 5], ids=["psi8", "psi5-packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, bits):
    """Right-padded prompts prefilled, inserted into the paged pool, then
    two decode steps: logits within 1e-4 at every step."""
    jcfg, jp, tcfg, tp = _setup(arch, bits)
    jm, tm = build_model(jcfg), tbuild_model(tcfg)
    rng = np.random.default_rng(1)
    B, S, n_bt, bs = 2, 16, 4, 16
    tl = np.array([13, 9], np.int32)
    toks = np.zeros((B, S), np.int32)
    for b in range(B):
        toks[b, :tl[b]] = rng.integers(0, 256, size=tl[b])
    feed = rng.integers(0, 256, size=(2, B)).astype(np.int32)
    bt = np.array([[3, 0, -1, -1], [1, 5, -1, -1]], np.int32)
    jl, jseq = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                                  true_lens=n))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    tlog, tseq = tm.prefill(tp, torch.from_numpy(toks),
                            true_lens=torch.from_numpy(tl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    jcache = jm.init_cache(B, n_bt * bs, dtype=jnp.float32, layout="paged",
                           block_size=bs, n_blocks=8)
    tcache = tm.init_cache(B, n_bt * bs, device="cpu", block_size=bs,
                           n_blocks=8)
    for b in range(B):
        jcache = jm.insert_cache(jcache, jm.slice_cache(jseq, b), b,
                                 block_row=jnp.asarray(bt[b]))
        row = KVCache([{k: t[b:b + 1] for k, t in layer.items()}
                       for layer in tseq.kv])
        tcache = tm.insert_cache(tcache, row, b, torch.from_numpy(bt[b]))
    assert tuple(tcache.kv[0]["k"].shape[2:]) == (
        tcfg.n_kv_heads, tcfg.resolved_head_dim)
    jdecode = jax.jit(jm.decode_step)
    pos = tl.copy()
    for step in range(2):
        batch = {"token": feed[step][:, None], "pos": pos[:, None],
                 "active": np.array([True, True]), "block_table": bt}
        jl, jcache = jdecode(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
        tlog, tcache = tm.decode_step(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"decode step {step}")
        pos += 1


# ---------------------------------------------------------------------------
# The Server against the JAX Server.
# ---------------------------------------------------------------------------
_SERVERS = {}


@pytest.mark.parametrize("mode", ["continuous", "static"])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax(arch, mode):
    """The same trace through both engines at psi8: identical greedy tokens
    and equal integer stats; no block leaks."""
    if arch not in _SERVERS:                  # one compile set per arch
        jcfg, jp, tcfg, tp = _setup(arch, 8)
        _SERVERS[arch] = (JServer(jcfg, jp, max_batch=2, max_seq=48),
                          tserve.Server(tcfg, tp, max_batch=2, max_seq=48,
                                        device="cpu"))
    jserver, tserver = _SERVERS[arch]
    cont = mode == "continuous"
    jdone, js = jax_serve(jserver, jsched.poisson_trace(4, **TRACE),
                          continuous=cont)
    tdone, ts = tserver.serve(tsched.poisson_trace(4, **TRACE),
                              continuous=cont)
    assert _toks(tdone) == _toks(jdone)
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert ts["blocks_free_end"] == ts["n_blocks"]
    assert all(len(r.tokens) == r.max_new for r in tdone)


@pytest.mark.parametrize("how", ["horizon4", "spec3:4"])
def test_granite_multi_token_serve_matches_jax(how):
    """Reduced granite (MQA, GELU) at packed psi5 after a QAT snap to
    psi3: a horizon-4 serve and a --speculative 3:4 serve against the JAX
    Server's, tokens and integer stats equal, and tokens equal the port's
    plain decode."""
    jcfg, jp, tcfg, tp = _setup("granite-34b", 5, qat=3)
    kw = ({"decode_horizon": 4} if how == "horizon4"
          else {"speculative": (3, 4)})
    jdone, js = jax_serve(JServer(jcfg, jp, max_batch=2, max_seq=48, **kw),
                          jsched.poisson_trace(4, **TRACE))
    tdone, ts = tserve.Server(tcfg, tp, max_batch=2, max_seq=48,
                              device="cpu", **kw).serve(
        tsched.poisson_trace(4, **TRACE))
    plain, _ = tserve.Server(tcfg, tp, max_batch=2, max_seq=48,
                             device="cpu").serve(
        tsched.poisson_trace(4, **TRACE))
    assert _toks(tdone) == _toks(jdone) == _toks(plain)
    for k in ("tokens", "decode_steps", "host_syncs", "blocks_free_end",
              "prefill_forwards"):
        assert ts[k] == js[k], k
    if how == "horizon4":
        assert ts["decode_rounds"] == js["decode_rounds"] > 0
    else:
        for k in ("rounds", "accepted_draft_tokens"):
            assert ts["speculative"][k] == js["speculative"][k], k
        assert ts["speculative"]["mean_accepted"] > 1


@pytest.mark.parametrize("flag", ["prefix_cache", "slo", "prefill_chunk"])
def test_context_serving_refused_for_rope2d(flag):
    """chatglm3's 2-D RoPE: the prefix cache, --slo and --prefill-chunk
    replay positions from a scalar offset, so both packages refuse them."""
    jcfg, jp, tcfg, tp = _setup("chatglm3-6b", 8)
    kw = {}
    if flag == "prefix_cache":
        jcfg = dataclasses.replace(jcfg, prefix_cache=True)
        tcfg = dataclasses.replace(tcfg, prefix_cache=True)
    elif flag == "slo":
        kw = {"slo": "default"}
    else:
        kw = {"prefill_chunk": 16}
    jkw = dict(kw)
    if flag == "slo":
        jkw["slo"] = jparse_slo("default")
        kw["slo"] = tserve.parse_slo_spec("default")
    with pytest.raises(ValueError, match="RoPE"):
        JServer(jcfg, jp, max_batch=2, max_seq=48, **jkw)
    with pytest.raises(ValueError, match="RoPE"):
        tserve.Server(tcfg, tp, max_batch=2, max_seq=48, device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_each_arch(arch):
    """The CLI's path (build_server: random weights drawn leaf by leaf on
    the CPU) serves each reduced arch in both modes with equal tokens."""
    args = argparse.Namespace(
        arch=arch, reduced=True, n_layers=0, quant="psi8", quant_policy=None,
        requests=3, max_batch=2, arrival_rate=1e9, max_new=4, min_new=2,
        prompt_len=10, prompt_jitter=2, block_size=0, cache_blocks=None,
        eos_id=-1, seed=0, device="cpu")
    server, cfg = tserve.build_server(args)
    assert cfg.name == arch
    done_c, sc = server.serve(tserve.trace_from_args(args, cfg))
    done_s, _ = server.serve(tserve.trace_from_args(args, cfg),
                             continuous=False)
    assert _toks(done_c) == _toks(done_s)
    assert sc["n_requests"] == 3 and sc["blocks_free_end"] == sc["n_blocks"]


def test_granite_suffix_prefill_over_one_kv_head():
    """The prefix cache's path with one kv head: a prompt's first 32
    tokens prefilled and scattered into the pool, the rest prefilled over
    the context gathered back (``gather_paged_ctx``, pools (N, bs, 1, D)),
    gives the whole prompt's last logits and suffix K/V within 1e-5."""
    _, _, tcfg, tp = _setup("granite-34b", 8)
    tm = tbuild_model(tcfg)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, size=(1, 40)).astype(np.int32))
    with torch.inference_mode():
        want, wseq = tm.prefill(tp, prompt)
        cache = tm.init_cache(1, 64, device="cpu", n_blocks=4)
        row = torch.arange(4)
        _, seq = tm.prefill(tp, prompt[:, :32])
        tm.insert_cache(cache, seq, 0, row)
        ctx = tm.gather_prefix_ctx(cache, row[:2])
        assert tuple(ctx[0]["k"].shape) == (1, 32, 1, tcfg.resolved_head_dim)
        got, gseq = tm.prefill(tp, prompt[:, 32:], pos0=32, ctx_kv=ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    for a, b in zip(gseq.kv, wseq.kv):
        for k in ("k", "v"):
            np.testing.assert_allclose(a[k].numpy(), b[k][:, 32:].numpy(),
                                       rtol=0, atol=1e-5)
