"""The port's MoE family against the JAX package: qwen3-moe-30b-a3b and
mixtral-8x22b at the reduced sizes.

Config fields equal the JAX registry's, full and reduced; ``_row_ranks``
on the reference's own case; ``moe_ffn``'s routing (the keep mask and the
slot of every token and top-k slot) equal to the reference's exactly, its
output within 1e-5 and its aux loss within 1e-6 in float32, at capacity
factors 8 and 1 and capacity overrides 1 and 64, on float leaves and at
psi8 and packed psi5; the expert codes, planes and scales bit-equal to
the JAX quantizer's, and a draft view of a 3-D leaf too; prefill and
decode logits within 1e-4; the ``Server``'s greedy tokens and timing-free
integer stats equal the JAX ``Server``'s on reduced qwen3-moe at capacity
factor 1 (where tokens drop) in seven setups, and on reduced mixtral on an
SWA ring; the paged layout refused for mixtral in both packages.  Params
come from the JAX package's ``init`` + ``quantize``, carried across by
interop.
"""
import dataclasses
import math
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
from repro.models import build_model
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.core import quantizer as tquant
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import moe as tmoe
from repro_torch.models.kvcache import KVCache

torch.set_num_threads(1)

QWEN, MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x22b"
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
Y_TOL, AUX_TOL = 1e-5, 1e-6
CF = 1.0                    # the serving tests' capacity factor: drops
TRACE = dict(rate_rps=1e9, prompt_len=20, max_new=6, min_new=2,
             vocab_size=256, seed=3, prompt_jitter=6)
PREFIX_TRACE = dict(TRACE, prompt_len=8, prompt_jitter=3,
                    shared_prefix_len=32)
# prompts of one bucket (16, the ring's extent) that wrap a 16-position
# ring while decoding
RING_TRACE = dict(TRACE, prompt_len=12, prompt_jitter=3, max_new=8,
                  min_new=5)
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


def _cfgs(arch, **over):
    """(JAX cfg, port cfg) of the reduced arch with ``over`` applied."""
    return (reduced_config(get_config(arch), **over),
            tconfigs.reduced_config(tconfigs.get_config(arch), **over))


_FLOATS, _SETUPS = {}, {}


def _floats(arch):
    """The JAX float params of the reduced arch, drawn once."""
    if arch not in _FLOATS:
        _FLOATS[arch] = build_model(reduced_config(get_config(arch))).init(
            jax.random.PRNGKey(0))
    return _FLOATS[arch]


def _setup(arch, bits, cf=CF):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced arch at
    capacity factor ``cf``, quantized at ``bits`` (psi5 bit-plane
    packed); built once per module."""
    key = (arch, bits, cf)
    if key not in _SETUPS:
        jcfg, tcfg = _cfgs(arch, capacity_factor=cf,
                           quant_mode=f"psi{bits}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params = build_model(jcfg).quantize(_floats(arch), bits,
                                                pack=bits < 8)
        _SETUPS[key] = (jcfg, params, tcfg,
                        params_from_numpy(np_tree(params), device="cpu"))
    return _SETUPS[key]


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [QWEN, MIXTRAL])
def test_config_fields_match_jax(arch):
    """Every field the port keeps equals the JAX registry's, full, reduced
    and reduced at a lower capacity factor; the layouts resolve alike
    (qwen3-moe paged, mixtral's SWA ring dense)."""
    for over in (None, {}, {"capacity_factor": CF}):
        want, got = get_config(arch), tconfigs.get_config(arch)
        if over is not None:
            want, got = _cfgs(arch, **over)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.resolved_cache_layout == want.resolved_cache_layout
        assert got.paged_capable == want.paged_capable == (arch == QWEN)
    red = tconfigs.reduced_config(tconfigs.get_config(arch))
    assert (red.n_experts, red.top_k, red.capacity_factor) == (8, 2, 8.0)


def test_paged_refused_for_mixtral():
    """An SWA ring cannot live in a bounded block table: both packages
    refuse the paged layout for mixtral, in the config and the Server."""
    jcfg, tcfg = _cfgs(MIXTRAL, cache_layout="paged")
    for cfg in (jcfg, tcfg):
        with pytest.raises(ValueError, match="paged"):
            cfg.resolved_cache_layout
    # both Servers resolve the layout before they touch the params
    with pytest.raises(ValueError, match="paged"):
        JServer(jcfg, None, max_batch=2, max_seq=48)
    with pytest.raises(ValueError, match="paged"):
        tserve.Server(tcfg, None, max_batch=2, max_seq=48, device="cpu")


def test_param_specs_match_jax_tree():
    """The port's init draws the JAX init's MoE leaves and shapes; the
    quantizer takes the three expert blocks (packed at psi5) and leaves
    the router in float32."""
    g = _floats(QWEN)["stack"]["groups"]["b0_attn"]
    _, tcfg = _cfgs(QWEN)
    tp = tbuild_model(tcfg).init(seed=0, device="cpu", bits=5, pack=True)
    layer = tp["layers"][0]
    assert set(layer) == set(g) == {"norm1", "attn", "norm2", "moe"}
    assert set(layer["moe"]) == set(g["moe"])
    for name, leaf in layer["moe"].items():
        assert tuple(leaf.shape) == tuple(g["moe"][name].shape[1:]), name
        if name == "router":
            assert leaf.dtype == torch.float32
        else:
            assert leaf.fmt.bits == 5 and leaf.packed, name
            assert tuple(leaf.scale.shape) == (leaf.shape[0], 1,
                                               leaf.shape[2])


# ---------------------------------------------------------------------------
# moe_ffn.
# ---------------------------------------------------------------------------
def test_row_ranks_reference_case():
    e = torch.tensor([[1, 0, 1, 1, 0]])
    np.testing.assert_array_equal(tmoe._row_ranks(e, 4).numpy(),
                                  [[0, 0, 1, 2, 1]])
    rng = np.random.default_rng(0)
    e = rng.integers(0, 8, size=(3, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        tmoe._row_ranks(torch.from_numpy(e), 8).numpy(),
        np.asarray(jmoe._row_ranks(jnp.asarray(e), 8)))


def _jax_routing(p, x, cfg, capacity_override):
    """The reference's slot loop (moe.moe_ffn up to the dispatch), in the
    JAX package's own ops: (slots (B, k, S), keep (B, k, S))."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = capacity_override or max(
        int(math.ceil(k * S * cfg.capacity_factor / E)), 1)
    occupancy = jnp.zeros((B, E), jnp.int32)
    slots, keeps = [], []
    for j in range(k):
        ej = eidx[:, :, j]
        pos = jmoe._row_ranks(ej, E) + jnp.take_along_axis(occupancy, ej, 1)
        keep = pos < C
        slots.append(jnp.where(keep, ej * C + pos, E * C))
        keeps.append(keep)
        occupancy = jnp.minimum(occupancy + jax.vmap(
            lambda e: jnp.zeros((E,), jnp.int32).at[e].add(1))(ej), C)
    return np.asarray(jnp.stack(slots, 1)), np.asarray(jnp.stack(keeps, 1))


CAPACITIES = {"cf8": (8.0, None), "cf1": (1.0, None),
              "override1": (8.0, 1), "override64": (8.0, 64)}


@pytest.mark.parametrize("leaf", ["float", "psi8", "psi5-packed"])
@pytest.mark.parametrize("cap", list(CAPACITIES))
def test_moe_ffn_matches_jax(cap, leaf):
    """One layer's MoE FFN on (3, 24, d) O(1) activations: slots and keep
    exact, y within 1e-5, aux within 1e-6; at C = 1 and cf 1 tokens drop,
    at cf 8 and C = 64 none does."""
    cf, override = CAPACITIES[cap]
    jcfg, tcfg = _cfgs(QWEN, capacity_factor=cf)
    if leaf == "float":
        jp = _floats(QWEN)
        tp = params_from_numpy(np_tree(jp), device="cpu")
    else:
        bits = 8 if leaf == "psi8" else 5
        jcfg, jp, tcfg, tp = _setup(QWEN, bits, cf)
    # layer 0 of both trees
    p = jax.tree_util.tree_map(lambda a: a[0],
                               jp["stack"]["groups"]["b0_attn"]["moe"])
    tp = tp["layers"][0]["moe"]
    x = np.random.default_rng(1).normal(
        size=(3, 24, jcfg.d_model)).astype(np.float32)
    y, aux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg,
                          capacity_override=override)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg,
                            capacity_override=override)
    jslots, jkeep = _jax_routing(p, jnp.asarray(x), jcfg, override)
    _, tslots, tkeep, _, C = tmoe.route(tp, torch.from_numpy(x), tcfg,
                                        override)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    np.testing.assert_array_equal(tslots.numpy(), jslots)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0, atol=Y_TOL)
    assert abs(float(taux) - float(aux)) <= AUX_TOL
    assert np.abs(np.asarray(y)).max() > 0.1
    dropped = not tkeep.all()
    assert dropped == (cap in ("cf1", "override1")), (cap, C)


def test_expert_dequantize_is_one_pass_and_bf16():
    """The expert blocks dequantize like the JAX package's default, to
    bf16 (also for a float32 activation), and the card's one-pass form
    (``torch.mul`` into a bf16 buffer) is bit-equal to codes * scale in
    f32 rounded once."""
    _, _, _, tp = _setup(QWEN, 5)
    for name in ("w_gate", "w_down"):
        leaf = tp["layers"][1]["moe"][name]
        got = tmoe._dequantize_bf16(leaf)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, leaf.dequantize(torch.bfloat16))
        one_pass = torch.mul(leaf.codes, leaf.scale,
                             out=torch.empty_like(got))
        assert torch.equal(one_pass, got)
        w32 = tmoe._expert_weights(leaf, torch.float32)
        assert torch.equal(w32, got.float())


@pytest.mark.parametrize("bits", [8, 5], ids=["psi8", "psi5-packed"])
def test_expert_quantization_bit_equal(bits):
    """The port's quantizer on the JAX float params: expert codes or
    planes and per-expert scales ((E, 1, f), over the contraction axis)
    bit-equal to the JAX quantizer's, the router left in float32; a psi3
    draft view of a 3-D leaf bit-equal to the JAX package's."""
    floats = params_from_numpy(np_tree(_floats(QWEN)), device="cpu")
    mine = tquant.quantize_param_tree(floats, bits, pack=bits < 8)
    _, jp, _, theirs = _setup(QWEN, bits)
    jg = jp["stack"]["groups"]["b0_attn"]["moe"]
    for i, (a, b) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert torch.equal(a["moe"]["router"], b["moe"]["router"])
        for name in ("w_gate", "w_up", "w_down"):
            qa, qb = a["moe"][name], b["moe"][name]
            assert isinstance(qa, tpsi.QuantizedTensor)
            assert qa.packed == qb.packed == (bits < 8)
            assert torch.equal(qa.data, qb.data), name
            assert torch.equal(qa.scale, qb.scale), name
            want = jg[name].draft_view(3)
            got = qa.draft_view(3)
            assert got.packed == want.packed
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(want.data)[i])
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale)[i])


# ---------------------------------------------------------------------------
# Prefill and decode logits.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 5], ids=["psi8", "psi5-packed"])
def test_prefill_and_decode_match_jax(bits, monkeypatch):
    """Right-padded prompts prefilled at capacity factor 1 (tokens drop),
    inserted into the paged pool, then two decode steps: logits within
    1e-4 at every step."""
    jcfg, jp, tcfg, tp = _setup(QWEN, bits)
    jm, tm = build_model(jcfg), tbuild_model(tcfg)
    rng = np.random.default_rng(1)
    B, S, n_bt, bs = 2, 16, 4, 16
    tl = np.array([13, 9], np.int32)
    toks = np.zeros((B, S), np.int32)
    for b in range(B):
        toks[b, :tl[b]] = rng.integers(0, 256, size=tl[b])
    feed = rng.integers(0, 256, size=(2, B)).astype(np.int32)
    bt = np.array([[3, 0, -1, -1], [1, 5, -1, -1]], np.int32)
    kept = []
    route = tmoe.route

    def counted(*a, **k):
        out = route(*a, **k)
        kept.append(bool(out[2].all()))
        return out

    jl, jseq = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                                  true_lens=n))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    monkeypatch.setattr(tmoe, "route", counted)
    tlog, tseq = tm.prefill(tp, torch.from_numpy(toks),
                            true_lens=torch.from_numpy(tl))
    monkeypatch.undo()
    assert not all(kept)                                # tokens dropped
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
# setup -> (arch, config overrides, Server kwargs, continuous, trace)
SERVES = {
    "continuous": (QWEN, {}, {}, True, TRACE),
    "static-bursts": (QWEN, {}, {}, False, TRACE),
    "horizon4": (QWEN, {}, {"decode_horizon": 4}, True, TRACE),
    "prefix-cache": (QWEN, {"prefix_cache": True}, {}, True, PREFIX_TRACE),
    "prefill-chunk16": (QWEN, {}, {"prefill_chunk": 16}, True, TRACE),
    "spec3:3": (QWEN, {}, {"speculative": (3, 3)}, True, TRACE),
    "dense": (QWEN, {"cache_layout": "dense"}, {}, False, TRACE),
    "mixtral-swa16": (MIXTRAL, {"window": 16}, {}, True, RING_TRACE),
    "mixtral-swa16-static": (MIXTRAL, {"window": 16}, {}, False,
                             RING_TRACE),
}


_SERVERS = {}


@pytest.mark.parametrize("case", list(SERVES))
def test_server_matches_jax(case, monkeypatch):
    """The same trace through both engines at psi8 and capacity factor 1:
    identical greedy tokens and equal integer stats, tokens dropped in
    the port's prefills (and, speculative, in its verifies), no block
    leaks; static mode ran real bursts of unequal prompt lengths."""
    arch, over, kw, continuous, trace = SERVES[case]
    key = (arch, tuple(over.items()), tuple(kw.items()))
    if key not in _SERVERS:           # one compile set per configuration
        jcfg, jp, tcfg, tp = _setup(arch, 8)
        jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
        _SERVERS[key] = (JServer(jcfg, jp, max_batch=3, max_seq=64, **kw),
                         tserve.Server(tcfg, tp, max_batch=3, max_seq=64,
                                       device="cpu", **kw))
    jserver, server = _SERVERS[key]
    n = 6
    jdone, js = jax_serve(jserver, jsched.poisson_trace(n, **trace),
                          continuous=continuous)
    routed, bursts = {}, []
    route = tmoe.route

    def counted(p, x, *a, **k):
        out = route(p, x, *a, **k)
        S = x.shape[1]          # prefills and chunks run >= 16 rows
        key = "decode" if S == 1 else ("verify" if S < 16 else "prefill")
        routed.setdefault(key, []).append(bool(out[2].all()))
        return out

    monkeypatch.setattr(tmoe, "route", counted)
    prefill = server.executor.prefill
    monkeypatch.setattr(server.executor, "prefill", lambda toks, tl, **k: (
        bursts.append(sorted(set(np.asarray(tl).tolist()))),
        prefill(toks, tl, **k))[1])
    # no warmup: its all-zero prompts would drop tokens on their own
    tdone, ts = server.serve(tsched.poisson_trace(n, **trace),
                             continuous=continuous, warmup=False)
    assert _toks(tdone) == _toks(jdone)
    assert {k: ts.get(k) for k in INT_STATS} == \
        {k: js.get(k) for k in INT_STATS}
    if "n_blocks" in ts:
        assert ts["blocks_free_end"] == ts["n_blocks"]
    assert all(routed["decode"])                    # S = 1 never drops
    if arch == QWEN:
        assert not all(routed["prefill"])           # ... prefills do
    if "speculative" in kw:
        assert not all(routed["verify"])            # C = 1 at S = k
        for k in ("rounds", "accepted_draft_tokens"):
            assert ts["speculative"][k] == js["speculative"][k], k
    if kw.get("decode_horizon"):
        assert ts["decode_rounds"] == js["decode_rounds"] > 0
    if "prefix_cache" in over:
        assert ts["prefix_cache"]["hits"] == js["prefix_cache"]["hits"] > 0
    if "prefill_chunk" in kw:
        assert ts["prefill_chunks"] == js["prefill_chunks"] > 0
    if case == "static-bursts":
        assert any(len(b) > 1 for b in bursts)      # unequal lengths
    if arch == MIXTRAL:
        assert ts["cache_layout"] == "dense"
        assert any(len(r.prompt) + len(r.tokens) > 16 for r in tdone)
