"""The port's SSM (falcon-mamba-7b, Mamba-1) against the JAX package's, at
the reduced size (2 layers, d_model 64, d_inner 128, state 8, dt_rank 8).

Config fields equal the JAX registry's, full and reduced; the port's init
draws the JAX init's leaves and shapes (``a_log`` equal, ``dt_proj_b`` in
the inverse softplus of [1e-3, 1e-1)); ``mamba_block`` at S 1, 2, 5, 40
and 512 (two of the reference's 256-position chunks): in float32 the
outputs and the ``ssm`` / ``conv`` state within 1e-5, in bfloat16 (the
reference's two dtypes: the prefill's ``x_proj`` / ``dt_proj`` on f32
rows) the outputs within BF16_REL of their largest value and the f32
state within 1e-5; four ``mamba_decode_step``s in both dtypes (the
decode's bf16 ``x_proj``); ``_freeze_inactive_state`` exact for mamba
state; the four projections' codes and scales bit-equal after interop
and the float leaves exact; prefill and decode logits within 1e-4; the
``Server``'s greedy tokens and timing-free integer stats
(``prefill_forwards`` included) equal the JAX ``Server``'s continuous,
static with prompts of unequal lengths (one forward a request) and at
horizon 4, at psi8 and psi5; the paged layout and the context-serving
and speculative paths refused by both packages with one message.  Params
come from the JAX package's ``init`` + ``quantize``, carried across by
interop.
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
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import slo as tslo
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
ATOL = 1e-4                 # logits tolerance of test_torch_model.py
STATE_TOL = 1e-5            # ssm and conv state, f32 (and f32 outputs)
# bf16 outputs: the port and the reference round the same f32 values to
# bf16 at the same points, but their f32 sums (the PSI matmuls, the scan)
# run in other orders, so a rounding can land one bf16 ulp (2^-8 of the
# value, relative) apart and the out projection carries it on: a few ulps
# of the largest output
BF16_REL = 2.0 ** -6
# prompts of 25-28 tokens (each length a prefill shape of the JAX
# package's), 6-10 new ones
TRACE = dict(rate_rps=1e9, prompt_len=26, max_new=10, min_new=6,
             vocab_size=256, seed=3, prompt_jitter=2)
INT_STATS = ("n_requests", "tokens", "decode_steps", "host_syncs",
             "prefill_forwards", "prefilled_tokens", "peak_concurrency")
MAMBA_PSI = ("in_proj", "x_proj", "dt_proj_w", "out_proj")
MAMBA_F32 = ("conv1d_w", "conv1d_b", "dt_proj_b", "a_log", "d_skip")


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
    width and dtype)."""
    if not _FLOATS:
        _FLOATS[0] = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    return _FLOATS[0]


def _setup(bits=8, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params) at the reduced size,
    quantized at psi``bits`` (packed below 8)."""
    key = (bits, dtype)
    if key not in _SETUPS:
        over = dict(quant_mode=f"psi{bits}", dtype=dtype)
        cfg = reduced_config(get_config(ARCH), **over)
        tcfg = tconfigs.reduced_config(tconfigs.get_config(ARCH), **over)
        params = build_model(cfg).quantize(_floats(cfg), bits,
                                           pack=bits < 8)
        _SETUPS[key] = (cfg, params, tcfg,
                        params_from_numpy(np_tree(params), device="cpu"))
    return _SETUPS[key]


def _layer0(tree):
    """Layer 0 of the scanned JAX group (QuantizedTensor leaves
    included)."""
    def one(a):
        if isinstance(a, QuantizedTensor):
            return QuantizedTensor(a.data[0], a.scale[0], a.fmt, a.packed)
        return a[0]
    return jax.tree_util.tree_map(
        one, tree, is_leaf=lambda x: isinstance(x, QuantizedTensor))


def _mamba_params(dtype="float32"):
    cfg, params, tcfg, tparams = _setup(dtype=dtype)
    jp = _layer0(params["stack"]["groups"]["b0_mamba"]["mamba"])
    return cfg, jp, tcfg, tparams["layers"][0]["mamba"]


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    want, got = get_config(ARCH), tconfigs.get_config(ARCH)
    if reduced:
        want, got = reduced_config(want), tconfigs.reduced_config(got)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("resolved_dt_rank", "d_inner", "is_attention_free",
                 "paged_capable", "resolved_cache_layout"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.is_attention_free and got.resolved_cache_layout == "dense"
    assert ttransformer.layer_kinds(got) == jtransformer.layer_kinds(want)


def test_param_specs_match_jax_tree():
    """The port's init draws the JAX init's leaves at its shapes:
    ``a_log`` = log(1..N) on every row (to an f32 ulp of ``log``:
    torch's and XLA's may differ by one); ``dt_proj_b`` the inverse
    softplus of a uniform draw in [1e-3, 1e-1); ``d_skip`` ones; the
    quantizer takes the four projections only."""
    cfg, _, tcfg, _ = _setup()
    jp = _layer0(_floats(cfg)["stack"]["groups"]["b0_mamba"])
    tp = tbuild_model(tcfg).init(seed=0, device="cpu", bits=8)
    assert set(tp) == {"embed", "layers", "norm_f", "lm_head"}
    layer = tp["layers"][0]
    assert set(layer) == set(jp) == {"norm1", "mamba"}
    assert set(layer["mamba"]) == set(jp["mamba"])
    for name, leaf in layer["mamba"].items():
        assert tuple(leaf.shape) == tuple(jp["mamba"][name].shape), name
        assert isinstance(leaf, tpsi.QuantizedTensor) == (name in MAMBA_PSI)
    np.testing.assert_allclose(layer["mamba"]["a_log"].numpy(),
                               np.asarray(jp["mamba"]["a_log"]), rtol=2e-7,
                               atol=0)
    dt = torch.nn.functional.softplus(layer["mamba"]["dt_proj_b"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) < 1e-1 + 1e-7
    assert torch.equal(layer["mamba"]["d_skip"],
                       torch.ones(tcfg.d_inner))


def _cast(x, dtype):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = (STATE_TOL if dtype == "float32"
           else BF16_REL * float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 5, 40, 512])
def test_mamba_block_matches_jax(S, dtype):
    """The prefill block: output in the activation dtype, state in f32.
    The reference keeps only the S rows of the conv tail below cw-1; the
    port pads it with zeros in front (a decode reads cw-1 rows)."""
    cfg, jp, tcfg, tp = _mamba_params(dtype)
    rng = np.random.default_rng(S)
    jx, tx = _cast(rng.standard_normal((2, S, cfg.d_model))
                   .astype(np.float32), dtype)
    jy, (jh, jc) = jax.jit(lambda p, x: jssm.mamba_block(p, x, cfg))(jp, jx)
    ty, ts = tssm.mamba_block(tp, tx, tcfg)
    assert ty.dtype == tx.dtype
    assert ts["ssm"].dtype == ts["conv"].dtype == torch.float32
    _close(ty, jy, dtype)
    np.testing.assert_allclose(ts["ssm"].numpy(), np.asarray(jh), rtol=0,
                               atol=STATE_TOL)
    want_conv = np.asarray(jc)
    if S < cfg.ssm_conv - 1:
        want_conv = np.concatenate([np.zeros(
            (2, cfg.ssm_conv - 1 - S, cfg.d_inner), np.float32),
            want_conv], 1)
    np.testing.assert_array_equal(ts["conv"].numpy(), want_conv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_jax(dtype):
    """Four decode steps from a 9-token prefill's state, each against the
    reference's step from the same (port) state."""
    cfg, jp, tcfg, tp = _mamba_params(dtype)
    rng = np.random.default_rng(7)
    _, tx = _cast(rng.standard_normal((3, 9, cfg.d_model))
                  .astype(np.float32), dtype)
    _, st = tssm.mamba_block(tp, tx, tcfg)
    step = jax.jit(lambda p, x, s: jssm.mamba_decode_step(p, x, cfg, s))
    for _ in range(4):
        jx, tx = _cast(rng.standard_normal((3, 1, cfg.d_model))
                       .astype(np.float32), dtype)
        jy, js = step(jp, jx, {k: jnp.asarray(v.numpy())
                               for k, v in st.items()})
        ty, st = tssm.mamba_decode_step(tp, tx, tcfg, st)
        assert ty.dtype == tx.dtype
        _close(ty, jy, dtype)
        np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(js["ssm"]),
                                   rtol=0, atol=STATE_TOL)
        np.testing.assert_array_equal(st["conv"].numpy(),
                                      np.asarray(js["conv"]))


def test_freeze_inactive_mamba_state_matches_jax():
    rng = np.random.default_rng(3)
    new = {"ssm": rng.standard_normal((4, 16, 8)).astype(np.float32),
           "conv": rng.standard_normal((4, 3, 16)).astype(np.float32)}
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


@pytest.mark.parametrize("bits", [8, 5])
def test_interop_leaves(bits):
    """Layer i is the scanned b0_mamba group's i-th block: the four
    projections' codes (planes at psi5) and scales bit-equal, the float
    leaves exact and f32; the untied lm-head carried."""
    cfg, params, tcfg, tparams = _setup(bits)
    g = params["stack"]["groups"]["b0_mamba"]
    assert params["stack"]["tail"] == [] and len(tparams["layers"]) == 2
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == {"norm1", "mamba"}
        for name in MAMBA_PSI:
            got, exp = layer["mamba"][name], g["mamba"][name]
            assert isinstance(got, tpsi.QuantizedTensor), name
            assert got.packed == (bits < 8) and got.fmt.bits == bits
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(exp.data[i]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(exp.scale[i]))
        for name in MAMBA_F32:
            got = layer["mamba"][name]
            assert isinstance(got, torch.Tensor)
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(g["mamba"][name][i]))
    np.testing.assert_array_equal(tparams["lm_head"].data.numpy(),
                                  np.asarray(params["lm_head"].data))


def test_prefill_and_decode_match_jax():
    """A batch-2 prefill of 20 tokens, then 3 decode steps with row 1
    inactive on the second: logits within 1e-4, mamba state within 1e-5,
    the inactive row's state frozen exactly; no KV, no ``enc_out``."""
    cfg, params, tcfg, tparams = _setup()
    jm, tm = build_model(cfg), tbuild_model(tcfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, size=(2, 20)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    cache = tm.init_cache(2, 32, device="cpu")
    assert cache.enc_out is None
    assert all(set(layer) == {"ssm", "conv"} for layer in cache.kv)
    for row in range(2):
        tm.insert_cache(cache, tm.slice_cache(tc, row), row)
    for step in range(3):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        pos = np.full((2, 1), 20 + step, np.int32)
        active = np.array([True, step != 1])
        before = [{k: v.clone() for k, v in layer.items()}
                  for layer in cache.kv]
        jl, jc = jm.decode_step(params, {
            "token": jnp.asarray(tok), "pos": jnp.asarray(pos),
            "active": jnp.asarray(active)}, jc)
        tl, cache = tm.decode_step(tparams, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
            "active": torch.from_numpy(active)}, cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        g = jc.kv[0]["b0"]
        for i, layer in enumerate(cache.kv):
            for k in ("ssm", "conv"):
                np.testing.assert_allclose(layer[k].numpy(),
                                           np.asarray(g[k][i]), rtol=0,
                                           atol=STATE_TOL)
                if not active[1]:
                    assert torch.equal(layer[k][1], before[i][k][1])


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
    lens = [len(r.prompt) for r in tdone]
    assert len(set(lens)) > 1                      # prompts of unequal length
    assert max(forwards) == 1                      # ... prefilled one by one
    assert ts["prefill_forwards"] == len(lens)     # ... in static mode too
    assert server._bucket_len(27) == 27            # exact-length prefill


def test_attention_free_needs_no_extent():
    """Both packages serve a request longer than ``max_seq`` (an SSM's
    state has no extent), with the same tokens."""
    cfg, params, tcfg, tparams = _setup()
    trace = dict(TRACE, prompt_len=20, max_new=12, min_new=12,
                 prompt_jitter=0)
    jdone, _ = jax_serve(JServer(cfg, params, max_batch=2, max_seq=16),
                         jsched.poisson_trace(2, **trace))
    tdone, _ = tserve.Server(tcfg, tparams, max_batch=2, max_seq=16,
                             device="cpu").serve(
        tsched.poisson_trace(2, **trace))
    assert _toks(tdone) == _toks(jdone)
    assert all(len(r.tokens) == 12 for r in tdone)


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


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("m", [2, 4])
def test_in_proj_reslice_gives_each_rank_its_channels(m, bits):
    """On a model axis of m (d_model 1024: tensor parallelism on), rank j's
    ``in_proj`` holds the single process's channels [j di/m, (j+1) di/m)
    of the x half and the same channels of the z half (codes and per-column
    scales; psi5's planes cut along N), in that order, where a contiguous
    chunk of the columns (the spec's GSPMD layout) would give the first
    ranks x and the last z; the rank's config has d_inner / m channels."""
    from repro_torch.runtime import parallel, sharding as tshr
    tcfg = tconfigs.reduced_config(tconfigs.get_config(ARCH), d_model=1024,
                                   n_layers=1, vocab_size=512)
    di = tcfg.d_inner
    full = tbuild_model(tcfg).init(seed=0, device="cpu", bits=bits,
                                   pack=True)
    whole = full["layers"][0]["mamba"]["in_proj"]
    assert whole.packed == (bits < 8)
    mesh = tshr.AxisMesh((1, m), ("data", "model"))
    spec = tshr.param_specs(full, tcfg, mesh)["layers"][0]["mamba"][
        "in_proj"]
    assert tuple(spec.data)[-1] == "model"
    c = di // m
    for j in range(m):
        placer = tshr.LeafPlacer(tcfg, mesh, {"data": 0, "model": j})
        mine = placer.place("layers/0/mamba/in_proj", whole)
        assert mine.shape == (tcfg.d_model, 2 * c)
        for half in (0, 1):
            lo = half * di + j * c
            assert torch.equal(mine.codes[:, half * c:(half + 1) * c],
                               whole.codes[:, lo:lo + c]), (j, half)
            assert torch.equal(mine.scale[..., half * c:(half + 1) * c],
                               whole.scale[..., lo:lo + c]), (j, half)
    assert parallel.tp_local_config(tcfg, m).d_inner == c
