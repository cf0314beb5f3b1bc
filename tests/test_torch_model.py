"""The port's reduced qwen3-8b against the JAX package: the same params
(JAX ``init`` + ``quantize``, carried across by interop), a teacher-forced
prefill of right-padded prompts, insertion into the paged pool and four
decode steps; logits within 1e-4 at every step, for psi8, packed psi5, a
mixed-precision policy and an int8 KV pool.  Also the paged decode block
alone, on the overflow and inactive-slot routing."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild_model
from repro_torch.models.kvcache import KVCache

torch.set_num_threads(1)

# f32 everywhere; the two stacks sum in different orders (and evaluate
# pow/cos/sin in different libraries): a few 1e-6 on O(1) logits
ATOL = 1e-4


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


def _models(bits, pack, policy, kv_quant):
    cfg = reduced_config(get_config("qwen3-8b"), kv_quant=kv_quant)
    model = build_model(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = model.quantize(model.init(jax.random.PRNGKey(0)), bits,
                                pack=pack, policy=policy)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   kv_quant=kv_quant, quant_mode="psi8")
    return (build_model(cfg), params, tbuild_model(tcfg),
            params_from_numpy(np_tree(params), device="cpu"))


@pytest.mark.parametrize("bits,pack,policy,kv_quant", [
    (8, False, None, ""),
    (5, True, None, ""),
    (None, True, "embed=8,w_down=5,wq=3,default=4", ""),
    (8, False, None, "int8"),
], ids=["psi8", "psi5-packed", "mixed-policy", "kv-int8"])
def test_prefill_and_decode_match_jax(bits, pack, policy, kv_quant):
    jm, jp, tm, tp = _models(bits, pack, policy, kv_quant)
    rng = np.random.default_rng(1)
    B, S, n_bt, bs = 2, 16, 4, 16
    tl = np.array([13, 9], np.int32)
    toks = np.zeros((B, S), np.int32)
    for b in range(B):
        toks[b, :tl[b]] = rng.integers(0, 256, size=tl[b])
    feed = rng.integers(0, 256, size=(4, B)).astype(np.int32)
    bt = np.array([[3, 0, -1, -1], [1, 5, -1, -1]], np.int32)

    # one compiled executable per entry point instead of a scan compile
    # per eager call
    jprefill = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                                  true_lens=n))
    jdecode = jax.jit(jm.decode_step)
    jl, jseq = jprefill(jp, jnp.asarray(toks), jnp.asarray(tl))
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
    pos = tl.copy()
    for step in range(4):
        batch = {"token": feed[step][:, None], "pos": pos[:, None],
                 "active": np.array([True, True]), "block_table": bt}
        jl, jcache = jdecode(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
        tlog, tcache = tm.decode_step(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"decode step {step}")
        pos += 1


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("positions,active", [
    ([[17], [0]], [True, True]),          # in range, two blocks deep
    ([[32], [35]], [True, True]),         # past the table: scratch blocks
    ([[1], [1]], [False, True]),          # inactive row writes scratch
])
def test_paged_decode_block_matches_jax(kv_quant, positions, active):
    cfg = reduced_config(get_config("qwen3-8b"), kv_quant=kv_quant)
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   kv_quant=kv_quant)
    p = jattn.init_attention(cfg, jax.random.PRNGKey(2))
    tp = params_from_numpy({"embed": np.zeros((1, 1), np.float32),
                            "norm_f": {},
                            "stack": {"groups": {"b0_attn": {
                                k: np.asarray(v)[None]
                                for k, v in p.items()}}}},
                           device="cpu")["layers"][0]
    B, n_bt, bs = 2, 2, cfg.cache_block_size
    N = B * n_bt + B
    rng = np.random.default_rng(4)
    jc = jattn.init_paged_kv_cache(cfg, N, bs, jnp.float32)
    jc = {k: jnp.asarray(rng.normal(size=v.shape), v.dtype)
          for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    bt = np.array([[0, 1], [2, 3]], np.int32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    act = np.asarray(active)
    jy, jc2 = jattn.paged_decode_attention_block(
        p, jnp.asarray(x), cfg, jnp.asarray(pos), jc, jnp.asarray(bt),
        active=jnp.asarray(act))
    ty, tc2 = tattn.paged_decode_attention_block(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos), tc,
        torch.from_numpy(bt), active=torch.from_numpy(act))
    rows = [b for b in range(B) if act[b]]
    np.testing.assert_allclose(ty.numpy()[rows], np.asarray(jy)[rows],
                               rtol=0, atol=ATOL)
    for k in jc2:
        np.testing.assert_allclose(tc2[k].numpy(), np.asarray(jc2[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_kv_quantize_roundtrip_matches_jax():
    x = np.random.default_rng(6).normal(size=(3, 5, 2, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                  # the 1e-8 amax floor
    jq, js = jattn._kv_quantize(jnp.asarray(x))
    tq, ts = tattn._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn._kv_dequantize(tq, ts, torch.float32).numpy(),
        np.asarray(jattn._kv_dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("bits,pack", [(8, False), (4, True)])
def test_tied_logits_and_embed_match_jax(bits, pack):
    from repro.core import psi as jpsi
    from repro.quant import embed as jembed, tied_logits as jtied
    from repro_torch.core import psi as tpsi
    from repro_torch.quant import embed as tembed, tied_logits as ttied
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(64, 16)).astype(np.float32)          # (V, D)
    jq = jpsi.quantize_weights(jnp.asarray(w), bits, axis=(1,))
    jq = jq.pack() if pack else jq
    tq = tpsi.QuantizedTensor(torch.from_numpy(np.array(jq.data)),
                              torch.from_numpy(np.array(jq.scale)),
                              tpsi.get_format(bits), pack)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(ttied(tq, torch.from_numpy(x)).numpy(),
                               np.asarray(jtied(jq, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    ids = np.array([[0, 63], [9, 9]], np.int32)
    np.testing.assert_array_equal(
        tembed(tq, torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(jembed(jq, jnp.asarray(ids), jnp.float32)))
