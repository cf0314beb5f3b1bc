"""The port's analytic roofline against the JAX package's.

Every count is plain Python arithmetic in the same order of operations, so
the two packages agree bit for bit (``==``) for all ten assigned configs,
the four shapes and psi8 / psi5 / bf16 weights; only the rates differ
(the port states the H100 SXM's), so ``roofline_terms`` equal the
reference's terms rescaled by the constants' ratio.  The analytic forward
count is also held against ``torch.utils.flop_counter`` over the port's
plain forward of a narrow qwen3-8b (the reference's 35 % cross-check
against XLA), and the serve stats' ``macs_per_token`` against the JAX
Server's on one trace.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.configs import shape_applicable as jshape_applicable
from repro.core.psi import QuantizedTensor
from repro.launch.serve import Server as JServer
from repro.models import build_model as jbuild_model
from repro.perf import roofline_model as jroof
from repro_torch import configs as tconfigs
from repro_torch.core import psi as tpsi
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild_model
from repro_torch.perf import roofline_model as troof

torch.set_num_threads(1)

QUANTS = ("none", "psi8", "psi5")


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def test_registry_matches_reference():
    assert tconfigs.ASSIGNED_ARCHS == J_ARCHS
    assert tconfigs.SHAPES.keys() == J_SHAPES.keys()
    for name, sh in tconfigs.SHAPES.items():
        assert dataclasses.asdict(sh) == dataclasses.asdict(J_SHAPES[name])
    for a in J_ARCHS:
        c, j = tconfigs.get_config(a), jget_config(a)
        assert c.param_count() == j.param_count(), a
        assert c.active_param_count() == j.active_param_count(), a
        assert c.sub_quadratic == j.sub_quadratic, a
        for s in J_SHAPES:
            assert (tconfigs.shape_applicable(c, tconfigs.SHAPES[s])[0]
                    == jshape_applicable(j, J_SHAPES[s])[0]), (a, s)
    for bits in (2, 3, 4, 5, 6, 7, 8):
        from repro.core import psi as jpsi
        assert (tpsi.packed_bytes_per_weight(bits)
                == jpsi.packed_bytes_per_weight(bits))
        for packed in (False, True):
            assert (tpsi.get_format(bits).bytes_per_weight(packed)
                    == jpsi.get_format(bits).bytes_per_weight(packed))


@pytest.mark.parametrize("arch", J_ARCHS)
def test_counts_bit_equal(arch):
    """forward_flops, decode_macs_per_token, kv_cache_bytes (int8 KV too),
    weight bytes and every analytic_cell field: == the reference's."""
    c, j = tconfigs.get_config(arch), jget_config(arch)
    for s, sh in J_SHAPES.items():
        B, S, kind = sh.global_batch, sh.seq_len, sh.kind
        assert (troof.forward_flops(c, B, S, kind)
                == jroof.forward_flops(j, B, S, kind)), (arch, s)
        for kvq in ("", "int8"):
            assert (troof.kv_cache_bytes(c, B, S, kvq)
                    == jroof.kv_cache_bytes(j, B, S, kvq)), (arch, s, kvq)
        for ctx in (1, 77, S):
            assert (troof.decode_macs_per_token(c, ctx)
                    == jroof.decode_macs_per_token(j, ctx))
        for q in QUANTS:
            assert (troof.weight_bytes_total(c, q)
                    == jroof.weight_bytes_total(j, q))
            assert (troof.active_weight_bytes(c, q)
                    == jroof.active_weight_bytes(j, q))
            for chips, mm, kvq in ((256, 16, ""), (1, 1, ""), (512, 16,
                                                                "int8")):
                tc = troof.analytic_cell(arch, s, q, chips=chips,
                                         mesh_model=mm, kv_quant=kvq)
                jc = jroof.analytic_cell(arch, s, q, chips=chips,
                                         mesh_model=mm, kv_quant=kvq)
                assert dataclasses.asdict(tc) == dataclasses.asdict(jc), (
                    arch, s, q, chips)


def test_roofline_terms_rescaled():
    """The port's terms are the reference's times the ratio of the rates
    (TPU v5e there, H100 SXM here); the constants are the data sheet's."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 4.5e11)
    for arch in J_ARCHS:
        for s in J_SHAPES:
            cell = jroof.analytic_cell(arch, s, "psi8")
            for chips in (1, 256):
                tt = troof.roofline_terms(cell, chips)
                jt = jroof.roofline_terms(cell, chips)
                for key, ratio in (
                        ("compute_s", jroof.PEAK_FLOPS / troof.PEAK_FLOPS),
                        ("memory_s", jroof.HBM_BW / troof.HBM_BW),
                        ("collective_s", jroof.ICI_BW / troof.LINK_BW)):
                    assert tt[key] == pytest.approx(jt[key] * ratio,
                                                    rel=1e-12), (arch, s)
                dom = max(("compute_s", "memory_s", "collective_s"),
                          key=tt.get)
                assert tt["bottleneck"] == dom[:-2]
                assert tt["bound_s"] == tt[dom]
                assert 0 < tt["roofline_fraction"] <= 1.0


def test_decode_memory_bound_on_h100():
    """Single-token decode against a deep cache stays memory-bound with
    the card's rates: the regime PSI weights target."""
    for a in ("chatglm3-6b", "qwen3-8b", "phi3-medium-14b"):
        rt = troof.roofline_terms(
            troof.analytic_cell(a, "decode_32k", "psi8", chips=1,
                                mesh_model=1), chips=1)
        assert rt["bottleneck"] == "memory", (a, rt)


def test_flop_counter_cross_check():
    """FlopCounterMode over the port's plain forward of a narrow unrolled
    qwen3-8b is within the reference's 35 % of forward_flops."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tconfigs.reduced_config(
        tconfigs.get_config("qwen3-8b"), d_model=128, d_ff=256, n_layers=2,
        vocab_size=512, head_dim=32, n_heads=4, n_kv_heads=2)
    model = tbuild_model(cfg)
    params = model.init(seed=0, device="cpu")
    B, S = 4, 128
    tokens = torch.zeros((B, S), dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.forward(params, tokens)
    ours = troof.forward_flops(cfg, B, S, "prefill")
    counted = counter.get_total_flops()
    assert 0.65 < ours / counted < 1.35, (ours, counted)


def test_serve_stats_macs_match_jax():
    """One trace through both Servers: macs_per_token ==, mfu from the
    formula (the port's peak over its mesh), watts 0 on the CPU and
    tokens_per_joule 0.0 there, as the reference gives for watts <= 0."""
    cfg = jreduced_config(jget_config("qwen3-8b"))
    model = jbuild_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="psi8")
    trace = dict(rate_rps=1e9, prompt_len=12, max_new=6, vocab_size=256,
                 seed=3, prompt_jitter=4)
    from repro.launch import scheduler as jsched
    js = JServer(cfg, params, max_batch=2, max_seq=64)
    _, jst = js.serve(jsched.poisson_trace(5, **trace), continuous=True)
    ts = tserve.Server(tcfg, params_from_numpy(np_tree(params), device="cpu"),
                       max_batch=2, max_seq=64, device="cpu")
    done, st = ts.serve(tsched.poisson_trace(5, **trace), continuous=True)
    assert st["macs_per_token"] == jst["macs_per_token"]
    mean_ctx = sum(len(r.full_seq) for r in done) / len(done)
    macs = troof.decode_macs_per_token(tcfg, int(mean_ctx))
    assert st["macs_per_token"] == round(macs, 1)
    assert st["mfu"] == round(2.0 * macs * st["tok_per_s"]
                              / (troof.PEAK_FLOPS * 1), 8)
    assert st["watts"] == 0.0 and st["tokens_per_joule"] == 0.0
    ts.watts = 700.0
    _, st2 = ts.serve(tsched.poisson_trace(5, **trace), continuous=True)
    assert st2["tokens_per_joule"] == round(st2["tok_per_s"] / 700.0, 4)


def test_card_power_limit_without_nvidia_smi(tmp_path, monkeypatch):
    """No nvidia-smi on the PATH: the query raises a RuntimeError that
    names --watts, the flag that avoids it."""
    monkeypatch.setenv("PATH", str(tmp_path))
    tserve.card_power_limit.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="--watts"):
            tserve.card_power_limit("GPU-00000000-0000-0000-0000-000000000000")
    finally:
        tserve.card_power_limit.cache_clear()


def test_card_power_limit_asks_by_uuid(tmp_path, monkeypatch):
    """The query names the card by its UUID (the same physical card under
    any CUDA_VISIBLE_DEVICES) and parses nvidia-smi's "700.00 W"; a
    failing query raises with the --watts hint."""
    log = tmp_path / "args"
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n"
                   f'echo "$@" > {log}\n'
                   'case "$*" in *GPU-bad*) echo "No devices" >&2; exit 6;; '
                   'esac\n'
                   'echo "700.00 W"\n')
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    uuid = "GPU-5e1b6f4c-0000-0000-0000-000000000001"
    tserve.card_power_limit.cache_clear()
    try:
        assert tserve.card_power_limit(uuid) == 700.0
        assert log.read_text().split() == [
            "--query-gpu=power.limit", "--format=csv,noheader", "-i", uuid]
        with pytest.raises(RuntimeError, match="No devices.*--watts"):
            tserve.card_power_limit("GPU-bad")
    finally:
        tserve.card_power_limit.cache_clear()
