"""The port's serving engine against the JAX package's on one trace.

Both engines get the same reduced qwen3-8b psi8 params (JAX ``init`` +
``quantize``, carried across by interop) and the same arrival trace (the
port's ``poisson_trace`` draws it from the same numpy seed).  Every request
must emit identical greedy tokens; the port's teacher-forced logits show a
top-2 margin above the logits tolerance at every emitted token, so the
identity cannot hide behind a near-tie.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.launch import scheduler as jsched
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild_model
from repro_torch.runtime import Executor

torch.set_num_threads(1)

ATOL = 1e-4                     # logits tolerance of test_torch_model.py
TRACE = dict(rate_rps=1e9, prompt_len=12, max_new=8, vocab_size=256,
             seed=3, prompt_jitter=4)


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


@pytest.fixture(scope="module")
def engines():
    cfg = reduced_config(get_config("qwen3-8b"))
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="psi8")
    jserver = JServer(cfg, params, max_batch=2, max_seq=64)
    tserver = tserve.Server(tcfg, params_from_numpy(np_tree(params),
                                                     device="cpu"),
                            max_batch=2, max_seq=64, device="cpu")
    return jserver, tserver


def _by_rid(done):
    return {r.rid: list(r.tokens) for r in done}


def test_trace_is_the_same_draw():
    a = jsched.poisson_trace(4, **TRACE)
    b = tsched.poisson_trace(4, **TRACE)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival_s) == (y.rid, y.max_new,
                                                   y.arrival_s)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_tokens_match_jax_server(engines):
    jserver, tserver = engines
    jdone, _ = jserver.serve(jsched.poisson_trace(4, **TRACE))
    tdone, stats = tserver.serve(tsched.poisson_trace(4, **TRACE))
    assert _by_rid(tdone) == _by_rid(jdone)
    assert stats["n_requests"] == 4 and stats["blocks_free_end"] == \
        tserver.executor.n_blocks
    assert stats["kernel_launches"] == {k: 0 for k in
                                        stats["kernel_launches"]}
    # no near-tie behind the identity: teacher-force each stream through the
    # port and check the emitted token wins by more than the tolerance
    ex = tserver.executor
    for r in tdone:
        seq = torch.from_numpy(r.full_seq[None, :-1].astype(np.int32))
        with torch.inference_mode():
            logits, _ = ex.model.forward(ex.params, seq)
        gen = logits[0, len(r.prompt) - 1:]
        top2 = torch.topk(gen, 2, dim=-1)
        assert top2.indices[:, 0].tolist() == r.tokens
        assert float((top2.values[:, 0] - top2.values[:, 1]).min()) > \
            10 * ATOL, r.rid


def test_continuous_matches_static(engines):
    _, tserver = engines
    mk = lambda: tsched.poisson_trace(5, **dict(TRACE, seed=7))
    done_c, sc = tserver.serve(mk(), continuous=True)
    done_s, ss = tserver.serve(mk(), continuous=False)
    assert _by_rid(done_c) == _by_rid(done_s)
    assert all(len(r.tokens) == r.max_new for r in done_c)
    assert sc["decode_steps"] <= ss["decode_steps"]


def test_eos_retires_at_first_eos(engines):
    _, tserver = engines
    done, _ = tserver.serve(tsched.poisson_trace(3, **TRACE))
    eos = next(r.tokens[1] for r in done if len(r.tokens) > 2)
    old, tserver.eos_id = tserver.eos_id, eos
    try:
        done2, _ = tserver.serve(tsched.poisson_trace(3, **TRACE))
    finally:
        tserver.eos_id = old
    for r in done2:
        if eos in r.tokens:
            assert r.tokens.index(eos) == len(r.tokens) - 1
        else:
            assert len(r.tokens) == r.max_new


def _trace_args(argv):
    ap = argparse.ArgumentParser()
    tserve.add_serve_args(ap)
    return ap.parse_args(["--arch", "qwen3-8b", "--requests", "6",
                          "--prompt-jitter", "3", "--min-new", "2",
                          "--arrival-rate", "50"] + argv)


def _draws(trace):
    return [(r.rid, r.max_new, r.arrival_s, r.prompt.tolist())
            for r in trace]


def test_trace_seed_matches_reference():
    """``--seed 0 --trace-seed 7``: the port's trace is the reference's
    ``trace_from_args`` draw (arrivals, budgets, prompts), and differs
    from ``--seed 0`` alone (whose trace is the reference's too)."""
    from repro.launch.serve import trace_from_args as jtrace
    cfg = tconfigs.get_config("qwen3-8b")
    both = _trace_args(["--seed", "0", "--trace-seed", "7"])
    alone = _trace_args(["--seed", "0"])
    assert both.trace_seed == 7 and alone.trace_seed is None
    got = _draws(tserve.trace_from_args(both, cfg))
    assert got == _draws(jtrace(both, cfg))
    plain = _draws(tserve.trace_from_args(alone, cfg))
    assert plain == _draws(jtrace(alone, cfg))
    assert got != plain


def test_cli_path_serves_on_cpu():
    args = argparse.Namespace(
        arch="qwen3-8b", reduced=True, n_layers=0, quant="psi5",
        quant_policy=None, requests=3, max_batch=2, arrival_rate=1e9,
        max_new=4, min_new=1, prompt_len=10, prompt_jitter=2, block_size=0,
        cache_blocks=None, eos_id=-1, seed=0, device="cpu")
    server, cfg = tserve.build_server(args)
    done, stats = server.serve(tserve.trace_from_args(args, cfg))
    assert stats["n_requests"] == 3 and stats["device"] == "cpu"
    assert stats["decode_steps"] > 0 and stats["prefill_forwards"] > 0


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(tcfg, {}, max_batch=1, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.Server(tcfg, {}, max_batch=1, max_seq=16)
    args = argparse.Namespace(arch="qwen3-8b", reduced=True, quant="psi8",
                              device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.build_server(args)
    model = tbuild_model(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.init_paged_kv_cache(tcfg, 2, tcfg.cache_block_size)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": np.zeros((1, 1), np.float32),
                           "norm_f": {}, "stack": {"groups": {"b0_attn": {
                               "w": np.zeros((1, 1), np.float32)}}}})


def test_cli_d_model_widens_a_reduced_config():
    """``--d-model`` sets a reduced config's residual width (1024 puts the
    weights tensor-parallel on a mesh) and is refused without
    ``--reduced``."""
    ap = argparse.ArgumentParser()
    tserve.add_serve_args(ap)
    args = ap.parse_args(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                          "--d-model", "1024", "--device", "cpu",
                          "--requests", "2", "--max-new", "2",
                          "--prompt-len", "8"])
    server, cfg = tserve.build_server(args)
    assert cfg.d_model == 1024 and cfg.quant_mode == "psi8"
    assert server.executor.params["embed"].shape == (cfg.vocab_size, 1024)
    args.reduced = False
    with pytest.raises(ValueError, match="--d-model"):
        tserve.build_server(args)
