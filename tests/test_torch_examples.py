"""The example twins (``examples/*_torch.py``) on the CPU, in-process, at
shortened steps: each runs through its ``main``; the quickstart's psi5
generation equals the JAX quickstart's on the same params (the JAX init,
carried across by ``interop``) and prompt; AlexNet's accelerator lines
equal, as strings, those formatted from the JAX package's ``tma_model``
and ``baselines``; without a card and without ``device`` every example
raises rather than fall back to the CPU."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import baselines as jbl
from repro.core import psi as jpsi
from repro.core import tma_model as jtm
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import TokenStream
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as tbuild

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart_torch", "serve_quantized_torch", "train_lenet_qat_torch",
         "alexnet_tma_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_tree(t):
    if isinstance(t, jpsi.QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_card_unless_told(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(steps=1)


def test_quickstart_trains_quantizes_and_generates(capsys):
    qs = _load("quickstart_torch")
    gen = qs.main(device="cpu", steps=2)
    assert gen.shape == (2, 1 + qs.NEW_TOKENS)
    assert int(gen.min()) >= 0 and int(gen.max()) < 256
    out = capsys.readouterr().out
    assert "step    0  loss" in out
    assert f"generated (psi5 weights, 0.625 B/weight): {gen[0].tolist()}" \
        in out


def test_quickstart_generation_matches_jax():
    """The recipe's serving half on the JAX init of the qat8 config: psi5
    packed codes from each package's quantizer, greedy prefill + 12
    decode steps on the stream's first prompt (the JAX steps jitted, as
    its Server runs them); identical tokens."""
    qs = _load("quickstart_torch")
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="qat8")
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompt = next(TokenStream(cfg.vocab_size, seq_len=64,
                              global_batch=16))[:2, :qs.PROMPT_LEN]

    jq = jmodel.quantize(jparams, bits=5, pack=True)
    jserve = jbuild(dataclasses.replace(cfg, quant_mode="psi5"))
    prefill = jax.jit(jserve.prefill, static_argnames="cache_len")
    decode_step = jax.jit(jserve.decode_step)
    logits, cache = prefill(jq, {"tokens": jnp.asarray(prompt)},
                            cache_len=qs.CACHE_LEN)
    tok = jnp.argmax(logits, -1)[:, None]
    want = [tok]
    for i in range(qs.NEW_TOKENS):
        lg, cache = decode_step(
            jq, {"token": tok,
                 "pos": jnp.full((2, 1), qs.PROMPT_LEN + i, jnp.int32)},
            cache)
        tok = jnp.argmax(lg, -1)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    tcfg = treduced(tget("qwen3-8b"), quant_mode="qat8")
    tmodel = tbuild(tcfg)
    tq = tmodel.quantize(params_from_numpy(np_tree(jparams), device="cpu"),
                         bits=5, pack=True)
    tserve = tbuild(dataclasses.replace(tcfg, quant_mode="psi5"))
    with torch.no_grad():
        got = qs.generate(tserve, tq, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_quantized_serves_every_format(capsys):
    served = _load("serve_quantized_torch").main(device="cpu", steps=3)
    assert list(served) == ["none", "psi8", "psi5", "psi4", "mixed"]
    for done, stats in served.values():
        assert len(done) == 4
        for r in done:
            assert 1 <= len(r.out) <= 3
            assert ((r.out >= 0) & (r.out < 256)).all()
        assert stats["tok_per_s"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5
    assert all("tok/s (CPU), weights" in line for line in lines)


def test_train_lenet_qat_reports_every_mode(capsys):
    accs = _load("train_lenet_qat_torch").main(device="cpu", steps=3)
    assert set(accs) == {"fp32", "ptq8", "qat8", "ptq5", "qat5"}
    assert all(0.0 <= a <= 1.0 for a in accs.values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"FP32 test accuracy: {accs['fp32']:.4f}"
    for line, bits in zip(lines[1:], (8, 5)):
        assert line.startswith(f"PSI-INT{bits}: PTQ {accs[f'ptq{bits}']:.4f}")
        assert line.endswith("[paper: 0.0pp]")


def test_alexnet_tma_lines_equal_the_jax_model(capsys):
    rel = _load("alexnet_tma_torch").main(device="cpu")
    assert 0.0 < rel < 1.0
    layers = jtm.alexnet_layers()
    want = [f"AlexNet logits: PSI-INT5 vs FP32 relative error {rel:.4f}"]
    for bits in (5, 8):
        fps = jtm.frame_rate(layers, bits)
        e = jtm.energy_per_frame_j(layers, bits)
        want.append(f"TMA INT{bits}: {fps:5.1f} fps @200 MHz, "
                    f"{e * 1e3:.2f} mJ/frame @250 MHz/1.0 V, "
                    f"{jtm.macs_per_watt(bits) / 1e12:.2f} TMACs/W")
    ey = sum(jbl.EYERISS.layer_time_s(layer) for layer in layers[:5])
    t5 = sum(r.time_s for r in jtm.analyze_network(layers[:5], 5))
    want.append(f"conv1-5 vs Eyeriss: {ey / t5:.1f}x faster (INT5)")
    assert capsys.readouterr().out.strip().splitlines() == want
