"""The paper's networks and accelerator models in the port against the
JAX package: LeNet-5 forward and gradients at fp32, qat5 and psi5 /
psi8, ``quantize_cnn`` codes, AlexNet's forward at batch 2 (fp32 and
psi8), three SGD steps of LeNet-5, and every public function of
``tma_model`` / ``baselines``.

Params come from the JAX ``init_cnn``, carried across unchanged
(``interop.cnn_params_from_numpy``); images from a numpy seed.
Tolerances: logits within 1e-5 of the largest logit (f32 convolutions
sum in other orders: oneDNN against XLA), gradients within 1e-4 of each
leaf's largest reference gradient plus 1e-7, codes and scales
bit-equal, the accelerator models' numbers equal."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import tma_model as jtma
from repro.core.psi import QuantizedTensor
from repro.models import cnn as jcnn
from repro_torch.core import baselines as tbase
from repro_torch.core import psi as tpsi
from repro_torch.core import tma_model as ttma
from repro_torch.interop import cnn_params_from_numpy
from repro_torch.models import cnn as tcnn
from repro_torch.core.quantizer import tree_leaves

torch.set_num_threads(1)

LOGIT_REL = 1e-5
GRAD_REL = 1e-4
GRAD_ATOL = 1e-7


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _sorted_leaves(tree):
    """Leaves in sorted-key order, as JAX flattens a dict."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _setup(jcfg, tcfg, B, seed=0):
    params = jcnn.init_cnn(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=(B,) + jcfg.in_shape).astype(np.float32)
    y = rng.integers(0, jcfg.n_classes, size=(B,)).astype(np.int32)
    return params, cnn_params_from_numpy(np_tree(params), "cpu"), x, y


@pytest.mark.parametrize("mode", ["none", "qat5", "qat8", "psi5", "psi8"])
def test_lenet5_forward_and_gradients_match_jax(mode):
    jcfg = dataclasses.replace(jcnn.LENET5, quant_mode=mode)
    tcfg = dataclasses.replace(tcnn.LENET5, quant_mode=mode)
    jp, tp, x, y = _setup(jcfg, tcfg, 16)
    jl = np.asarray(jcnn.cnn_forward(jp, jnp.asarray(x), jcfg))
    tl = tcnn.cnn_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=0,
                               atol=LOGIT_REL * np.abs(jl).max())
    batch = {"images": x, "labels": y}
    (jloss, jm), jg = jax.value_and_grad(jcnn.cnn_loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = _sorted_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tm = tcnn.cnn_loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max()
                                   + GRAD_ATOL)


@pytest.mark.parametrize("bits", [5, 8])
def test_quantize_cnn_codes_bit_equal_and_serve(bits):
    jcfg = dataclasses.replace(jcnn.LENET5, quant_mode=f"psi{bits}")
    tcfg = dataclasses.replace(tcnn.LENET5, quant_mode=f"psi{bits}")
    jp, tp, x, _ = _setup(jcfg, tcfg, 8, seed=1)
    jq, tq = jcnn.quantize_cnn(jp, bits), tcnn.quantize_cnn(tp, bits)
    for layer in jq:
        for name, leaf in jq[layer].items():
            got = tq[layer][name]
            if isinstance(leaf, QuantizedTensor):
                assert isinstance(got, tpsi.QuantizedTensor)
                np.testing.assert_array_equal(got.data.numpy(),
                                              np.asarray(leaf.data))
                np.testing.assert_array_equal(got.scale.numpy(),
                                              np.asarray(leaf.scale))
            else:
                assert isinstance(got, torch.Tensor)
    # the serving leaves' forward equals the fake-quant forward's grid
    jl = np.asarray(jcnn.cnn_forward(jq, jnp.asarray(x), jcfg))
    tl = tcnn.cnn_forward(tq, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=LOGIT_REL * np.abs(jl).max())
    tf = tcnn.cnn_forward(tp, torch.from_numpy(x), tcfg).detach().numpy()
    np.testing.assert_allclose(tl, tf, rtol=0,
                               atol=LOGIT_REL * np.abs(tf).max())


@pytest.mark.parametrize("mode", ["none", "psi8"])
def test_alexnet_forward_matches_jax(mode):
    """AlexNet at its published shape (227 x 227 x 3, grouped convs, 1000
    classes), batch 2: the NHWC flatten before fc0 and the contiguous
    channel groups of both conv APIs."""
    jcfg = dataclasses.replace(jcnn.ALEXNET, quant_mode=mode)
    tcfg = dataclasses.replace(tcnn.ALEXNET, quant_mode=mode)
    jp, tp, x, _ = _setup(jcfg, tcfg, 2, seed=2)
    if mode != "none":
        jp = jcnn.quantize_cnn(jp, 8)
        tp = cnn_params_from_numpy(np_tree(jp), "cpu")
    jl = np.asarray(jax.jit(lambda p, a: jcnn.cnn_forward(p, a, jcfg))(
        jp, jnp.asarray(x)))
    with torch.no_grad():
        tl = tcnn.cnn_forward(tp, torch.from_numpy(x), tcfg).numpy()
    assert tl.shape == (2, 1000)
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=LOGIT_REL * np.abs(jl).max())


def test_lenet5_sgd_steps_match_jax():
    """Three plain SGD steps (``examples/train_lenet_qat.py``'s update, lr
    0.05) at qat8 from the same params: losses within 1e-5 relative,
    params within 1e-5 of each leaf's largest magnitude."""
    from repro.data.pipeline import synthetic_mnist
    jcfg = dataclasses.replace(jcnn.LENET5, quant_mode="qat8")
    tcfg = dataclasses.replace(tcnn.LENET5, quant_mode="qat8")
    jp, tp, _, _ = _setup(jcfg, tcfg, 1, seed=3)
    xs, ys = synthetic_mnist(96, seed=1)
    lr = 0.05
    step = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: jcnn.cnn_loss(q, b, jcfg)[0])(p))
    leaves = _sorted_leaves(tp)
    for i in range(3):
        rows = slice(32 * i, 32 * (i + 1))
        b = {"images": xs[rows], "labels": ys[rows]}
        jl, jg = step(jp, {k: jnp.asarray(v) for k, v in b.items()})
        jp = jax.tree_util.tree_map(lambda a, g: a - lr * g, jp, jg)
        for t in leaves:
            t.requires_grad_(True)
        tl, _ = tcnn.cnn_loss(tp, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, tcfg)
        grads = torch.autograd.grad(tl, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(lr * g)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for t, w in zip(leaves, jax.tree_util.tree_leaves(jp)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_cnn_params_and_init_shapes():
    jp = jcnn.init_cnn(jcnn.ALEXNET, jax.random.PRNGKey(0))
    tp = tcnn.init_cnn(tcnn.ALEXNET, 0, "cpu")
    assert list(tp) == list(jp)
    for k in jp:
        for n in jp[k]:
            assert tuple(tp[k][n].shape) == jp[k][n].shape, (k, n)
            assert tp[k][n].dtype == torch.float32
    w = tp["conv0"]["convk"]
    assert abs(float(w.std()) - (11 * 11 * 3) ** -0.5) < 0.01
    assert tp["fc0"]["w"].shape == (9216, 4096)


# ------------------------------------------------------- accelerator models
def _report_tuple(r):
    return (r.name, r.macs, r.cycles, r.time_s, r.gmacs, r.utilization,
            r.psum_sram_accesses)


def _layers(mod):
    return {"alexnet": mod.alexnet_layers(), "lenet5": mod.lenet5_layers()}


def test_tma_model_numbers_equal_the_reference():
    assert (ttma.NE_COLS, ttma.NE_ROWS, ttma.NE_DEPTH, ttma.SAMS_PER_NE,
            ttma.MACS_PARALLEL, ttma.SRAM_BYTES, ttma.FIFO_BYTES,
            ttma.N_FIFOS, ttma.FPGA_FREQ_HZ, ttma.ASIC_FREQ_HZ,
            ttma.ASIC_POWER_W, ttma.GATE_COUNT, ttma.ACC_PASSES) == (
        jtma.NE_COLS, jtma.NE_ROWS, jtma.NE_DEPTH, jtma.SAMS_PER_NE,
        jtma.MACS_PARALLEL, jtma.SRAM_BYTES, jtma.FIFO_BYTES, jtma.N_FIFOS,
        jtma.FPGA_FREQ_HZ, jtma.ASIC_FREQ_HZ, jtma.ASIC_POWER_W,
        jtma.GATE_COUNT, jtma.ACC_PASSES)
    tl, jl = _layers(ttma), _layers(jtma)
    for net in tl:
        assert [dataclasses.astuple(a) for a in tl[net]] == [
            dataclasses.astuple(b) for b in jl[net]]
        for a, b in zip(tl[net], jl[net]):
            assert a.macs == b.macs
            if isinstance(b, jtma.ConvLayer):
                assert (a.H_out, a.W_out, a.outputs) == (b.H_out, b.W_out,
                                                         b.outputs)
            for bits in (5, 8):
                assert ttma.layer_cycles(a, bits) == jtma.layer_cycles(b,
                                                                       bits)
            assert ttma.psum_sram_accesses_tma(a) == \
                jtma.psum_sram_accesses_tma(b)
        for bits in (5, 8):
            for freq, batch in ((ttma.FPGA_FREQ_HZ, 1),
                                (ttma.ASIC_FREQ_HZ, 4)):
                assert [_report_tuple(r) for r in ttma.analyze_network(
                    tl[net], bits, freq, batch)] == [
                    _report_tuple(r) for r in jtma.analyze_network(
                        jl[net], bits, freq, batch)]
            assert ttma.frame_rate(tl[net], bits) == jtma.frame_rate(
                jl[net], bits)
            for f, v in ((250e6, 1.0), (200e6, 0.9)):
                assert ttma.energy_per_frame_j(tl[net], bits, f, v) == \
                    jtma.energy_per_frame_j(jl[net], bits, f, v)
        assert ttma.check_fifo_capacity(tl[net]) == \
            jtma.check_fifo_capacity(jl[net])
        assert ttma.psum_sram_requirement_bytes(tl[net]) == \
            jtma.psum_sram_requirement_bytes(jl[net])
    for bits in (5, 8):
        for f in (200e6, 250e6):
            assert ttma.peak_throughput_gmacs(bits, f) == \
                jtma.peak_throughput_gmacs(bits, f)
            assert ttma.macs_per_watt(bits, f, 0.9) == jtma.macs_per_watt(
                bits, f, 0.9)
    assert ttma.power_w(200e6, 1.1) == jtma.power_w(200e6, 1.1)
    assert ttma.gate_count_model() == jtma.gate_count_model()
    for R in (1, 3, 5, 11, 12):
        assert ttma._conv_config(R, R) == jtma._conv_config(R, R)
    with pytest.raises(ValueError):
        ttma._conv_config(13, 13)
    # the paper's peak: 576 GMACS at INT5, 288 at INT8 (250 MHz)
    assert math.isclose(ttma.peak_throughput_gmacs(5), 576.0)
    assert math.isclose(ttma.peak_throughput_gmacs(8), 288.0)


def test_baselines_numbers_equal_the_reference():
    assert list(tbase.BASELINES) == list(jbase.BASELINES)
    for name in tbase.BASELINES:
        a, b = tbase.BASELINES[name], jbase.BASELINES[name]
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.gmacs_per_watt() == b.gmacs_per_watt()
        for la, lb in zip(ttma.alexnet_layers(), jtma.alexnet_layers()):
            for batch in (1, 4):
                assert a.layer_time_s(la, batch) == b.layer_time_s(lb, batch)
                assert a.layer_cycles(la, batch) == b.layer_cycles(lb, batch)
                assert a.psum_sram_accesses(la, batch) == \
                    b.psum_sram_accesses(lb, batch)
    for f in (250e6, 200e6):
        assert tbase.table3_rows(f) == jbase.table3_rows(f)
