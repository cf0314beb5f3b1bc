"""The port's PSI format and quantizer against the JAX package: codes,
bit-planes, scales, row unpacking and whole-tree quantization must be
bit-equal for the same float weights, at every registered width."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi as jpsi
from repro.core import quantizer as jq
from repro_torch.core import psi as tpsi
from repro_torch.core import quantizer as tq

torch.set_num_threads(1)

BITS = [2, 3, 4, 5, 6, 7, 8]


def _weights(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_format_registry_matches(bits):
    jf, tf = jpsi.get_format(bits), tpsi.get_format(bits)
    assert (jf.n_psi, jf.max_exp, jf.w_min, jf.w_max, jf.exact) == \
        (tf.n_psi, tf.max_exp, tf.w_min, tf.w_max, tf.exact)
    assert jf.worst_case_rel_error == tf.worst_case_rel_error
    np.testing.assert_array_equal(jf.decomposition_table(),
                                  tf.decomposition_table())


@pytest.mark.parametrize("bits", BITS)
def test_quantize_weights_bit_equal(bits):
    w = _weights(bits, (48, 40))
    for axis in [(0,), (1,), None]:
        jqt = jpsi.quantize_weights(jnp.asarray(w), bits, axis=axis)
        tqt = tpsi.quantize_weights(torch.from_numpy(w), bits, axis=axis)
        np.testing.assert_array_equal(np.asarray(jqt.data),
                                      tqt.data.numpy())
        np.testing.assert_array_equal(np.asarray(jqt.scale),
                                      tqt.scale.numpy())
        np.testing.assert_array_equal(
            np.asarray(jqt.dequantize(jnp.float32)),
            tqt.dequantize(torch.float32).numpy())


@pytest.mark.parametrize("bits", BITS[:-1])
def test_planes_and_unpack_bit_equal(bits):
    w = _weights(10 + bits, (2, 64, 24))                  # stacked leaf
    jqt = jpsi.quantize_weights(jnp.asarray(w), bits, axis=(1,))
    tqt = tpsi.quantize_weights(torch.from_numpy(w), bits, axis=(1,))
    jp, tp = jqt.pack(), tqt.pack()
    np.testing.assert_array_equal(np.asarray(jp.data), tp.data.numpy())
    np.testing.assert_array_equal(tp.codes.numpy(), tqt.data.numpy())
    # rows of an unstacked packed table, in any order and with repeats
    table = jpsi.quantize_weights(jnp.asarray(w[0]), bits, axis=(1,)).pack()
    ids = np.array([[0, 63, 7], [8, 8, 31]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jpsi.unpack_rows(table.data, jnp.asarray(ids), bits)),
        tpsi.unpack_rows(torch.from_numpy(np.array(table.data)),
                         torch.from_numpy(ids), bits).numpy())


def _jax_tree():
    rng = np.random.default_rng(0)
    return {
        "embed": jnp.asarray(rng.normal(size=(64, 16)), jnp.float32),
        "stack": {"groups": {"b0_attn": {
            "attn": {"wq": jnp.asarray(rng.normal(size=(2, 16, 24)),
                                       jnp.float32),
                     "q_norm_scale": jnp.ones((2, 8), jnp.float32)},
            "mlp": {"w_down": jnp.asarray(rng.normal(size=(2, 32, 16)),
                                          jnp.float32)},
            "norm1": {"scale": jnp.ones((2, 16), jnp.float32)}}}},
        "lm_head": jnp.asarray(rng.normal(size=(16, 64)), jnp.float32),
    }


def _torch_tree(jt):
    if isinstance(jt, dict):
        return {k: _torch_tree(v) for k, v in jt.items()}
    if isinstance(jt, list):
        return [_torch_tree(v) for v in jt]
    return torch.from_numpy(np.array(jt))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("bits,pack,policy", [
    (8, False, None), (5, True, None), (3, True, None), (4, False, None),
    (None, True, "embed=8,w_down=5,default=4"),
    (6, True, {"wq": 0, "lm_head": 2}),
])
def test_quantize_param_tree_bit_equal(bits, pack, policy):
    jt = _jax_tree()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout = _flat(jq.quantize_param_tree(jt, bits, pack=pack,
                                            policy=policy))
        tout = _flat(tq.quantize_param_tree(_torch_tree(jt), bits, pack=pack,
                                            policy=policy))
    assert jout.keys() == tout.keys()
    for k, jl in jout.items():
        tl = tout[k]
        if isinstance(jl, jpsi.QuantizedTensor):
            assert isinstance(tl, tpsi.QuantizedTensor), k
            assert (jl.fmt.bits, jl.packed) == (tl.fmt.bits, tl.packed), k
            np.testing.assert_array_equal(np.asarray(jl.data),
                                          tl.data.numpy())
            np.testing.assert_array_equal(np.asarray(jl.scale),
                                          tl.scale.numpy())
        else:
            assert isinstance(tl, torch.Tensor), k
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert jq.quantized_bytes(jq.quantize_param_tree(
        jt, bits, pack=pack, policy=policy)) == tq.quantized_bytes(
        tq.quantize_param_tree(_torch_tree(jt), bits, pack=pack,
                               policy=policy))


def test_parse_rules_match():
    for mode in ["none", "psi8", "psi5", "qat4"]:
        assert jq.parse_quant_mode(mode) == tq.parse_quant_mode(mode)
    spec = "embed=8, w_down=4,default=5"
    assert jq.parse_policy(spec) == tq.parse_policy(spec)
    for bad in ["psi9", "int8"]:
        with pytest.raises(ValueError):
            tq.parse_quant_mode(bad)
    with pytest.raises(ValueError):
        tq.parse_policy("embed")
    assert jq.serving_mode_choices() == tq.serving_mode_choices()
