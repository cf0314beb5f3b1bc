"""The paper's multiplier-less arithmetic in the port against the JAX
package: the PSI value tables, the weight decomposition (Fig. 6) and its
reconstruction, the SAM (Fig. 2) over every INT8 x INT8 and INT5 x INT8
pair, the MOA's sign-extension sum (Appendix), INT8 activations, INT5
packing, the shared dequantize, the registry helpers, and the Table-I
entry points of the PSI matmul (``ops.psi_matmul_int5``, the ``*_ref``
and ``*_dequant`` forms) with the Pallas kernel in interpret mode.

The integer arithmetic, codes, scales and dequantized values are held
bit-equal; the matmuls to ``F32`` (f32 sums in another order).  Inputs
come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_configs as jlist_configs
from repro.core import psi as jpsi
from repro.core import quantizer as jquant
from repro.kernels import psi_matmul as jpk
from repro.kernels import ref as jref
from repro_torch.configs import list_configs as tlist_configs
from repro_torch.core import psi as tpsi
from repro_torch.core import quantizer as tquant
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# f32 sums in another order: ~K * 2^-24 relative on outputs of size ~sqrt(K)
F32 = dict(rtol=1e-5, atol=1e-5)
INT8 = np.arange(-128, 128, dtype=np.int32)
INT5 = np.arange(-16, 16, dtype=np.int32)


def _eq(got: torch.Tensor, want) -> None:
    """Same dtype (by name) and the same bits."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name, (got.dtype,
                                                              want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ value tables
@pytest.mark.parametrize("bits", tpsi.registered_bits())
def test_value_table_bit_equal_at_every_width(bits):
    got = tpsi.psi_value_table(bits)
    want = jpsi.psi_value_table(bits)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tpsi.get_format(bits).name == jpsi.get_format(bits).name


@pytest.mark.parametrize("bits", [5, 8])
def test_value_table_term_budget_override(bits):
    """n_psi 1..4 bit-equal, and the worst error never grows with the
    budget (the monotone-error property the reference's override feeds)."""
    w = np.arange(-(1 << (bits - 1)), 1 << (bits - 1))
    worst = []
    for n in range(1, 5):
        got = tpsi.psi_value_table(bits, n_psi=n)
        np.testing.assert_array_equal(got, jpsi.psi_value_table(bits, n))
        worst.append(np.max(np.abs(got - w) / np.maximum(np.abs(w), 1)))
    assert all(b <= a for a, b in zip(worst, worst[1:])), worst
    assert worst[-1] == 0.0


def test_int5_table_is_table_one():
    """+-11 -> +-10 and +-13 -> +-12, every other INT5 code exact."""
    vals = tpsi.psi_value_table(5)
    off = {int(w): int(v) for w, v in zip(INT5, vals) if w != v}
    assert off == {-13: -12, -11: -10, 11: 10, 13: 12}


# ------------------------------------------- decomposition (Fig. 6) and back
@pytest.mark.parametrize("bits", [5, 8])
def test_decompose_and_reconstruct_every_code(bits):
    w = np.arange(-(1 << (bits - 1)), 1 << (bits - 1),
                  dtype=np.int32).reshape(-1, 4)
    signs, exps = tpsi.psi_decompose_int(torch.from_numpy(w), bits)
    jsigns, jexps = jpsi.psi_decompose_int(jnp.asarray(w), bits)
    _eq(signs, jsigns)
    _eq(exps, jexps)
    assert signs.shape == (tpsi.get_format(bits).n_psi,) + w.shape
    rec = tpsi.psi_reconstruct(signs, exps)
    _eq(rec, jpsi.psi_reconstruct(jsigns, jexps))
    np.testing.assert_array_equal(
        rec.numpy().reshape(-1), tpsi.psi_value_table(bits))


# ------------------------------------------------------------ SAM (Fig. 2)
@pytest.mark.parametrize("bits,w_range", [(8, INT8), (5, INT5)])
def test_sam_every_weight_activation_pair(bits, w_range):
    """One vectorised call over every (w, x) pair: bit-equal to the JAX
    SAM, and to w' * x with w' the value table's entry (exact at INT8;
    at INT5 the error rows are Table I's four codes)."""
    x = INT8.astype(np.int8)[None, :]
    w = w_range[:, None]
    signs, exps = tpsi.psi_decompose_int(torch.from_numpy(w), bits)
    got = tpsi.sam_multiply(torch.from_numpy(x), signs, exps)
    jsigns, jexps = jpsi.psi_decompose_int(jnp.asarray(w), bits)
    _eq(got, jpsi.sam_multiply(jnp.asarray(x), jsigns, jexps))
    assert got.shape == (len(w_range), 256)
    table = tpsi.psi_value_table(bits)[:, None]
    np.testing.assert_array_equal(got.numpy(), table * x.astype(np.int32))
    wrong = w_range[(got.numpy() != w * x.astype(np.int32)).any(axis=1)]
    assert set(wrong.tolist()) == (set() if bits == 8
                                   else {-13, -11, 11, 13})


# ----------------------------------------------------------- MOA (Appendix)
@pytest.mark.parametrize("in_bits,out_bits", [(5, 18), (13, 18), (13, 14)])
def test_moa_sign_extension_sum(in_bits, out_bits):
    """18-operand sets: bit-equal to the JAX MOA; the plain sum where it
    fits out_bits, and wrapped two's complement where it does not
    (13 -> 14 bits)."""
    rng = np.random.default_rng(in_bits * 100 + out_bits)
    ops_ = rng.integers(-(1 << (in_bits - 1)), 1 << (in_bits - 1),
                        size=(18, 64, 8)).astype(np.int32)
    got = tpsi.moa_sign_extension_sum(torch.from_numpy(ops_), in_bits,
                                      out_bits)
    _eq(got, jpsi.moa_sign_extension_sum(jnp.asarray(ops_), in_bits,
                                         out_bits))
    total = ops_.sum(axis=0)
    mod = 1 << out_bits
    wrapped = (total + mod // 2) % mod - mod // 2
    np.testing.assert_array_equal(got.numpy(), wrapped)
    if out_bits == 18:
        np.testing.assert_array_equal(got.numpy(), total)
    else:
        assert (wrapped != total).any()


# ------------------------------------------------------ INT8 activations
@pytest.mark.parametrize("shape,spread", [((1000,), 1.0), ((4, 64, 33), 3.0),
                                          ((7, 5), 1e4), ((16,), 1e-12)])
def test_quantize_activations_int8_bit_equal(shape, spread):
    rng = np.random.default_rng(len(shape) * 7 + int(np.log10(spread) + 20))
    x = (rng.normal(size=shape) * spread).astype(np.float32)
    q, scale = tpsi.quantize_activations_int8(torch.from_numpy(x))
    jq, jscale = jpsi.quantize_activations_int8(jnp.asarray(x))
    _eq(q, jq)
    _eq(scale, jscale)
    assert scale.dim() == 0


# ---------------------------------------------------------------- INT5 pack
def test_pack_unpack_int5_bit_equal():
    rng = np.random.default_rng(5)
    codes = rng.integers(-16, 16, size=(3, 40, 12)).astype(np.int8)
    planes = tpsi.pack_int5(torch.from_numpy(codes))
    _eq(planes, jpsi.pack_int5(jnp.asarray(codes)))
    assert planes.shape == (3, 5, 5, 12)
    _eq(tpsi.unpack_int5(planes), codes)


# ------------------------------------------ QuantizedTensor and dequantize
def _jqt(seed, shape, bits, packed=False):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    q = jpsi.quantize_weights(jnp.asarray(w), bits,
                              axis=(len(shape) - 2,))
    return q.pack() if packed else q


def _tqt(jq):
    return tpsi.QuantizedTensor(torch.from_numpy(np.array(jq.data)),
                                torch.from_numpy(np.array(jq.scale)),
                                tpsi.get_format(jq.fmt.bits), jq.packed)


@pytest.mark.parametrize("bits,packed", [(8, False), (5, True), (3, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_bit_equal(bits, packed, dtype):
    jq = _jqt(bits * 3 + packed, (2, 24, 20), bits, packed)
    tq = _tqt(jq)
    assert (tq.bits, tq.ndim, tq.shape) == (jq.bits, jq.ndim, jq.shape)
    got = tquant.dequantize(tq, getattr(torch, dtype))
    want = np.asarray(jquant.dequantize(jq, getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert tquant.dequantize_leaf is tquant.dequantize
    plain = torch.ones(3)
    assert tquant.dequantize(plain) is plain


def test_registry_helpers_match():
    assert tquant.quant_mode_choices() == jquant.quant_mode_choices()
    assert tlist_configs() == jlist_configs()


# --------------------------------------- the Table-I entry points, CPU route
@pytest.mark.parametrize("M,K,N", [(3, 40, 36), (16, 64, 256)])
def test_psi_matmul_int5_matches_jax_interpret(M, K, N):
    """ops.psi_matmul_int5 on a CPU tensor (the plain version) against the
    Pallas INT5 kernel in interpret mode and the JAX oracle; it launches
    no kernel."""
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jq = _jqt(K * N, (K, N), 5, packed=True)
    planes, scale = np.array(jq.data), np.array(jq.scale)
    before = ops.launch_counts()
    got = ops.psi_matmul_int5(torch.from_numpy(x), torch.from_numpy(planes),
                              torch.from_numpy(scale)).numpy()
    assert ops.launch_counts() == before
    interp = np.asarray(jpk.psi_matmul_int5(jnp.asarray(x), jq.data,
                                            jq.scale, interpret=True))
    np.testing.assert_allclose(got, interp, **F32)
    np.testing.assert_allclose(
        got, np.asarray(jref.psi_matmul_int5_ref(jnp.asarray(x), jq.data,
                                                 jq.scale)), **F32)


def test_psi_matmul_int5_routes_by_device_only():
    """A tensor on neither the CPU nor a card has no route."""
    x = torch.empty((2, 8), device="meta")
    planes = torch.empty((5, 1, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.psi_matmul_int5(x, planes, torch.empty(4, device="meta"))


@pytest.mark.parametrize("name,bits,packed", [
    ("psi_matmul_int8_ref", 8, False), ("psi_matmul_int5_ref", 5, True),
    ("psi_matmul_codes_dequant", 8, False),
    ("psi_matmul_codes_dequant", 5, False),
    ("psi_matmul_packed_dequant", 3, True),
    ("psi_matmul_int8_dequant", 8, False),
    ("psi_matmul_int5_dequant", 5, True)])
def test_ref_and_dequant_forms_match_jax(name, bits, packed):
    rng = np.random.default_rng(bits * 11 + packed)
    x = rng.normal(size=(7, 72)).astype(np.float32)
    jq = _jqt(bits + 40, (72, 100), bits, packed)
    args = [jnp.asarray(x), jq.data, jq.scale]
    targs = [torch.from_numpy(x), torch.from_numpy(np.array(jq.data)),
             torch.from_numpy(np.array(jq.scale))]
    if name == "psi_matmul_packed_dequant":
        args.append(bits)
        targs.append(bits)
    got = getattr(tref, name)(*targs)
    assert got.dtype == torch.float32 and got.shape == (7, 100)
    want = np.asarray(getattr(jref, name)(*args))
    np.testing.assert_allclose(got.numpy(), want, **F32)
