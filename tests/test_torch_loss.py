"""``Model.loss`` and its gradients against the JAX package's
``jax.value_and_grad(model.loss)``, one reduced config of each family
(dense, MoE, SSM, hybrid, encoder-decoder, VLM) under ``qat8`` (the
straight-through fake-quant in every linear, the MoE experts and the
tied head), and the dense one under ``none``.  Params come from the JAX
``init`` (f32), carried across by interop; the batch from a numpy seed.

Tolerances: the losses within 1e-5 relative (f32; the stacks sum in
other orders), every gradient leaf within 1e-4 of the largest magnitude
of that leaf's reference gradient plus 1e-6 (an f32 rounding difference
can flip a fake-quant code at a grid boundary: the STE passes the
gradient through unchanged, so only the forward's activations move, by
one code step of one weight)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as tbuild_model
from repro_torch.core.quantizer import tree_leaves, tree_map

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_ATOL = 1e-6
S = 16
B = 2


def np_tree(t):
    """The neutral numpy form of a JAX tree (interop's input)."""
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree (JAX trees come back
    with sorted dict keys: leaves are matched by path, not order)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _batch(cfg, seed=3):
    """{"tokens"} and the family's inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.normal(size=(B, cfg.vision_patches,
                                                 cfg.d_model))
                                * cfg.d_model ** -0.5).astype(np.float32)
        # distinct M-RoPE streams (the 2:1:1 split) as well as the splice
        t = np.arange(S)
        out["positions"] = np.stack([t, t // 2, t % 4])[None].repeat(
            B, 0).astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(B, cfg.enc_frames, cfg.d_model))
                         * cfg.d_model ** -0.5).astype(np.float32)
    return out


def loss_and_grads(arch, quant):
    """(JAX (loss, ce, aux), its grads in the port's layout; the port's
    (loss, ce, aux) and grads)."""
    cfg = reduced_config(get_config(arch), quant_mode=quant)
    model = build_model(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = params_from_numpy(np_tree(jg), device="cpu")

    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch),
                                   quant_mode=quant)
    tm = tbuild_model(tcfg)
    tp = params_from_numpy(np_tree(params), device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    tgrads = torch.autograd.grad(tl, leaves)
    it = iter(tgrads)
    tgrads = flat(tree_map(lambda _: next(it), tp))
    return ((float(jl), float(jm["ce"]), float(jm["aux"])), flat(jgrads),
            tuple(float(v.detach()) for v in (tl, tmet["ce"], tmet["aux"])),
            tgrads)


@pytest.mark.parametrize("arch,quant", [
    ("qwen3-8b", "none"),
    ("qwen3-8b", "qat8"),
    ("qwen3-moe-30b-a3b", "qat8"),
    ("falcon-mamba-7b", "qat8"),
    ("recurrentgemma-9b", "qat8"),
    ("whisper-base", "qat8"),
    ("qwen2-vl-2b", "qat8"),
], ids=["dense-none", "dense-qat8", "moe", "ssm", "hybrid", "encdec",
        "vlm"])
def test_loss_and_grads_match_jax(arch, quant):
    jv, jgrads, tv, tgrads = loss_and_grads(arch, quant)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL, atol=1e-7)
    if arch.startswith("qwen3-moe"):
        assert tv[2] > 0                      # the aux loss reaches the sum
    else:
        assert tv[2] == 0
    assert set(jgrads) == set(tgrads)
    for path, jg in jgrads.items():
        jg, tg = jg.numpy(), tgrads[path]
        assert tg.shape == jg.shape, path
        tol = GRAD_REL * np.abs(jg).max() + GRAD_ATOL
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=tol,
                                   err_msg=path)


def test_loss_graph_reaches_every_leaf_and_qat_changes_the_forward():
    """Under qat8 the forward differs from the float one (the codes'
    grid) while each leaf still gets a gradient; the serving path's float
    product (quant none) is unchanged by the QAT route."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"))
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    params = tbuild_model(cfg).init(0, "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    l_none, _ = tbuild_model(cfg).loss(params, batch)
    qcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="qat8")
    l_qat, _ = tbuild_model(qcfg).loss(params, batch)
    assert float(l_none.detach()) != float(l_qat.detach())
    grads = torch.autograd.grad(l_qat, leaves)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
