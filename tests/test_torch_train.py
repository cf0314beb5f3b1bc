"""The port's training path against the JAX package on the CPU: the
straight-through fake-quant, AdamW / SGD / the cosine schedule / the
global-norm clip, int8 gradient compression, the token stream and the
procedural digits, checkpoints written by either package and restored by
the other, the straggler monitor, ``train()`` against the reference's
``train()``, resume, and the CLI.

Tolerances (stated per check below): bit-equal where both packages do the
same f32 operations in the same order (fake-quant codes, compression
codes, the data); optimizer states within a few f32 ulps over three
steps (XLA may fuse a multiply-add; ``b ** step`` is computed by two
libraries); ``train()`` loss histories within 1e-3 relative (Adam's
``m / sqrt(v)`` turns a rounding-size gradient difference into an update
of size lr, and a fake-quant boundary can flip a code)."""
import importlib
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config, reduced_config
from repro.core import psi as jpsi
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import build_model
from repro.optim import compress as jcomp
from repro.runtime.straggler import StragglerMonitor as JMonitor
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.core import psi as tpsi
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import opt_state_from_numpy, params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.optim import compress as tcomp
from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.runtime.straggler import StragglerMonitor as TMonitor

# the modules (each package's optim/__init__ binds the name "adamw" to
# the optimizer class)
jadamw_mod = importlib.import_module("repro.optim.adamw")
tadamw_mod = importlib.import_module("repro_torch.optim.adamw")

torch.set_num_threads(1)

HIST_RTOL = 1e-3           # train() loss histories, 6 steps
OPT_RTOL = 1e-6            # optimizer states after three steps
OPT_ATOL = 1e-9


def np_tree(t):
    if isinstance(t, jpsi.QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def _tree(rng):
    return {"a": rng.normal(size=(4, 8)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(8, 3)).astype(np.float32)}
                       for _ in range(2)],
            "b": (rng.normal(size=(5,)) * 0.1).astype(np.float32)}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees(got, want, rtol=0.0, atol=0.0):
    gl = [np.asarray(t) for t in tree_leaves(got)]
    wl = [np.asarray(t) for t in jax.tree_util.tree_leaves(want)]
    # both trees here have keys in sorted order ("a", "b", "layers")
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _sorted(tree):
    return {"a": tree["a"], "b": tree["b"], "layers": tree["layers"]}


# ------------------------------------------------------------------ the STE
@pytest.mark.parametrize("bits,axis,dtype", [
    (8, (0,), "float32"), (5, (0,), "float32"), (3, (1,), "float32"),
    (8, (0, 1, 2), "float32"), (5, None, "float32"),
    (8, (0,), "bfloat16")])
def test_fake_quant_ste_forward_bit_equal_and_gradient_identity(
        bits, axis, dtype):
    rng = np.random.default_rng(bits)
    shape = (3, 3, 4, 6) if axis == (0, 1, 2) else (16, 12)
    w = rng.normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jpsi.fake_quant_ste(jnp.asarray(w, jdt), bits, axis)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    got = tpsi.fake_quant_ste(wt, bits, axis)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    # the gradient is the incoming one, unchanged (JAX's custom_vjp too)
    c = rng.normal(size=shape).astype(np.float32)
    (g,) = torch.autograd.grad((got.to(torch.float32)
                                * torch.from_numpy(c)).sum(), wt)
    jg = jax.grad(lambda x: jnp.sum(
        jpsi.fake_quant_ste(x, bits, axis).astype(jnp.float32) * c))(
        jnp.asarray(w, jdt))
    np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                  np.asarray(jg, np.float32))
    np.testing.assert_array_equal(
        g.to(torch.float32).numpy(),
        torch.from_numpy(c).to(tdt).to(torch.float32).numpy())


# --------------------------------------------------------------- optimizers
def test_cosine_schedule_matches_jax():
    """The same f32 operations in the same order, but XLA's cos and
    torch's differ by an ulp at some angles, which the cancellation in
    ``1 + cos`` near the end of the schedule magnifies: every value
    within 2 f32 ulps of ``base_lr``."""
    for base, warm, total in ((3e-4, 2, 20), (1e-3, 10, 100), (0.05, 0, 7)):
        j = jadamw_mod.cosine_schedule(base, warm, total)
        t = tadamw_mod.cosine_schedule(base, warm, total)
        got = [t(s) for s in range(total + 3)]
        want = [float(j(s)) for s in range(total + 3)]
        np.testing.assert_allclose(got, want, rtol=0, atol=base * 2 ** -22)
        assert got[:warm + 1] == want[:warm + 1]      # the warmup exactly
        assert got[total:] == want[total:] == [0.0] * 3


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The norm within 1e-6 relative (the sums run in other orders), the
    clipped leaves within 1e-6."""
    tree = _tree(np.random.default_rng(1))
    jg, jn = jadamw_mod.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tg, tn = tadamw_mod.clip_by_global_norm(_torch(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees(_sorted(tg), jg, rtol=1e-6)


@pytest.mark.parametrize("opt", ["adamw", "adamw-const-lr", "sgd",
                                 "sgd-clip"])
def test_optimizer_steps_match_jax(opt):
    """Three steps from the same params and gradients: params and moments
    within OPT_RTOL (a few f32 ulps) after every step; the returned lr and
    grad norm too."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    if opt.startswith("adamw"):
        lr = (3e-3 if opt == "adamw-const-lr"
              else None)
        jo = jadamw_mod.adamw(lr=lr or jadamw_mod.cosine_schedule(
            3e-3, 1, 10), clip_norm=1.0)
        to = tadamw_mod.adamw(lr=lr or tadamw_mod.cosine_schedule(
            3e-3, 1, 10), clip_norm=1.0)
    else:
        clip = 1.0 if opt == "sgd-clip" else 0.0
        jo = jadamw_mod.sgd(lr=0.05, clip_norm=clip)
        to = tadamw_mod.sgd(lr=0.05, clip_norm=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                               jp)
        tp, ts, tm = to.update(_torch(g), ts, tp)
        assert ts.step == int(js.step)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _assert_trees(_sorted(tp), jp, OPT_RTOL, OPT_ATOL)
        _assert_trees(_sorted(ts.m), js.m, OPT_RTOL, OPT_ATOL)
        if opt.startswith("adamw"):
            _assert_trees(_sorted(ts.v), js.v, OPT_RTOL, OPT_ATOL)


def test_adamw_updates_in_place():
    """The port's update writes p, m and v in place (the JAX package
    returns new trees of the same values)."""
    tp = _torch(_tree(np.random.default_rng(3)))
    opt = tadamw_mod.adamw(lr=1e-2)
    st = opt.init(tp)
    ids = [id(t) for t in tree_leaves(tp)]
    before = [t.clone() for t in tree_leaves(tp)]
    out, st2, _ = opt.update(_torch(_tree(np.random.default_rng(4))), st, tp)
    assert [id(t) for t in tree_leaves(out)] == ids
    assert st2.m is st.m and st2.step == 1
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(tp)))


# -------------------------------------------------------------- compression
def test_compression_codes_bit_equal_with_error_feedback():
    """Three steps of error feedback: codes and scales bit-equal, the
    residuals too (the same f32 operations), the decompressed gradients
    equal; the payload is a quarter of f32 plus one scale a leaf."""
    rng = np.random.default_rng(5)
    jerr, terr = None, None
    for step in range(3):
        g = _tree(rng)
        if step == 1:
            g["b"][:] = 0.0                      # an all-zero leaf
        jc, jerr = jcomp.compress_gradients(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tc, terr = tcomp.compress_gradients(_torch(g), terr)
        for path in ("a", "b"):
            np.testing.assert_array_equal(tc[path]["q"].numpy(),
                                          np.asarray(jc[path]["q"]))
            assert float(tc[path]["scale"]) == float(jc[path]["scale"])
        for i in range(2):
            np.testing.assert_array_equal(
                tc["layers"][i]["w"]["q"].numpy(),
                np.asarray(jc["layers"][i]["w"]["q"]))
        _assert_trees(_sorted(terr), jerr)
        _assert_trees(_sorted(tcomp.decompress_gradients(tc)),
                      jcomp.decompress_gradients(jc))
        assert tcomp.compressed_bytes(tc) == jcomp.compressed_bytes(jc)
        assert tcomp.compressed_bytes(tc) == (32 + 5 + 2 * 24) + 4 * 4


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 2)])
def test_token_stream_bit_equal_and_resumes(host_id, num_hosts):
    j = jpipe.TokenStream(1000, 24, 8, seed=7, host_id=host_id,
                          num_hosts=num_hosts)
    t = tpipe.TokenStream(1000, 24, 8, seed=7, host_id=host_id,
                          num_hosts=num_hosts)
    for _ in range(3):
        np.testing.assert_array_equal(next(t), next(j))
    st = t.state_dict()
    want = [next(t) for _ in range(2)]
    r = tpipe.TokenStream(1000, 24, 8, host_id=host_id,
                          num_hosts=num_hosts)
    r.load_state_dict(st)
    assert r.state_dict() == st == j.state_dict()
    for w in want:
        np.testing.assert_array_equal(next(r), w)


def test_synthetic_mnist_bit_equal():
    for n, seed in ((64, 1), (33, 2)):
        ji, jl = jpipe.synthetic_mnist(n, seed)
        ti, tl = tpipe.synthetic_mnist(n, seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-vl-2b", "whisper-base"])
def test_make_batch_for_shapes(arch):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    gen = torch.Generator()
    gen.manual_seed(0)
    b = tpipe.make_batch_for(cfg, 2, 12, gen)
    jb = jpipe.make_batch_for(reduced_config(get_config(arch)), 2, 12,
                              jax.random.PRNGKey(0))
    assert set(b) == set(jb)
    for k in b:
        assert tuple(b[k].shape) == tuple(jb[k].shape), k
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab_size
    if "positions" in b:
        np.testing.assert_array_equal(b["positions"].numpy(),
                                      np.asarray(jb["positions"]))
    gen.manual_seed(0)
    again = tpipe.make_batch_for(cfg, 2, 12, gen)
    assert all(torch.equal(b[k], again[k]) for k in b)


# -------------------------------------------------------------- checkpoints
def _ckpt_tree(rng):
    """A tree with every record kind: QuantizedTensor leaves (codes and
    packed planes), nested lists, a tuple, an empty list, an int32
    scalar, a bf16 leaf."""
    w = rng.normal(size=(16, 8)).astype(np.float32)
    return w, {
        "params": {"w": w, "layers": [{"x": rng.normal(size=(3,)).astype(
            np.float32)}, {"x": np.arange(4, dtype=np.int32)}],
                   "empty": []},
        "pair": (np.ones((2,), np.int8), np.zeros((1, 2), np.float32)),
        "step": np.asarray(7, np.int32),
        "half": rng.normal(size=(3, 2)).astype(ml_dtypes.bfloat16),
    }


def _with_qt(tree, w, pkg):
    out = dict(tree)
    if pkg == "jax":
        out["q8"] = jpsi.quantize_weights(jnp.asarray(w), 8, axis=(0,))
        out["q5p"] = jpsi.quantize_weights(jnp.asarray(w), 5,
                                           axis=(0,)).pack()
    else:
        out["q8"] = tpsi.quantize_weights(torch.from_numpy(w), 8, axis=(0,))
        out["q5p"] = tpsi.quantize_weights(torch.from_numpy(w), 5,
                                           axis=(0,)).pack()
    return out


def _to_port(tree):
    """A numpy tree (bf16 through ml_dtypes) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _check_restored(got, want):
    """got: a port tree; want: the numpy tree it was written from."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _check_restored(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _check_restored(g, w)
    else:
        w = np.asarray(want)
        if w.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert got.numpy().dtype == w.dtype
            np.testing.assert_array_equal(got.numpy(), w)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    w, tree = _ckpt_tree(np.random.default_rng(6))
    jtree = _with_qt(tree, w, "jax")
    JManager(str(tmp_path)).save(3, jtree, extra={"step": 3,
                                                  "data": {"step": 3,
                                                           "seed": 0}})
    got, extra = TManager(str(tmp_path)).restore()
    assert extra == {"step": 3, "data": {"step": 3, "seed": 0}}
    _check_restored({k: v for k, v in got.items() if k[0] != "q"}, tree)
    for name, want in (("q8", jtree["q8"]), ("q5p", jtree["q5p"])):
        q = got[name]
        assert isinstance(q, tpsi.QuantizedTensor)
        assert (q.fmt.bits, q.packed, q.fmt.n_psi, q.fmt.max_exp) == (
            want.fmt.bits, want.packed, want.fmt.n_psi, want.fmt.max_exp)
        np.testing.assert_array_equal(q.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(q.scale.numpy(),
                                      np.asarray(want.scale))
    np.testing.assert_array_equal(
        got["q8"].data.numpy(),
        tpsi.quantize_weights(torch.from_numpy(w), 8, (0,)).data.numpy())


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    w, tree = _ckpt_tree(np.random.default_rng(7))
    ttree = _with_qt(_to_port(tree), w, "torch")
    TManager(str(tmp_path)).save(5, ttree, extra={"note": "port"})
    got, extra = JManager(str(tmp_path)).restore()
    assert extra == {"note": "port"}
    assert sorted(os.listdir(tmp_path)) == ["step_0000000005"]
    assert sorted(os.listdir(tmp_path / "step_0000000005")) == [
        "arrays.bin", "manifest.json"]
    for k in ("params", "pair", "step", "half"):
        want, g = tree[k], got[k]
        leaves_w = jax.tree_util.tree_leaves(want)
        leaves_g = jax.tree_util.tree_leaves(g)
        assert len(leaves_w) == len(leaves_g)
        for a, b in zip(leaves_g, leaves_w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(got["pair"], tuple) and got["params"]["empty"] == []
    want = jpsi.quantize_weights(jnp.asarray(w), 5, axis=(0,)).pack()
    assert isinstance(got["q5p"], jpsi.QuantizedTensor)
    assert got["q5p"].packed and got["q5p"].fmt.bits == 5
    np.testing.assert_array_equal(np.asarray(got["q5p"].data),
                                  np.asarray(want.data))
    np.testing.assert_array_equal(np.asarray(got["q8"].scale),
                                  ttree["q8"].scale.numpy())


@pytest.mark.parametrize("blocking", [True, False], ids=["sync", "async"])
def test_checkpoint_keep_k_keep_every_and_atomic(tmp_path, blocking):
    """keep=2, keep_every=4 over steps 1..9: the last two plus every
    fourth survive, as the JAX manager keeps; a leftover ``tmp.<step>``
    (a crash mid-save) is no checkpoint; an async save's snapshot is
    taken at the call (later in-place writes do not reach it)."""
    mgrs = {"port": TManager(str(tmp_path / "t"), keep=2, keep_every=4),
            "jax": JManager(str(tmp_path / "j"), keep=2, keep_every=4)}
    x = torch.zeros(3)
    for step in range(1, 10):
        x.fill_(float(step))
        mgrs["port"].save(step, {"x": x}, extra={"step": step},
                          blocking=blocking)
        x.fill_(-1.0)                      # after the call: not in the save
        mgrs["jax"].save(step, {"x": np.full(3, step, np.float32)},
                         extra={"step": step}, blocking=blocking)
    for m in mgrs.values():
        m.wait()
    assert mgrs["port"].all_steps() == mgrs["jax"].all_steps() == [4, 8, 9]
    for s in (4, 8, 9):
        got, extra = mgrs["port"].restore(s)
        assert extra == {"step": s}
        np.testing.assert_array_equal(got["x"].numpy(),
                                      np.full(3, s, np.float32))
    os.makedirs(tmp_path / "t" / "tmp.10")
    (tmp_path / "t" / "tmp.10" / "arrays.bin").write_bytes(b"partial")
    assert mgrs["port"].latest_step() == 9
    # a save over an existing step replaces it whole
    mgrs["port"].save(9, {"y": torch.ones(2)})
    got, _ = mgrs["port"].restore()
    assert set(got) == {"y"}
    with pytest.raises(FileNotFoundError):
        TManager(str(tmp_path / "empty")).restore()


def test_jax_train_state_checkpoint_carries_into_the_port(tmp_path):
    """A JAX train state (stacked layers, AdamW m / v) written by the JAX
    manager restores in the port's manager; interop unstacks params and
    moments alike, leaf for leaf bit-equal to the port's own carry of
    the params."""
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="qat8")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = jadamw_mod.adamw(lr=1e-3)
    st = opt.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 1e-3,
                                   params)
    params, st, _ = jax.jit(opt.update)(grads, st, params)
    JManager(str(tmp_path)).save(
        1, {"params": params, "opt": jtrain._opt_tree(st)},
        extra={"step": 1})
    tree, extra = TManager(str(tmp_path)).restore()
    numpy_tree = tree_map(lambda t: t.numpy(), tree)
    tp = params_from_numpy(numpy_tree["params"], "cpu")
    ts = opt_state_from_numpy(numpy_tree["opt"], "cpu")
    want = params_from_numpy(np_tree(params), "cpu")
    assert ts.step == 1 and extra == {"step": 1}
    for a, b in zip(tree_leaves(tp), tree_leaves(want)):
        assert torch.equal(a, b)
    wm = params_from_numpy(np_tree(st.m), "cpu")
    for a, b in zip(tree_leaves(ts.m), tree_leaves(wm)):
        assert torch.equal(a, b)
    assert [tuple(t.shape) for t in tree_leaves(ts.v)] == [
        tuple(t.shape) for t in tree_leaves(tp)]


# ---------------------------------------------------------------- straggler
def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(8)
    j, t = JMonitor(n_hosts=4), TMonitor(n_hosts=4)
    np.testing.assert_array_equal(t.input_weights(), j.input_weights())
    for i in range(8):
        times = rng.uniform(0.9, 1.1, 4)
        if i >= 2:
            times[2] *= 1.6                  # host 2 degrades
        assert t.observe(list(times)) == j.observe(list(times))
        np.testing.assert_array_equal(t.input_weights(), j.input_weights())
    assert t.observe([1.0, 1.0, 2.0, 1.0])["flagged_hosts"] == [2]


# ------------------------------------------------------------------ train()
def _jax_params(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_model(cfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_train_loss_history_matches_jax(compress):
    """Reduced qwen3-8b, qat8, 6 steps of batch 4 x 32 from the same
    params: the port's ``train()`` against the reference's, every loss
    within HIST_RTOL."""
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="qat8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="qat8")
    jp = _jax_params(cfg)
    tp = params_from_numpy(np_tree(jp), "cpu")
    _, jh = jtrain.train(cfg, 6, compress=compress, batch_size=4,
                         seq_len=32, log_every=100)
    _, th = ttrain.train(tcfg, 6, compress=compress, batch_size=4,
                         seq_len=32, log_every=100, device="cpu", params=tp)
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL)
    assert len(th) == 6 and all(np.isfinite(th))


def test_train_resume_is_bit_exact_on_the_cpu(tmp_path):
    """6 steps in one run (checkpoints at 3 and 6) against a fresh
    trainer resumed from step 3: the last three losses and the final
    params, optimizer state and stream state bit-equal."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                  quant_mode="qat8")
    kw = dict(batch_size=2, seq_len=16, log_every=100, device="cpu")
    d = tmp_path / "ck"
    p_full, h_full = ttrain.train(cfg, 6, ckpt_dir=str(d), save_every=3,
                                  **kw)
    full, full_extra = TManager(str(d)).restore(6)
    shutil.rmtree(d / "step_0000000006")
    p_res, h_res = ttrain.train(cfg, 6, ckpt_dir=str(d), save_every=3,
                                **kw)
    assert h_res == h_full[3:]
    for a, b in zip(tree_leaves(p_res), tree_leaves(p_full)):
        assert torch.equal(a.detach(), b.detach())
    res, res_extra = TManager(str(d)).restore(6)
    assert res_extra == full_extra == {"step": 6,
                                       "data": {"step": 6, "seed": 0}}
    for a, b in zip(tree_leaves(res), tree_leaves(full)):
        assert torch.equal(a, b)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen3-8b", "--reduced", "--quant", "qat8",
            "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    h = ttrain.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert len(h) == 3 and "held-out loss" in out and "final loss" in out
    h2 = ttrain.main(args + ["--steps", "5", "--compress-grads"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and len(h2) == 2
    assert TManager(str(tmp_path)).all_steps() == [3, 5]
    h3 = ttrain.main(args[:-2] + ["--steps", "1", "--n-layers", "1"])
    assert len(h3) == 1 and np.isfinite(h3[0])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_train_cli_without_device_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-8b", "--reduced", "--steps", "1"])
