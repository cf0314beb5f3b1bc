"""The port's partition rules against the JAX package's, leaf by leaf.

JAX's specs are computed on ``jax.sharding.AbstractMesh`` (no devices
needed) over ``jax.eval_shape`` trees of the full-width configs; the port's
on an ``AxisMesh`` of the same shape over meta-tensor trees (the
quantization runs on meta tensors: shapes only).  The JAX package stacks
layers (a leading replicated dim); the port keeps one dict a layer, so a
port leaf's spec is the JAX leaf's without that dim.  Also the shard maps,
``plan_remesh`` and ``local_shard``'s chunks (they reassemble the tensor,
and a slot-dim leaf's chunk i holds exactly the slots ``slot_shard_map``
gives shard i).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.core import quantizer as jqz
from repro.core.psi import QuantizedTensor as JQT
from repro.launch import scheduler as jsched
from repro.models import build_model as jbuild_model
from repro.runtime import elastic as jel
from repro.runtime import sharding as jshr
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced_config as treduced_config
from repro_torch.core import quantizer as tqz
from repro_torch.core.psi import QuantizedTensor as TQT
from repro_torch.launch import scheduler as tsched
from repro_torch.models import build_model as tbuild_model
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import sharding as tshr

MESHES = [((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
QUANTS = ((None, False), (8, True), (5, True))    # plain, psi8, packed psi5


def meshes():
    return [(AbstractMesh(s, n), tshr.AxisMesh(s, n)) for s, n in MESHES]


@functools.lru_cache(maxsize=None)
def jax_params(arch, bits):
    m = jbuild_model(jget_config(arch))
    p = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    if bits:
        p = jax.eval_shape(
            lambda t: jqz.quantize_param_tree(t, bits, pack=True), p)
    return p


def port_params(arch, bits, pack):
    """The port's param tree of ``arch`` in meta tensors (Model.init's
    structure and quantization, no data)."""
    model = tbuild_model(tget_config(arch))
    params = {"layers": [{} for _ in range(model.cfg.n_layers)]}
    if model.cfg.family == "encdec":
        params["encoder"] = [{} for _ in range(model.cfg.n_enc_layers)]
    for path, shape, _ in model.param_specs():
        leaf = torch.empty(shape, device="meta")
        if bits and tqz.is_quantizable(path, leaf):
            leaf = tqz.quantize_leaf(path, leaf, bits, pack, None)
        node = params
        keys = path.split("/")
        for k in keys[:-1]:
            node = node[int(k)] if isinstance(node, list) else \
                node.setdefault(k, {})
        node[keys[-1]] = leaf
    return params


def _flat(tree, qt_type, path=""):
    """path -> spec tuple (a QuantizedTensor of specs: its data / scale and
    its format)."""
    out = {}
    if isinstance(tree, qt_type):
        out[path + "/data"] = tuple(tree.data)
        out[path + "/scale"] = tuple(tree.scale)
        out[path + "/fmt"] = (tree.fmt.bits, tree.packed)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, qt_type, f"{path}/{k}" if path else str(k)))
    elif isinstance(tree, list) or (isinstance(tree, tuple)
                                    and not isinstance(tree, tshr.P)):
        for i, v in enumerate(tree):
            out.update(_flat(v, qt_type, f"{path}/{i}" if path else str(i)))
    else:
        out[path] = tuple(tree)
    return out


def _layer_map(cfg, groups):
    """port layer i -> (JAX prefix, stacked)."""
    names = sorted(groups, key=lambda n: int(n.split("_")[0][1:]))
    g = len(names)
    kinds = cfg.block_pattern if cfg.family == "hybrid" else None
    n_groups = cfg.n_layers // g if kinds else cfg.n_layers
    out = []
    for i in range(cfg.n_layers):
        if i < n_groups * g:
            out.append((f"stack/groups/{names[i % g]}", True))
        else:
            out.append((f"stack/tail/{i - n_groups * g}", False))
    return out


def _compare_params(cfg, jspecs, tspecs, jtree):
    jflat = _flat(jspecs, JQT)
    tflat = _flat(tspecs, TQT)
    lmap = _layer_map(cfg, jtree["stack"]["groups"])
    seen = set()
    for path, spec in tflat.items():
        parts = path.split("/")
        stacked = False
        if parts[0] == "layers":
            pre, stacked = lmap[int(parts[1])]
            jpath = "/".join([pre] + parts[2:])
        elif parts[0] == "encoder":
            jpath, stacked = "/".join(["encoder"] + parts[2:]), True
        else:
            jpath = path
        want = jflat[jpath]
        if stacked and want and not path.endswith("/fmt"):
            assert want[0] is None, (jpath, want)      # the layer dim
            want = want[1:]
        assert spec == want, (path, spec, want)
        seen.add(jpath)
    assert seen == set(jflat), set(jflat) - seen


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match(arch):
    """param_specs in serve and train mode, plain / psi8 / packed psi5, on
    the (4, 2), (16, 16) and (2, 16, 16) meshes."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for bits, pack in QUANTS:
        jp = jax_params(arch, bits)
        tp = port_params(arch, bits, pack)
        for jm, tm in meshes():
            for mode in ("serve", "train"):
                _compare_params(tcfg, jshr.param_specs(jp, jcfg, jm, mode),
                                tshr.param_specs(tp, tcfg, tm, mode), jp)


def _compare_cache(cfg, jspec, tspec):
    """JAX kv = (group dict b<j> -> stacked leaves, tail list); the port's
    one dict a layer."""
    groups, tail = jspec.kv
    g = len(groups)
    n_groups = (cfg.n_layers // g if cfg.family == "hybrid"
                else cfg.n_layers)
    for i, layer in enumerate(tspec.kv):
        for name, spec in layer.items():
            if i < n_groups * g:
                want = tuple(groups[f"b{i % g}"][name])
                if want:
                    assert want[0] is None              # the layer dim
                    want = want[1:]
            else:
                want = tuple(tail[i - n_groups * g][name])
            assert tuple(spec) == want, (i, name, spec, want)
        if i < n_groups * g:
            assert set(layer) == set(groups[f"b{i % g}"])
    if jspec.enc_out is None:
        assert tspec.enc_out is None
    else:
        assert tuple(tspec.enc_out) == tuple(jspec.enc_out)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_and_batch_specs_match(arch):
    """cache_specs (dense, and paged where the stack can page; int8 KV
    too), batch_specs, serve_batch_specs and decode_carry_specs."""
    import dataclasses
    import jax.numpy as jnp
    B, S = 32, 128
    for kvq in ("", "int8"):
        jcfg = dataclasses.replace(jget_config(arch), kv_quant=kvq)
        tcfg = dataclasses.replace(tget_config(arch), kv_quant=kvq)
        jm_, tm_ = jbuild_model(jcfg), tbuild_model(tcfg)
        layouts = ["dense"] + (["paged"] if tcfg.paged_capable else [])
        for layout in layouts:
            jc = jax.eval_shape(lambda: jm_.init_cache(B, S, layout=layout))
            tc = tm_.init_cache(B, S, device="meta", layout=layout)
            for jm, tm in meshes():
                _compare_cache(tcfg, jshr.cache_specs(jcfg, jm, jc),
                               tshr.cache_specs(tcfg, tm, tc))
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for jm, tm in meshes():
        for b, s in ((256, 4096), (32, 32768), (1, 524288), (3, 64)):
            jb = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                  "positions": jax.ShapeDtypeStruct((b, 3, s), jnp.int32)}
            tb = {k: torch.empty(v.shape, device="meta")
                  for k, v in jb.items()}
            for seq in (False, True):
                got = tshr.batch_specs(tcfg, tm, tb, seq_shard=seq)
                want = jshr.batch_specs(jcfg, jm, jb, seq_shard=seq)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (b, s, seq)
            step = {"token": (b, 1), "pos": (b, 1), "active": (b,),
                    "remaining": (b,), "positions": (b, 3, 1)}
            jstep = {k: jax.ShapeDtypeStruct(v, jnp.int32)
                     for k, v in step.items()}
            tstep = {k: torch.empty(v, device="meta")
                     for k, v in step.items()}
            for fn in ("serve_batch_specs", "decode_carry_specs"):
                got = getattr(tshr, fn)(tcfg, tm, tstep)
                want = getattr(jshr, fn)(jcfg, jm, jstep)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (fn, b)


def test_shard_maps_match():
    for arch in ("qwen3-8b", "whisper-base", "mixtral-8x22b"):
        jcfg, tcfg = jget_config(arch), tget_config(arch)
        for jm, tm in meshes() + [(AbstractMesh((2, 2), ("data", "model")),
                                   tshr.AxisMesh((2, 2), ("data",
                                                          "model")))]:
            for n in (1, 3, 4, 8, 20, 64, 256, 4096 + 256):
                assert (tshr.batch_shard_count(tcfg, tm, n)
                        == jshr.batch_shard_count(jcfg, jm, n))
                np.testing.assert_array_equal(
                    tshr.slot_shard_map(tcfg, tm, n),
                    jshr.slot_shard_map(jcfg, jm, n))
                for usable in (None, max(n - 4, 1)):
                    np.testing.assert_array_equal(
                        tshr.block_shard_map(tcfg, tm, n, usable),
                        jshr.block_shard_map(jcfg, jm, n, usable))
    assert tshr.TP_MIN_D_MODEL == jshr.TP_MIN_D_MODEL
    for arch in ASSIGNED_ARCHS:
        assert (tshr.tp_enabled(tget_config(arch))
                == jshr.tp_enabled(jget_config(arch)))


def test_plan_remesh_matches():
    """Shrink the data axis, multi-pod, and the refusal below the TP
    degree, as the reference plans them."""
    for n, mp, pods in ((256, 16, None), (255, 16, None), (200, 16, None),
                        (512, 16, 2), (496, 16, 2), (8, 2, None),
                        (4, 2, None), (3, 2, None), (7, 1, None),
                        (64, 4, 4), (48, 4, 4)):
        t, j = tel.plan_remesh(n, mp, pods), jel.plan_remesh(n, mp, pods)
        assert (t.shape, t.axis_names, t.dropped_devices, t.n_devices) == (
            j.shape, j.axis_names, j.dropped_devices, j.n_devices)
    for n, mp in ((15, 16), (1, 2)):
        with pytest.raises(ValueError):
            tel.plan_remesh(n, mp)
        with pytest.raises(ValueError):
            jel.plan_remesh(n, mp)
    assert tel.survivors_after_failure([0, 1, 2, 3], [1, 3]) == [0, 2]


def _coords(mesh):
    names = tuple(mesh.shape)
    for idx in np.ndindex(*mesh.shape.values()):
        yield dict(zip(names, (int(i) for i in idx)))


@pytest.mark.parametrize("shape,names", MESHES[:1] + [
    ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))])
def test_local_shard_round_trip(shape, names):
    """Every rank's local_shard of a leaf, put back at its shard indices,
    rebuilds the leaf; a slot-dim leaf's chunk holds exactly the slots the
    slot map gives that shard; a QuantizedTensor cuts data and scale."""
    mesh = tshr.AxisMesh(shape, names)
    g = torch.Generator().manual_seed(0)
    specs = [tshr.P("data", "model"), tshr.P(("data", "model"), None),
             tshr.P(None, "model", None), tshr.P(), tshr.P("model")]
    for spec in specs:
        dims = [8 * int(np.prod([mesh.shape[a] for a in
                                 (ax if isinstance(ax, tuple) else (ax,))]))
                if ax else 3 for ax in spec] or [5]
        t = torch.randn(dims, generator=g)
        got = torch.full_like(t, float("nan"))
        for c in _coords(mesh):
            loc = tshr.local_shard(t, spec, mesh, c)
            idx = []
            for d, ax in enumerate(spec):
                i, n = tshr.shard_index(mesh, ax, c)
                sz = t.shape[d] // n
                idx.append(slice(i * sz, (i + 1) * sz))
            got[tuple(idx)] = loc
            torch.testing.assert_close(loc, t[tuple(idx)], rtol=0, atol=0)
        torch.testing.assert_close(got, t, rtol=0, atol=0)
    cfg = tget_config("qwen3-8b")
    B = 32
    slots = torch.arange(B)
    spec = tshr.serve_batch_specs(cfg, mesh, {"s": slots})["s"]
    smap = tshr.slot_shard_map(cfg, mesh, B)
    bax = tshr.batch_axes(cfg, mesh, B)
    for c in _coords(mesh):
        i, _ = tshr.shard_index(mesh, bax or None, c)
        mine = tshr.local_shard(slots, spec, mesh, c)
        assert mine.tolist() == np.flatnonzero(smap == i).tolist()
    n_total = 4 * 8 + B
    blocks = torch.arange(n_total)
    bspec = tshr.P(tshr._pick_batch_axes(n_total, mesh,
                                         tshr._dp(mesh, cfg)))
    bmap = tshr.block_shard_map(cfg, mesh, n_total)
    for c in _coords(mesh):
        i, _ = tshr.shard_index(mesh, bspec[0], c)
        mine = tshr.local_shard(blocks, bspec, mesh, c)
        assert mine.tolist() == np.flatnonzero(bmap == i).tolist()
    qt = TQT(torch.arange(64 * 16, dtype=torch.int8).reshape(64, 16),
             torch.arange(16, dtype=torch.float32).reshape(1, 16),
             tqz.psi.get_format(8), False)
    qspec = tshr.param_specs({"wq": qt}, tget_config("qwen3-8b"), mesh)["wq"]
    m = mesh.shape["model"]
    for c in _coords(mesh):
        loc = tshr.local_shard(qt, qspec, mesh, c)
        j = c["model"]
        assert torch.equal(loc.data, qt.data[:, j * 16 // m:(j + 1) * 16 // m])
        assert torch.equal(loc.scale,
                           qt.scale[:, j * 16 // m:(j + 1) * 16 // m])


def test_spec_normalization():
    """P normalizes as JAX's PartitionSpec does."""
    from jax.sharding import PartitionSpec as JP
    for parts in ((("data",), None), (("data", "model"), None), ((), None),
                  (None,), ("model",), ()):
        assert tuple(tshr.P(*parts)) == tuple(JP(*parts)), parts


@pytest.mark.parametrize("n_slots,n_shards", [(4, 4), (8, 2), (6, 3), (5, 1)])
def test_slot_allocator_matches(n_slots, n_shards):
    """The shard-aware slot allocator against the reference's over a
    random alloc / release churn: the same slot each time (the shard with
    the most free slots, ties to the lowest; the lowest slot in it), the
    same free counts per shard."""
    rng = np.random.default_rng(n_slots * 10 + n_shards)
    ja = jsched.SlotAllocator(n_slots, n_shards)
    ta = tsched.SlotAllocator(n_slots, n_shards)
    assert ta.shard_of == ja.shard_of
    held, rid = [], 0
    for _ in range(200):
        if held and (not ta.free_count or rng.random() < 0.45):
            slot = held.pop(int(rng.integers(len(held))))
            ja.release(slot)
            ta.release(slot)
        else:
            got = ta.alloc(rid)
            assert got == ja.alloc(rid)
            held.append(got)
            rid += 1
        assert ta.free_per_shard() == ja.free_per_shard()
        assert ta.occupant == ja.occupant


def test_block_allocator_books_one_shard():
    """A split pool books each reservation against one shard and draws
    every block of it there (a rank holds only its shard's blocks);
    admission takes the first shard in slot preference that can hold the
    request, so the slot and its blocks share a shard; a fork stays on
    the shard; released blocks return to their shard's pool.  One shard
    keeps the reference's allocator's behaviour."""
    shard_of = [b * 4 // 16 for b in range(16)]          # 4 blocks a shard
    al = tsched.BlockAllocator(16, n_shards=4, shard_of=shard_of)
    with pytest.raises(ValueError, match="shard="):
        al.reserve(0, 1)
    assert not al.can_reserve(5, 2) and al.can_reserve(4, 2)
    al.reserve(0, 3, 2)
    assert [al.alloc(0) for _ in range(3)] == [8, 9, 10]
    assert not al.can_reserve(2, 2) and al.can_reserve(1, 2)
    al.attach(1, [9])
    al.reserve(1, 1, 2)
    new = al.fork(1, 9)
    assert new == 11 and al.shard_of[new] == 2
    al.release(0)
    al.release(1)
    assert al.free_count == 16 and sorted(al._pools[2]) == [8, 9, 10, 11]
    # the scheduler: four 4-block requests fill the four shards one each
    reqs = [tsched.Request(rid=i, prompt=np.zeros(8, np.int32), max_new=4,
                           arrival_s=0.0) for i in range(5)]
    sched = tsched.Scheduler(
        reqs, 4, n_shards=4,
        blocks=tsched.BlockAllocator(16, n_shards=4, shard_of=shard_of),
        blocks_needed=lambda r: 4 if r.rid != 1 else 3)
    sched.poll(0.0)
    admitted = sched.admit(0.0)
    assert [r.rid for _, r in admitted] == [0, 1, 2, 3]
    assert [sched.slots.shard_of[s] for s, _ in admitted] == [0, 1, 2, 3]
    for _, r in admitted:
        blks = [sched.blocks.alloc(r.rid)
                for _ in range(sched.blocks.reserved_of(r.rid))]
        assert {sched.blocks.shard_of[b] for b in blks} == {
            sched.slots.shard_of[r.slot]}
    assert sched.slots.free_count == 0
    # one shard: the reference's lowest-free-first order, no shard needed
    ja, ta = jsched.BlockAllocator(6), tsched.BlockAllocator(6)
    for a in (ja, ta):
        a.reserve(0, 4)
    assert [ta.alloc(0) for _ in range(4)] == [ja.alloc(0) for _ in range(4)]


# narrow configs wide enough for tensor parallelism (d_model >= 1024): an
# MoE whose experts divide every model axis here (expert parallelism), one
# whose 3 experts do not (tensor parallelism inside each expert), mixtral,
# and the SSM
NARROW_TP = {
    "qwen3-moe": ("qwen3-moe-30b-a3b", dict(
        d_model=1024, n_layers=1, n_heads=8, head_dim=128, d_ff=256,
        vocab_size=512)),
    "moe3": ("qwen3-moe-30b-a3b", dict(
        d_model=1024, n_layers=1, n_heads=8, head_dim=128, d_ff=256,
        vocab_size=512, n_experts=3)),
    "mixtral": ("mixtral-8x22b", dict(
        d_model=1024, n_layers=1, n_heads=8, head_dim=128, d_ff=256,
        vocab_size=512)),
    "falcon-mamba": ("falcon-mamba-7b", dict(d_model=1024, n_layers=2,
                                             vocab_size=512)),
}


def _want_chunk(path, leaf, spec, mesh, coord, cfg):
    """This rank's share of a whole leaf, computed apart from the placer:
    ``local_shard`` of its spec, but (a) a mamba in_proj's channels [j
    di/m, (j+1) di/m) of both halves of its columns (its codes and
    scales), (b) a packed expert block compared through its codes (the
    codes' spec: the planes keep the expert dim)."""
    if path.endswith("in_proj") and isinstance(leaf, TQT):
        m, j = mesh.shape["model"], coord["model"]

        def halves(t):
            h = t.shape[-1] // 2
            c = h // m
            return torch.cat([t[..., j * c:(j + 1) * c],
                              t[..., h + j * c:h + (j + 1) * c]], -1)
        return ("codes", halves(leaf.codes), halves(leaf.scale))
    if isinstance(leaf, TQT) and leaf.packed and leaf.data.dim() > 3:
        cspec = tshr.leaf_spec(path, leaf.unpack(), cfg, mesh)
        return ("codes", tshr.local_shard(leaf.codes, cspec.data, mesh, coord),
                tshr.local_shard(leaf.scale, cspec.scale, mesh, coord))
    if isinstance(leaf, TQT):
        return ("data", tshr.local_shard(leaf.data, spec.data, mesh, coord),
                tshr.local_shard(leaf.scale, spec.scale, mesh, coord))
    return ("plain", tshr.local_shard(leaf, spec, mesh, coord), None)


@pytest.mark.parametrize("bits", [8, 5, None])
@pytest.mark.parametrize("name", list(NARROW_TP))
def test_rank_local_init_is_the_placed_init(name, bits):
    """``Model.init(share=LeafPlacer(cfg, mesh, coord))`` (each leaf drawn
    whole, quantized, cut at once) at every coordinate of (1, 2) and (2, 2)
    ``AxisMesh``es in serve mode equals the whole init cut to that rank,
    bit for bit (the SSM reslice and the experts' own dims included), and
    holds nothing of a whole leaf (its chunks own their storage).  Float
    params (``bits`` None) in train mode: ``local_shard`` of the train
    specs, as ``TrainShare.place`` cuts them."""
    arch, kw = NARROW_TP[name]
    cfg = treduced_config(tget_config(arch), **kw)
    model = tbuild_model(cfg)
    mode = "serve" if bits else "train"
    full = model.init(seed=0, device="cpu", bits=bits, pack=True)
    for shape in ((1, 2), (2, 2)):
        mesh = tshr.AxisMesh(shape, ("data", "model"))
        specs = tshr.param_specs(full, cfg, mesh, mode)
        for c in _coords(mesh):
            got = model.init(seed=0, device="cpu", bits=bits, pack=True,
                             share=tshr.LeafPlacer(cfg, mesh, c, mode))

            def one(path, leaf, spec, mine):
                p = "/".join(map(str, path))
                kind, want, want_scale = _want_chunk(p, leaf, spec, mesh, c,
                                                     cfg)
                if kind == "plain":
                    assert torch.equal(mine, want), p
                    parts = [mine]
                else:
                    have = mine.codes if kind == "codes" else mine.data
                    assert torch.equal(have, want), (p, c)
                    assert torch.equal(mine.scale, want_scale), (p, c)
                    parts = [mine.data, mine.scale]
                for t in parts:
                    assert (t.untyped_storage().nbytes()
                            == t.numel() * t.element_size()), p
            tshr.map_tree(one, full, specs, got)
