"""The port's dry-run report (``launch/dryrun.py``) on the CPU, against
the JAX package's placement.

The JAX side runs in a subprocess (the JAX package's ``dryrun`` sets
``XLA_FLAGS`` for 512 placeholder CPU devices when imported, which must
not reach this test process), started by the module's fixture and run
while this process places the same cells: for every kind of step input
(params, AdamW's m + v, the decode cache, the batch) the sum over leaves
of the bytes of ``NamedSharding(mesh, spec).shard_shape(leaf.shape)`` on
a (2, 4) ("data", "model") mesh, from that module's ``abstract_params``
and ``input_specs`` and the JAX package's ``param_specs`` /
``batch_specs`` / ``cache_specs``.  The port keeps one dict a layer where
the JAX package stacks layers, so totals per kind are compared, as
integers.  The rest: the meta params against a real ``init`` +
``quantize`` on reduced configs, the placement's bytes against the bytes
``local_shard`` cuts of real tensors on every rank, and the CLI over the
whole (arch x shape) matrix with no card and no process group."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, ShapeConfig,
                                 get_config, reduced_config,
                                 shape_applicable)
from repro_torch.core.psi import QuantizedTensor
from repro_torch.core.quantizer import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.perf import roofline_model as roof
from repro_torch.runtime import sharding as shr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TIMEOUT_S = 300
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
         "falcon-mamba-7b", "whisper-base")
SHAPE_NAMES = ("train_4k", "decode_32k")
MESH = ((2, 4), ("data", "model"))

JAX_SIDE = """
import json, sys
import numpy as np
from repro.launch import dryrun as dr    # sets XLA_FLAGS: import it first
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import sharding as shr

mesh = make_mesh(MESH_SHAPE, MESH_AXES)

def total(tree, specs):
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp), (len(leaves), len(sp))
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(l.shape)))
               * np.dtype(l.dtype).itemsize for l, s in zip(leaves, sp))

out = {}
with mesh:
    for arch in ARCHS:
        for name in SHAPE_NAMES:
            shape = SHAPES[name]
            train = shape.kind == "train"
            quant = "none" if train else "psi8"
            cfg = get_config(arch, quant_mode=quant)
            params = dr.abstract_params(build_model(cfg), quant)
            pspecs = shr.param_specs(params, cfg, mesh,
                                     mode="train" if train else "serve")
            got = {"params": total(params, pspecs)}
            if train:
                st = jax.eval_shape(adamw(lr=1e-3).init, params)
                got["opt"] = total(st.m, pspecs) + total(st.v, pspecs)
                batch = dr.input_specs(arch, name)
            else:
                spec = dr.input_specs(arch, name, quant)
                batch = spec["batch"]
                got["cache"] = total(spec["cache"],
                                     shr.cache_specs(cfg, mesh, spec["cache"]))
            got["batch"] = total(batch, shr.batch_specs(cfg, mesh, batch))
            out[f"{arch}/{name}"] = got
print("RESULT " + json.dumps(out))
"""


def _port_cell(arch, name, mesh):
    shape = SHAPES[name]
    return dryrun.resident_bytes(dryrun.place_cell(
        dryrun.cell_config(arch, shape, "psi8"), shape, mesh), mesh)


@pytest.fixture(scope="module")
def cells():
    """The JAX package's per-kind bytes (subprocess) and the port's."""
    code = (JAX_SIDE.replace("MESH_SHAPE", repr(MESH[0]))
            .replace("MESH_AXES", repr(MESH[1]))
            .replace("ARCHS", repr(ARCHS))
            .replace("SHAPE_NAMES", repr(SHAPE_NAMES)))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    mesh = shr.AxisMesh(*MESH)
    port = {f"{a}/{n}": _port_cell(a, n, mesh)
            for a in ARCHS for n in SHAPE_NAMES}
    try:
        out, err = proc.communicate(timeout=JAX_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the JAX side overran {JAX_TIMEOUT_S} s")
    assert proc.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_resident_bytes_equal_jax(cells, arch, name):
    """Bytes a device holds, by kind, on the (2, 4) mesh: equal integers."""
    ref, port = cells
    key = f"{arch}/{name}"
    assert port[key] == ref[key]


@pytest.mark.parametrize("arch", ARCHS + ("qwen2-vl-2b", "mixtral-8x22b"))
@pytest.mark.parametrize("quant", ["none", "psi8", "psi5"])
def test_abstract_params_match_real_init(arch, quant):
    """The meta tree has the structure, shapes and dtypes of a real
    ``init`` (+ ``quantize``, packed) on the reduced config."""
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg)
    real = model.init(0, "cpu")
    if quant != "none":
        real = model.quantize(real, int(quant[3:]), pack=True)
    meta = dryrun.abstract_params(model, quant)

    def sig(tree):
        out = []
        shr.map_tree(lambda path, leaf: out.append(
            (path, type(leaf).__name__,
             [(tuple(t.shape), t.dtype) for t in
              ((leaf.data, leaf.scale) if isinstance(leaf, QuantizedTensor)
               else (leaf,))],
             (leaf.fmt.bits, leaf.packed)
             if isinstance(leaf, QuantizedTensor) else None)), tree)
        return out

    assert sig(meta) == sig(real)
    assert all(t.device.type == "meta" for t in tree_leaves(meta)
               if isinstance(t, torch.Tensor))


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_one_device_cell_bytes_equal_its_tensors():
    """On a (1, 1) mesh a train cell's resident bytes are the bytes its
    real params (f32, as the trainer holds them), m, v and batch hold."""
    cfg = reduced_config(get_config("qwen3-8b"), n_layers=4)
    shape = ShapeConfig("train_8x32", 32, 8, "train")
    mesh = shr.AxisMesh((1, 1), ("data", "model"))
    got = dryrun.resident_bytes(dryrun.place_cell(
        cfg, shape, mesh, param_dtype=torch.float32), mesh)
    params = build_model(cfg).init(0, "cpu")
    st = adamw().init(params)
    batch = {"tokens": torch.zeros((8, 32), dtype=torch.int32)}
    assert got == {"params": _nbytes(params),
                   "opt": _nbytes(st.m) + _nbytes(st.v),
                   "batch": _nbytes(batch)}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_every_rank_holds_the_reported_bytes(kind):
    """A TP-on config on a (2, 4) AxisMesh: at every coordinate the
    chunks ``local_shard`` cuts of real tensors (params, the decode cache)
    hold exactly the bytes the report gives one device."""
    cfg = reduced_config(get_config("qwen3-8b"), d_model=1024, n_layers=2,
                         n_heads=8, head_dim=128, d_ff=2048, vocab_size=512,
                         quant_mode="none" if kind == "train" else "psi8")
    shape = ShapeConfig("cell", 64, 8, kind)
    mesh = shr.AxisMesh(*MESH)
    want = dryrun.resident_bytes(dryrun.place_cell(cfg, shape, mesh),
                                 mesh)
    model = build_model(cfg)
    params = model.init(0, "cpu", bits=None if kind == "train" else 8,
                        pack=True)
    specs = shr.param_specs(params, cfg, mesh,
                            mode="train" if kind == "train" else "serve")
    cache = model.init_cache(8, 64, device="cpu", layout="dense")
    cspecs = shr.cache_specs(cfg, mesh, cache)
    for idx in np.ndindex(*MESH[0]):
        coord = dict(zip(MESH[1], (int(i) for i in idx)))
        local = shr.local_shard_tree(params, specs, mesh, coord)
        nb = sum(t.nbytes if isinstance(t, QuantizedTensor)
                 else t.numel() * t.element_size()
                 for t in tree_leaves(local))
        assert nb == want["params"], coord
        if kind == "decode":
            kv = shr.local_shard_tree(cache.kv, cspecs.kv, mesh, coord)
            assert _nbytes(kv) == want["cache"], coord


def test_cli_covers_the_matrix_without_a_card(tmp_path, capsys):
    """``--all``: the 40 (arch x shape) cells, shape_applicable's skips
    skipped, every other cell placed and reported; exit 0; no process
    group was made."""
    import torch.distributed as dist
    out = tmp_path / "cells.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--out", str(out)])
    assert e.value.code == 0
    assert "40/40 cells passed" in capsys.readouterr().out
    results = json.loads(out.read_text())
    assert [(r["arch"], r["shape"]) for r in results] == [
        (a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    for r in results:
        ok, why = shape_applicable(get_config(r["arch"]), SHAPES[r["shape"]])
        if not ok:
            assert r == {"arch": r["arch"], "shape": r["shape"],
                         "skipped": why}
            continue
        res = r["resident_bytes_per_dev"]
        assert r["chips"] == 256 and r["mesh"] == "16x16"
        assert set(res) == ({"params", "opt", "batch"} if r["shape"] ==
                            "train_4k" else {"params", "cache", "batch"}
                            if "decode" in r["shape"] or "long" in r["shape"]
                            else {"params", "batch"})
        assert r["memory_per_device_bytes"] == sum(res.values()) > 0
        assert r["fits_hbm_80g"] == (r["memory_per_device_bytes"] < 80e9)
        for k in ("lower_s", "compile_s", "memory_analysis",
                  "collective_breakdown"):
            assert k not in r
    assert sum("skipped" in r for r in results) == 7
    assert not dist.is_initialized()


def test_cell_report_terms_multi_pod():
    """One cell on the (2, 16, 16) pod mesh: the roofline terms and
    counts are perf.roofline_model's at 512 chips."""
    r = dryrun.run_cell("qwen3-8b", "train_4k", multi_pod=True,
                        verbose=False)
    cell = roof.analytic_cell("qwen3-8b", "train_4k", quant="none",
                              chips=512, mesh_model=16)
    assert r["chips"] == 512 and r["mesh"] == "pod2x16x16"
    assert r["flops_per_dev"] == cell.flops / 512
    assert r["coll_bytes_per_dev_analytic"] == cell.coll_bytes_per_dev
    for k, v in roof.roofline_terms(cell, chips=512).items():
        assert r[k] == v
    cfg = get_config("qwen3-8b")
    assert r["model_flops"] == 6.0 * (cfg.active_param_count()
                                      - cfg.vocab_size * cfg.d_model
                                      ) * 256 * 4096
