"""Mesh serving of the port on gloo ranks (CPU), against the port's single
process and the JAX package's single-device Server.

Each multi-rank job is one ``python -c`` process a rank, joined through a
``FileStore`` in a temporary directory and run under its own time limit
(a wedged collective fails the test instead of hanging the suite).  The
jobs start when the module's fixture is first used and run while the main
process computes the references.  Params come from the JAX package
(``init`` + ``quantize``), carried to every rank by interop.

* (2, 2) mesh, reduced qwen3-8b psi8 (``d_model`` 64: tensor parallelism
  is off, so "model" joins the batch axes and the slots split 4 ways),
  paged (continuous and static) and dense, at horizon 1 and in rounds of
  4 steps: tokens identical to the port's single process and to the JAX
  Server; the first admissions land one a shard; collectives issued;
* (1, 2) mesh, a narrow qwen3-8b (``d_model`` 1024, 2 layers) at psi8,
  packed psi5 and with one KV head (MQA: its projection is gathered over
  "model"), and a narrow qwen2-vl (M-RoPE, the tied head over the
  vocab-parallel table): tokens identical, forward logits within ``ATOL``
  of the single process's (row-parallel partial sums add in another
  order) and of the JAX package's;
* the same (2, 2) mesh at horizon 4 for a reduced qwen3-moe burst and
  reduced recurrentgemma: tokens identical to the single process and the
  JAX Server;
* ``from_devices`` / ``remesh`` on four ranks, and the refusal of a
  ``max_batch`` the data axis does not divide.  The MoE and SSM families'
  tensor and expert parallelism is tested in ``test_torch_tp_families.py``,
  the hybrid's, KV heads that do not split and speculation with TP in
  ``test_torch_tp_ring.py``, context serving and speculation on split
  slots in ``test_torch_mesh_context.py``.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.launch.scheduler import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch.scheduler import Request
from repro_torch.launch.serve import Server

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4                     # the logits tolerance of test_torch_model
JOB_TIMEOUT_S = 240
NARROW = dict(d_model=1024, n_layers=2, n_heads=8, head_dim=128, d_ff=2048,
              vocab_size=512)
# arch, bits, kv heads (qwen2-vl: M-RoPE and the tied head, vocab-parallel)
TP_CASES = {"psi8": ("qwen3-8b", 8, 2), "psi5": ("qwen3-8b", 5, 2),
            "mqa": ("qwen3-8b", 8, 1), "vlm": ("qwen2-vl-2b", 8, 2)}

# the other families served with data parallelism on the (2, 2) mesh
FAMILY_DP = {"dp_moe": "qwen3-moe-30b-a3b", "dp_rg": "recurrentgemma-9b"}

# prompts / budgets of the JAX package's sharded-serving tests
SAME_LEN = ([8] * 6, [3, 7, 2, 5, 4, 6])
RAGGED = ([5 + 3 * i for i in range(6)], [3, 7, 2, 5, 4, 6])

WORKER = r'''
import faulthandler, json, pickle, sys, warnings
faulthandler.dump_traceback_later(JOB_TIMEOUT_S - 30, exit=True)    # a hang: say where
import numpy as np, torch, torch.distributed as dist
warnings.simplefilter("ignore")
torch.set_num_threads(1)
rank, world, tmp, job = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/{job}.store", world),
                        rank=rank, world_size=world)
import dataclasses
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.scheduler import Request
from repro_torch.launch.serve import Server
from repro_torch.runtime.executor import Executor

def load(name):
    with open(f"{tmp}/{name}.pkl", "rb") as f:
        arch, cfg_kw, tree = pickle.load(f)
    cfg = reduced_config(get_config(arch), **cfg_kw)
    return cfg, params_from_numpy(tree, device="cpu")

def reqs(spec, vocab):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]
    return [Request(rid=i, prompt=prompts[i], max_new=mn, arrival_s=0.0)
            for i, mn in enumerate(budgets)]

def serve(server, spec, vocab, cont=True):
    done, st = server.serve(reqs(spec, vocab), continuous=cont)
    ex = server.executor
    return {"tokens": {r.rid: [int(t) for t in r.tokens] for r in done},
            "shard": {r.rid: int(ex.slot_shards[r.slot]) for r in done},
            "slot_shards": st["slot_shards"],
            "decode_rounds": st["decode_rounds"],
            "collectives": st["collectives"]}

def refused(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__ + ": " + str(e)
    return None

SPECS = json.loads(sys.argv[5])
out = {}
if job == "dp":
    cfg, params = load("dp")
    mesh = make_mesh((2, 2), ("data", "model"))
    sp = Server(cfg, params, max_batch=4, max_seq=64, device="cpu", mesh=mesh)
    ex = sp.executor
    out["paged_geometry"] = [ex.n_slot_shards, ex.n_block_shards,
                             len(ex.block_shards), ex.local_batch]
    out["same_len"] = serve(sp, SPECS["same_len"], cfg.vocab_size)
    out["paged_cont"] = serve(sp, SPECS["ragged"], cfg.vocab_size)
    out["paged_static"] = serve(sp, SPECS["ragged"], cfg.vocab_size, False)
    sd = Server(dataclasses.replace(cfg, cache_layout="dense"), params,
                max_batch=4, max_seq=64, device="cpu", mesh=mesh)
    out["dense_cont"] = serve(sd, SPECS["ragged"], cfg.vocab_size)
    # rounds of 4 steps: each rank's (4, local_batch) tokens gathered over
    # the slot shards, its own rows' carry fed back
    for layout in ("paged", "dense"):
        sh = Server(dataclasses.replace(cfg, cache_layout=layout), params,
                    max_batch=4, max_seq=64, device="cpu", mesh=mesh,
                    decode_horizon=4)
        out[f"h4_{layout}_cont"] = serve(sh, SPECS["ragged"], cfg.vocab_size)
        out[f"h4_{layout}_static"] = serve(sh, SPECS["ragged"],
                                           cfg.vocab_size, False)
    # the other families' data parallelism at horizon 4: an MoE burst
    # (all arrivals at once) and a recurrent-state family (dense slab)
    for name in ("dp_moe", "dp_rg"):
        fcfg, fparams = load(name)
        sf = Server(fcfg, fparams, max_batch=4, max_seq=64, device="cpu",
                    mesh=mesh, decode_horizon=4)
        out[f"{name}_h4"] = serve(sf, SPECS["ragged"], fcfg.vocab_size)
    # elastic hooks
    e = Executor.from_devices(cfg, params, max_batch=4, max_seq=32,
                              model_parallel=2, device="cpu", n_blocks=24,
                              decode_horizon=4)
    el = {"shape": list(e._share.axes.values()), "noop": e.remesh() is e,
          "observe": e.observe_step([1.0] * 4) is not None}
    sw = e.remesh(devices=[1, 0, 3, 2])        # a swapped survivor set
    el["swap_rebuilt"] = sw is not e
    el["swap_shape"] = list(sw._share.axes.values())
    el["swap_kept"] = [sw.n_blocks, sw.decode_horizon, sw.mesh_ranks()]
    small = e.remesh(devices=[0, 1])            # shrink the data axis
    el["shrunk"] = None if small is None else list(small._share.axes.values())
    one = Executor.from_devices(cfg, params, max_batch=4, max_seq=32,
                                devices=[0], device="cpu")
    el["single"] = (None if one is None else
                    [list(one._share.axes.values()), one.n_slot_shards,
                     one.observe_step([1.0]) is None])
    out["elastic"] = el
    out["refuse_batch"] = refused(lambda: Server(
        cfg, params, max_batch=3, max_seq=64, device="cpu", mesh=mesh))
elif job == "tp":
    mesh = make_mesh((1, 2), ("data", "model"))
    for name in SPECS["tp_cases"]:
        cfg, params = load(name)
        s = Server(cfg, params, max_batch=2, max_seq=64, device="cpu", mesh=mesh)
        res = serve(s, SPECS["ragged_tp"], cfg.vocab_size)
        ex = s.executor
        toks = torch.as_tensor(np.stack(
            [np.arange(8) * 7 % cfg.vocab_size, np.arange(8) * 3 + 1]).astype(np.int32))
        with torch.inference_mode():
            lg, _ = ex.model.forward(ex.params, toks)
        np.save(f"{tmp}/tp_{name}_logits.{rank}.npy", lg.numpy())
        res["local_heads"] = [ex.local_cfg.n_heads, ex.local_cfg.n_kv_heads,
                              ex.local_cfg.d_ff]
        out[name] = res
with open(f"{tmp}/{job}.{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def _jax_params(arch, cfg_kw, bits):
    cfg = reduced_config(get_config(arch), **cfg_kw)
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), bits,
                            pack=True)
    return dataclasses.replace(cfg, quant_mode=f"psi{bits}"), params


def _prompts(spec, vocab):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    return ([rng.integers(0, vocab, size=(n,)).astype(np.int32)
             for n in lens], budgets)


def _jax_tokens(cfg, params, spec, max_batch, cont=True, horizon=1):
    prompts, budgets = _prompts(spec, cfg.vocab_size)
    server = JServer(cfg, params, max_batch=max_batch, max_seq=64,
                     decode_horizon=horizon)
    done, _ = server.serve([JRequest(rid=i, prompt=prompts[i], max_new=mn,
                                     arrival_s=0.0)
                            for i, mn in enumerate(budgets)],
                           continuous=cont)
    return {r.rid: [int(t) for t in r.tokens] for r in done}


def _port_tokens(tcfg, tparams, spec, max_batch, cont=True, horizon=1):
    prompts, budgets = _prompts(spec, tcfg.vocab_size)
    server = Server(tcfg, tparams, max_batch=max_batch, max_seq=64,
                    device="cpu", decode_horizon=horizon)
    done, _ = server.serve([Request(rid=i, prompt=prompts[i], max_new=mn,
                                    arrival_s=0.0)
                            for i, mn in enumerate(budgets)],
                           continuous=cont)
    return {r.rid: [int(t) for t in r.tokens] for r in done}


def _launch(tmp, job, world, specs):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER.replace("JOB_TIMEOUT_S",
                                               str(JOB_TIMEOUT_S)),
         str(r), str(world), tmp, job,
         json.dumps(specs)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(tmp, job, procs):
    """Every rank's results; all ranks are killed if one overruns."""
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOB_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(err[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{job}: a rank overran {JOB_TIMEOUT_S} s (a wedged "
                    f"collective?)")
    assert not errs, errs[0]
    out = []
    for r in range(len(procs)):
        with open(f"{tmp}/{job}.{r}.json") as f:
            out.append(json.load(f))
    return out


def _rids(d):
    return {int(k): v for k, v in d.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both jobs, compute the references meanwhile, then collect."""
    tmp = str(tmp_path_factory.mktemp("torch_mesh"))
    ref = {}
    dp_cfg, dp_params = _jax_params("qwen3-8b", {}, 8)
    dumps = {"dp": ("qwen3-8b", {"quant_mode": "psi8"}, np_tree(dp_params))}
    fam = {name: (arch, _jax_params(arch, {}, 8))
           for name, arch in FAMILY_DP.items()}
    for name, (arch, (_, fparams)) in fam.items():
        dumps[name] = (arch, {"quant_mode": "psi8"}, np_tree(fparams))
    tp = {}
    for name, (arch, bits, kv) in TP_CASES.items():
        kw = dict(NARROW, n_kv_heads=kv)
        tp[name] = _jax_params(arch, kw, bits)
        dumps[name] = (arch, dict(kw, quant_mode=f"psi{bits}"),
                       np_tree(tp[name][1]))
    for name, dump in dumps.items():
        with open(f"{tmp}/{name}.pkl", "wb") as f:
            pickle.dump(dump, f)
    specs = {"same_len": SAME_LEN, "ragged": RAGGED,
             "ragged_tp": (RAGGED[0][:4], RAGGED[1][:4]),
             "tp_cases": list(TP_CASES)}
    procs = {"dp": _launch(tmp, "dp", 4, specs),
             "tp": _launch(tmp, "tp", 2, specs)}
    # references while the ranks run
    tdp = params_from_numpy(dumps["dp"][2], device="cpu")
    tdp_cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                      quant_mode="psi8")
    dense_j = dataclasses.replace(dp_cfg, cache_layout="dense")
    dense_t = dataclasses.replace(tdp_cfg, cache_layout="dense")
    ref["dp"] = {
        "jax_paged": _jax_tokens(dp_cfg, dp_params, RAGGED, 4),
        "jax_dense": _jax_tokens(dense_j, dp_params, RAGGED, 4),
        "port_paged": _port_tokens(tdp_cfg, tdp, RAGGED, 4),
        "port_paged_static": _port_tokens(tdp_cfg, tdp, RAGGED, 4, False),
        "port_dense": _port_tokens(dense_t, tdp, RAGGED, 4),
        "port_same_len": _port_tokens(tdp_cfg, tdp, SAME_LEN, 4),
    }
    for layout, jc, tc in (("paged", dp_cfg, tdp_cfg),
                           ("dense", dense_j, dense_t)):
        ref["dp"][f"jax_h4_{layout}"] = _jax_tokens(jc, dp_params, RAGGED,
                                                    4, horizon=4)
        for cont, mode in ((True, "cont"), (False, "static")):
            ref["dp"][f"port_h4_{layout}_{mode}"] = _port_tokens(
                tc, tdp, RAGGED, 4, cont, horizon=4)
    for name, (arch, (fcfg, fparams)) in fam.items():
        tcfg = tconfigs.reduced_config(tconfigs.get_config(arch),
                                       quant_mode="psi8")
        ref[name] = {
            "jax": _jax_tokens(fcfg, fparams, RAGGED, 4, horizon=4),
            "port": _port_tokens(tcfg, params_from_numpy(dumps[name][2],
                                                         device="cpu"),
                                 RAGGED, 4, horizon=4)}
    spec_tp = specs["ragged_tp"]
    toks = np.stack([np.arange(8) * 7 % 512,
                     np.arange(8) * 3 + 1]).astype(np.int32)
    for name, (cfg, params) in tp.items():
        arch, kw, tree = dumps[name]
        tcfg = tconfigs.reduced_config(tconfigs.get_config(arch), **kw)
        tparams = params_from_numpy(tree, device="cpu")
        from repro_torch.models import build_model as tb
        with torch.inference_mode():
            lg, _ = tb(tcfg).forward(tparams, torch.as_tensor(toks))
        batch = {"tokens": jax.numpy.asarray(toks)}
        if cfg.rope == "mrope":             # three equal position streams
            batch["positions"] = jax.numpy.asarray(np.broadcast_to(
                np.arange(toks.shape[1], dtype=np.int32), (2, 3, 8)))
        jlg = np.asarray(build_model(cfg).forward(params, batch)[0],
                         np.float32)
        ref[name] = {"jax": _jax_tokens(cfg, params, spec_tp, 2),
                     "port": _port_tokens(tcfg, tparams, spec_tp, 2),
                     "logits": lg.numpy(), "jax_logits": jlg}
    got = {job: _collect(tmp, job, p) for job, p in procs.items()}
    return ref, got, tmp


def test_dp_paged_tokens_match(runs):
    """(2, 2) mesh, paged pool split four ways: tokens == the port's
    single process == the JAX Server, continuous and static."""
    ref, got, _ = runs
    assert ref["dp"]["port_paged"] == ref["dp"]["jax_paged"]
    assert ref["dp"]["port_paged_static"] == ref["dp"]["jax_paged"]
    for rank in got["dp"]:
        assert rank["paged_geometry"] == [4, 4, 16, 1]
        for key in ("paged_cont", "paged_static"):
            assert _rids(rank[key]["tokens"]) == ref["dp"]["port_paged"]
            assert rank[key]["slot_shards"] == 4
            assert rank[key]["collectives"]["all_gather"] > 0
            assert rank[key]["collectives"]["broadcast"] > 0


def test_dp_dense_tokens_match(runs):
    ref, got, _ = runs
    assert ref["dp"]["port_dense"] == ref["dp"]["jax_dense"]
    for rank in got["dp"]:
        assert _rids(rank["dense_cont"]["tokens"]) == ref["dp"]["port_dense"]
        assert rank["dense_cont"]["slot_shards"] == 4


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_dp_horizon4_tokens_match(runs, layout):
    """(2, 2) mesh at decode_horizon 4, continuous and static: each rank
    computes its own slot's rows of the round, the (4, B) tokens are
    gathered over the slot shards and the local carry fed back; tokens ==
    the port's single-process horizon-4 serve == the JAX Server's (and
    == horizon 1's)."""
    ref, got, _ = runs
    d = ref["dp"]
    want = d[f"jax_h4_{layout}"]
    assert want == d[f"jax_{layout}"]
    for mode in ("cont", "static"):
        assert d[f"port_h4_{layout}_{mode}"] == want
    for rank in got["dp"]:
        for mode in ("cont", "static"):
            res = rank[f"h4_{layout}_{mode}"]
            assert _rids(res["tokens"]) == want
            assert res["slot_shards"] == 4
            assert res["decode_rounds"] > 0
            assert res["collectives"]["all_gather"] > 0


def test_dp_first_admissions_one_a_shard(runs):
    """The slots really spread over the mesh: the first max_batch
    admissions land one a shard, and every rank agrees on every token."""
    ref, got, _ = runs
    for rank in got["dp"]:
        res = rank["same_len"]
        assert _rids(res["tokens"]) == ref["dp"]["port_same_len"]
        shards = {s for rid, s in _rids(res["shard"]).items() if rid < 4}
        assert shards == {0, 1, 2, 3}, shards
    assert len({json.dumps(r["same_len"], sort_keys=True)
                for r in got["dp"]}) == 1


@pytest.mark.parametrize("name", list(FAMILY_DP))
def test_dp_other_families_match(runs, name):
    """(2, 2) mesh at horizon 4, the slots four shards: a reduced
    qwen3-moe burst (all six arrivals at once; routing and capacity per
    forward) and reduced recurrentgemma (RG-LRU state on the dense slab,
    exact-length prefills): tokens == the port's single process == the
    JAX Server's."""
    ref, got, _ = runs
    assert ref[name]["port"] == ref[name]["jax"]
    for rank in got["dp"]:
        res = rank[f"{name}_h4"]
        assert _rids(res["tokens"]) == ref[name]["jax"]
        assert res["slot_shards"] == 4
        assert res["decode_rounds"] > 0
        assert res["collectives"]["all_gather"] > 0


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_serve_matches(runs, case):
    """(1, 2) mesh, TP on (d_model 1024): tokens identical to the single
    process and to the JAX Server; forward logits within ATOL of both."""
    ref, got, tmp = runs
    r = ref[case]
    assert r["port"] == r["jax"]
    _, bits, kv = TP_CASES[case]
    for rank, res in enumerate(got["tp"]):
        mine = res[case]
        assert _rids(mine["tokens"]) == r["port"]
        assert mine["slot_shards"] == 1
        assert mine["local_heads"] == [4, kv // 2 if kv % 2 == 0 else 1,
                                       1024]
        assert mine["collectives"]["all_reduce"] > 0
        lg = np.load(f"{tmp}/tp_{case}_logits.{rank}.npy")
        np.testing.assert_allclose(lg, r["logits"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(lg, r["jax_logits"], rtol=0, atol=ATOL)


def test_elastic_hooks(runs):
    """from_devices plans (2, 2) on four ranks; a matching plan is a no-op;
    a swapped survivor set rebuilds and keeps n_blocks / the horizon;
    shrinking to two ranks plans (1, 2) there and leaves the others
    spares; one rank alone is the (1, 1) mesh with no straggler monitor."""
    _, got, _ = runs
    for rank, res in enumerate(got["dp"]):
        el = res["elastic"]
        assert el["shape"] == [2, 2] and el["noop"] and el["observe"]
        assert el["swap_rebuilt"] and el["swap_shape"] == [2, 2]
        assert el["swap_kept"] == [24, 4, [1, 0, 3, 2]]
        assert el["shrunk"] == ([1, 2] if rank < 2 else None)
        assert el["single"] == ([[1, 1], 1, True] if rank == 0 else None)


def test_mesh_refusals(runs):
    """A max_batch the data axis does not divide is refused.  (Context
    serving on split slots and the hybrid's tensor parallelism are served:
    test_torch_mesh_context.py and test_torch_tp_ring.py.)"""
    _, got, _ = runs
    for res in got["dp"]:
        assert res["refuse_batch"].startswith("ValueError: max_batch=3")
