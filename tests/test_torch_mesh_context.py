"""Context serving and speculation on split slots: the port's Server on
gloo ranks (CPU) whose slots and paged pool split over the data axis,
against the port's single process and the JAX package's Server.

Jobs and helpers follow ``test_torch_distributed.py``: one ``python -c``
process a rank, joined through a ``FileStore``, each job under its own
time limit with faulthandler.  Reduced qwen3-8b psi8 (``d_model`` 64:
tensor parallelism is off, so "model" joins the slot axes) on a (2, 1)
mesh (2 slot shards) and a (2, 2) mesh (4):

* a shared-prefix trace on an ample pool with ``--prefix-cache on``: a hit
  on a block of another shard is copied into the slot's shard before the
  suffix prefill (at least one copy happens); tokens identical, and the
  prefix cache's counters, the reused and prefilled tokens equal the
  single process's; no block leaks;
* SLO scheduling on a tight pool: preemptions and restores happen (a
  restore can land on another shard), tokens identical;
* chunked prefill (``--prefill-chunk 16``): tokens identical;
* ``--speculative 3:4``: tokens identical to plain decode.
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
from repro.launch import scheduler as jsched
from repro.launch import slo as jslo
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import slo as tslo
from repro_torch.launch.serve import Server
from test_torch_distributed import RAGGED, _collect, np_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240
POLICY = "default@aging=5@reserve=0.1"
# the shared-prefix trace of test_torch_prefix.py (all arrivals at once)
PREFIX = dict(rate_rps=1e9, prompt_len=8, max_new=6, min_new=2,
              vocab_size=256, seed=3, prompt_jitter=3, shared_prefix_len=40)
# the chunked-prefill trace of test_torch_slo.py
CHUNKED = dict(rate_rps=500, prompt_len=56, max_new=10, min_new=10,
               vocab_size=256, seed=2)
# the prefix cache's counters that do not depend on block ids
PREFIX_STATS = ("n_requests", "tokens", "prefilled_tokens",
                "prefix_tokens_reused")
# mesh -> (shape, max_batch, the SLO case's tight pool, the prefix case's
# ample pool).  n_blocks + max_batch splits over the slot shards like
# max_batch (the pool's last max_batch blocks, the scratch, all lie on the
# last shard); on the tight pool the largest shard holds the longest
# request alone; on the ample pool every shard holds its slots' worst
# cases and the copies of their hits, so that nothing is evicted and the
# admissions are the single process's.  The prefix case runs at
# PREFIX_BATCH slots.
MESHES = {"m21": ((2, 1), 4, 12, 36), "m22": ((2, 2), 8, 24, 60)}
PREFIX_BATCH = 4

WORKER = r'''
import faulthandler, json, os, pickle, sys, warnings
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
from repro_torch.launch import scheduler as sched, slo
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import Server

SPECS = json.loads(sys.argv[5])
shape, max_batch, tight, ample = SPECS["meshes"][job]
with open(f"{tmp}/params.pkl", "rb") as f:
    tree = pickle.load(f)
cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8")
params = params_from_numpy(tree, device="cpu")
mesh = make_mesh(tuple(shape), ("data", "model"))

def run(server, reqs, cont=True):
    done, st = server.serve(reqs, continuous=cont)
    keep = ("n_requests", "tokens", "prefilled_tokens", "prefix_tokens_reused",
            "blocks_free_end", "n_blocks", "blocks_copied", "preemptions",
            "slot_shards", "prefix_cache", "prefill_chunks", "speculative")
    return {"tokens": {r.rid: [int(t) for t in r.tokens] for r in done},
            "stats": {k: st[k] for k in keep if k in st}}

def ragged(spec):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lens]
    return [sched.Request(rid=i, prompt=prompts[i], max_new=mn, arrival_s=0.0)
            for i, mn in enumerate(budgets)]

def bursty():
    pol = slo.parse_slo_spec(SPECS["policy"])
    return slo.bursty_heavy_tail_trace(
        16, vocab_size=256, seed=7, burst_size=8, burst_gap_s=0.3,
        long_frac=0.6, mix=pol.mix([3.0, 2.0, 1.0]))

out = {}
pre = Server(dataclasses.replace(cfg, prefix_cache=True), params,
             max_batch=SPECS["prefix_batch"], max_seq=80, n_blocks=ample,
             device="cpu", mesh=mesh)
for mode in ("cont", "static"):
    out[f"prefix_{mode}"] = run(pre, sched.poisson_trace(8, **SPECS["prefix"]),
                                mode == "cont")
s = Server(cfg, params, max_batch=max_batch, max_seq=112, n_blocks=tight,
           slo=slo.parse_slo_spec(SPECS["policy"]), device="cpu", mesh=mesh)
out["slo"] = run(s, bursty())
s = Server(cfg, params, max_batch=max_batch, max_seq=96, prefill_chunk=16,
           device="cpu", mesh=mesh)
out["chunked"] = run(s, sched.poisson_trace(6, **SPECS["chunked"]))
s = Server(cfg, params, max_batch=max_batch, max_seq=64, speculative=(3, 4),
           device="cpu", mesh=mesh)
out["spec"] = run(s, ragged(SPECS["ragged"]))
with open(f"{tmp}/{job}.{rank}.json", "w") as f:
    json.dump(out, f)
# every rank is past its last collective; leave without running the
# process group's teardown, which can race a peer's exit under load
dist.barrier()
os._exit(0)
'''


def _launch(tmp, job, world, specs):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER.replace("JOB_TIMEOUT_S",
                                               str(JOB_TIMEOUT_S)),
         str(r), str(world), tmp, job, json.dumps(specs)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _toks(done):
    return {r.rid: [int(t) for t in r.tokens] for r in done}


def _ragged(spec, mod):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in lens]
    return [mod.Request(rid=i, prompt=prompts[i], max_new=mn, arrival_s=0.0)
            for i, mn in enumerate(budgets)]


def _bursty(mod, smod):
    pol = smod.parse_slo_spec(POLICY)
    return smod.bursty_heavy_tail_trace(
        16, vocab_size=256, seed=7, burst_size=8, burst_gap_s=0.3,
        long_frac=0.6, mix=pol.mix([3.0, 2.0, 1.0]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both jobs, compute the references meanwhile, then collect."""
    tmp = str(tmp_path_factory.mktemp("torch_mesh_context"))
    cfg = reduced_config(get_config("qwen3-8b"))
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tree = np_tree(params)
    with open(f"{tmp}/params.pkl", "wb") as f:
        pickle.dump(tree, f)
    specs = {"meshes": MESHES, "policy": POLICY, "prefix": PREFIX,
             "prefix_batch": PREFIX_BATCH, "chunked": CHUNKED,
             "ragged": RAGGED}
    procs = {job: _launch(tmp, job, int(np.prod(m[0])), specs)
             for job, m in MESHES.items()}
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="psi8")
    tparams = params_from_numpy(tree, device="cpu")
    ref = {}
    # tokens do not depend on the schedule: one FIFO serve of each trace
    # on an ample pool, by the JAX Server and the port's single process
    traces = {"prefix": lambda m, s: m.poisson_trace(8, **PREFIX),
              "slo": _bursty,
              "chunked": lambda m, s: m.poisson_trace(6, **CHUNKED),
              "ragged": lambda m, s: _ragged(RAGGED, m)}
    for name, trace in traces.items():
        jdone, _ = JServer(cfg, params, max_batch=4, max_seq=112).serve(
            trace(jsched, jslo))
        tdone, _ = Server(tcfg, tparams, max_batch=4, max_seq=112,
                          device="cpu").serve(trace(tsched, tslo))
        ref[name] = {"jax": _toks(jdone), "port": _toks(tdone)}
    spec = Server(tcfg, tparams, max_batch=4, max_seq=64, speculative=(3, 4),
                  device="cpu")
    ref["spec"] = _toks(spec.serve(_ragged(RAGGED, tsched))[0])
    # the single process's prefix-cache serve on each mesh's ample pool
    for job, (*_, ample) in MESHES.items():
        srv = Server(dataclasses.replace(tcfg, prefix_cache=True), tparams,
                     max_batch=PREFIX_BATCH, max_seq=80, n_blocks=ample,
                     device="cpu")
        for mode in ("cont", "static"):
            done, st = srv.serve(tsched.poisson_trace(8, **PREFIX),
                                 continuous=mode == "cont")
            ref[f"{job}_prefix_{mode}"] = (_toks(done), st)
    got = {job: _collect(tmp, job, p) for job, p in procs.items()}
    return ref, got


def _rids(d):
    return {int(k): v for k, v in d.items()}


@pytest.mark.parametrize("job", list(MESHES))
@pytest.mark.parametrize("mode", ["cont", "static"])
def test_prefix_cache_across_shards(runs, job, mode):
    """--prefix-cache on, ample pool: tokens == the single process == the
    JAX Server; hits cross shards and their blocks are copied (>= 1
    copy); the prefix cache's counters and the reused / prefilled tokens
    equal the single process's; every block is free at the end."""
    ref, got = runs
    want = ref["prefix"]["jax"]
    assert ref["prefix"]["port"] == want
    single_toks, single = ref[f"{job}_prefix_{mode}"]
    assert single_toks == want
    copied = []
    for res in got[job]:
        r = res[f"prefix_{mode}"]
        st = r["stats"]
        assert _rids(r["tokens"]) == want
        assert st["slot_shards"] == int(np.prod(MESHES[job][0]))
        assert {k: st[k] for k in PREFIX_STATS} == {
            k: single[k] for k in PREFIX_STATS}
        assert st["prefix_cache"] == single["prefix_cache"]
        assert st["prefix_cache"]["hits"] > 0
        assert st["blocks_free_end"] == st["n_blocks"]
        copied.append(st["blocks_copied"])
    # every rank runs the same host loop: the same copies everywhere
    assert len(set(copied)) == 1
    if mode == "cont":
        assert copied[0] >= 1


@pytest.mark.parametrize("job", list(MESHES))
def test_slo_preemption_on_split_slots(runs, job):
    """SLO scheduling on a tight split pool: preemptions and restores
    happen, tokens == the single process == the JAX Server, no block
    leaks."""
    ref, got = runs
    want = ref["slo"]["jax"]
    assert ref["slo"]["port"] == want
    for res in got[job]:
        r = res["slo"]
        assert _rids(r["tokens"]) == want
        assert r["stats"]["preemptions"] > 0
        assert r["stats"]["prefix_cache"]["restores"] > 0
        assert r["stats"]["blocks_free_end"] == r["stats"]["n_blocks"]


@pytest.mark.parametrize("job", list(MESHES))
def test_chunked_prefill_on_split_slots(runs, job):
    ref, got = runs
    want = ref["chunked"]["jax"]
    assert ref["chunked"]["port"] == want
    for res in got[job]:
        r = res["chunked"]
        assert _rids(r["tokens"]) == want
        assert r["stats"]["prefill_chunks"] == 6 * 4
        assert r["stats"]["blocks_free_end"] == r["stats"]["n_blocks"]


@pytest.mark.parametrize("job", list(MESHES))
def test_speculation_on_split_slots(runs, job):
    """--speculative 3:4: tokens == plain decode == the single process's
    speculative serve == the JAX Server."""
    ref, got = runs
    want = ref["ragged"]["jax"]
    assert ref["ragged"]["port"] == want == ref["spec"]
    for res in got[job]:
        r = res["spec"]
        assert _rids(r["tokens"]) == want
        assert r["stats"]["speculative"]["rounds"] > 0
