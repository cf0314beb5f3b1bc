"""Tensor and expert parallelism of the MoE and SSM families on gloo ranks
(CPU), against the port's single process and the JAX package's Server.

Jobs and helpers follow ``test_torch_distributed.py``: one ``python -c``
process a rank, joined through a ``FileStore``, each job under its own
time limit; params come from the JAX package's ``init`` + ``quantize``
and reach every rank by interop.  Narrow configs (``d_model`` 1024, so
tensor parallelism engages):

* (1, 2) mesh, qwen3-moe with 8 experts (expert parallelism: 4 whole
  experts a rank, the experts' outputs all-gathered) on the paged pool
  and on the dense slab, and with 3 experts (tensor parallelism inside
  each expert: their d_ff columns split, the partial sums all-reduced);
* (1, 2) mesh, falcon-mamba with 2 layers at psi8 and at packed psi5
  (channels over "model": in_proj resliced by channel, x_proj and
  out_proj row-parallel; dense, the family's only layout), the psi5 one
  from this rank's share of the params (``params_are_local``);
* (2, 2) mesh, the 8-expert MoE with data and expert parallelism together.

Tokens identical to the single process and the JAX Server; forward logits
within ``ATOL`` of both (the attention's and the SSM's row-parallel
products add their partial sums in another order); a layer's MoE FFN on
the same input equal to the single process's bit for bit under expert
parallelism (the outputs are gathered, and the combine sums them in the
single process's order), within ``ATOL`` under tensor parallelism; the
SSM's f32 prefill state within ``STATE_ATOL`` on each rank's channels;
the collectives of one forward counted: two all-reduces a mamba layer.
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

from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import moe as tmoe
from test_torch_distributed import (RAGGED, _collect, _jax_params,
                                    _jax_tokens, _port_tokens, _rids,
                                    np_tree)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4                     # the logits tolerance of test_torch_model
STATE_ATOL = 1e-5               # the SSM parity tolerance of test_torch_ssm
JOB_TIMEOUT_S = 240
MOE = dict(d_model=1024, n_layers=1, n_heads=8, head_dim=128, d_ff=256,
           vocab_size=512)
# name: (arch, config overrides, bits)
PARAMS = {"ep": ("qwen3-moe-30b-a3b", MOE, 8),
          "tpe": ("qwen3-moe-30b-a3b", dict(MOE, n_experts=3), 8),
          "mamba8": ("falcon-mamba-7b", dict(d_model=1024, n_layers=2,
                                             vocab_size=512), 8),
          "mamba5": ("falcon-mamba-7b", dict(d_model=1024, n_layers=2,
                                             vocab_size=512), 5)}
# (1, 2) serves: case -> (params, cache layout, params_are_local)
TP_CASES = {"ep_paged": ("ep", "paged", False),
            "ep_dense": ("ep", "dense", False),
            "tpe_paged": ("tpe", "paged", False),
            "mamba8": ("mamba8", "dense", False),
            "mamba5": ("mamba5", "dense", True)}
RAGGED_TP = (RAGGED[0][:4], RAGGED[1][:4])

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
from repro_torch.models import moe
from repro_torch.runtime import parallel
from repro_torch.runtime.sharding import LeafPlacer

SPECS = json.loads(sys.argv[5])

def load(name):
    with open(f"{tmp}/{name}.pkl", "rb") as f:
        arch, cfg_kw, tree = pickle.load(f)
    cfg = reduced_config(get_config(arch), **cfg_kw)
    return cfg, params_from_numpy(tree, device="cpu")

def serve(server, spec, vocab, cont=True):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]
    done, st = server.serve([Request(rid=i, prompt=prompts[i], max_new=mn,
                                     arrival_s=0.0)
                             for i, mn in enumerate(budgets)], continuous=cont)
    return {"tokens": {r.rid: [int(t) for t in r.tokens] for r in done},
            "slot_shards": st["slot_shards"], "collectives": st["collectives"]}

out = {}
toks = torch.as_tensor(np.stack([np.arange(8) * 7 % 512,
                                 np.arange(8) * 3 + 1]).astype(np.int32))
if job == "tp":
    mesh = make_mesh((1, 2), ("data", "model"))
    for case, (name, layout, local) in SPECS["tp_cases"].items():
        cfg, params = load(name)
        cfg = dataclasses.replace(cfg, cache_layout=layout)
        given = LeafPlacer(cfg, mesh).place_tree(params) if local else params
        s = Server(cfg, given, max_batch=2, max_seq=64, device="cpu",
                   mesh=mesh, params_are_local=local)
        res = serve(s, SPECS["ragged_tp"], cfg.vocab_size)
        ex = s.executor
        parallel.reset_collective_counts()
        with torch.inference_mode():
            lg, states = ex.model.forward(ex.params, toks)
        res["forward_collectives"] = parallel.collective_counts()
        np.save(f"{tmp}/{case}_logits.{rank}.npy", lg.numpy())
        if cfg.family == "ssm":
            np.save(f"{tmp}/{case}_ssm.{rank}.npy",
                    np.stack([st["ssm"].numpy() for st in states]))
            res["local_d_inner"] = ex.local_cfg.d_inner
        else:
            # one MoE FFN on the same input: this rank's share against the
            # whole layer
            x = torch.randn((2, 8, cfg.d_model),
                            generator=torch.Generator().manual_seed(1))
            with torch.inference_mode():
                mine, _ = moe.moe_ffn(ex.params["layers"][0]["moe"], x,
                                      ex.local_cfg)
                whole, _ = moe.moe_ffn(params["layers"][0]["moe"], x, cfg)
            res["moe_ffn_max_abs"] = float((mine - whole).abs().max())
            res["moe_ffn_scale"] = float(whole.abs().max())
            res["expert_shape"] = list(ex.params["layers"][0]["moe"]["w_gate"].shape)
            res["shard_kind"] = ex.params["layers"][0]["moe"]["shard"].kind
        out[case] = res
elif job == "dp_ep":
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg, params = load("ep")
    s = Server(cfg, params, max_batch=4, max_seq=64, device="cpu", mesh=mesh)
    out["cont"] = serve(s, SPECS["ragged"], cfg.vocab_size)
    out["static"] = serve(s, SPECS["ragged"], cfg.vocab_size, False)
    out["local"] = [s.executor.local_batch,
                    list(s.executor.params["layers"][0]["moe"]["w_gate"].shape)]
with open(f"{tmp}/{job}.{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _launch(tmp, job, world, specs):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER.replace("JOB_TIMEOUT_S",
                                               str(JOB_TIMEOUT_S)),
         str(r), str(world), tmp, job, json.dumps(specs)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both jobs, compute the references meanwhile, then collect."""
    tmp = str(tmp_path_factory.mktemp("torch_tp_families"))
    jax_p = {name: _jax_params(arch, kw, bits)
             for name, (arch, kw, bits) in PARAMS.items()}
    for name, (arch, kw, bits) in PARAMS.items():
        with open(f"{tmp}/{name}.pkl", "wb") as f:
            pickle.dump((arch, dict(kw, quant_mode=f"psi{bits}"),
                         np_tree(jax_p[name][1])), f)
    specs = {"tp_cases": TP_CASES, "ragged_tp": RAGGED_TP, "ragged": RAGGED}
    procs = {"tp": _launch(tmp, "tp", 2, specs),
             "dp_ep": _launch(tmp, "dp_ep", 4, specs)}
    toks = np.stack([np.arange(8) * 7 % 512,
                     np.arange(8) * 3 + 1]).astype(np.int32)
    ref = {}
    for name, (arch, kw, bits) in PARAMS.items():
        cfg, params = jax_p[name]
        tcfg = tconfigs.reduced_config(tconfigs.get_config(arch), **kw,
                                       quant_mode=f"psi{bits}")
        with open(f"{tmp}/{name}.pkl", "rb") as f:
            tparams = params_from_numpy(pickle.load(f)[2], device="cpu")
        with torch.inference_mode():
            lg, states = tbuild_model(tcfg).forward(tparams,
                                                    torch.as_tensor(toks))
        jlg = np.asarray(build_model(cfg).forward(
            params, {"tokens": jax.numpy.asarray(toks)})[0], np.float32)
        ref[name] = {"logits": lg.numpy(), "jax_logits": jlg}
        if tcfg.family == "ssm":
            ref[name]["ssm"] = np.stack([st["ssm"].numpy() for st in states])
        layouts = ({"dense"} if tcfg.family == "ssm" else
                   {lay for n, lay, _ in TP_CASES.values() if n == name})
        for layout in layouts:
            jc = dataclasses.replace(cfg, cache_layout=layout)
            tc = dataclasses.replace(tcfg, cache_layout=layout)
            ref[name][layout] = {
                "jax": _jax_tokens(jc, params, RAGGED_TP, 2),
                "port": _port_tokens(tc, tparams, RAGGED_TP, 2)}
        if name == "ep":
            ref["dp_ep"] = {"jax": _jax_tokens(cfg, params, RAGGED, 4),
                            "port": _port_tokens(tcfg, tparams, RAGGED, 4)}
    got = {job: _collect(tmp, job, p) for job, p in procs.items()}
    return ref, got, tmp


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_serve_matches(runs, case):
    """(1, 2): tokens identical to the single process and the JAX Server;
    forward logits within ATOL of both, on both ranks."""
    ref, got, tmp = runs
    name, layout, _ = TP_CASES[case]
    r = ref[name]
    assert r[layout]["port"] == r[layout]["jax"]
    for rank, res in enumerate(got["tp"]):
        mine = res[case]
        assert _rids(mine["tokens"]) == r[layout]["port"]
        assert mine["slot_shards"] == 1
        lg = np.load(f"{tmp}/{case}_logits.{rank}.npy")
        np.testing.assert_allclose(lg, r["logits"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(lg, r["jax_logits"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["ep_paged", "ep_dense", "tpe_paged"])
def test_moe_shares(runs, case):
    """Expert parallelism (8 experts, 4 a rank): the layer's FFN equals the
    single process's bit for bit, one all-gather of the experts' outputs
    a layer; tensor parallelism inside each expert (3 experts, d_ff 256 ->
    128 columns a rank): within ATOL, one all-reduce of the partial sums a
    layer.  Either way the attention's wo and the embedding all-reduce and
    the logits all-gather as in dense TP."""
    _, got, _ = runs
    L = PARAMS["ep"][1]["n_layers"]
    for rank, res in enumerate(got["tp"]):
        mine = res[case]
        c = mine["forward_collectives"]
        if case.startswith("ep"):
            assert mine["shard_kind"] == "ep"
            assert mine["expert_shape"] == [4, 1024, 256]
            assert mine["moe_ffn_max_abs"] == 0.0
            assert (c["all_gather"], c["all_reduce"]) == (L + 1, L + 1)
        else:
            assert mine["shard_kind"] == "tp"
            assert mine["expert_shape"] == [3, 1024, 128]
            assert mine["moe_ffn_max_abs"] <= ATOL * max(
                1.0, mine["moe_ffn_scale"])
            assert (c["all_gather"], c["all_reduce"]) == (1, 2 * L + 1)


@pytest.mark.parametrize("case", ["mamba8", "mamba5"])
def test_ssm_channels_match(runs, case):
    """falcon-mamba on (1, 2): each rank's f32 prefill state is the single
    process's on its channels [r di/2, (r+1) di/2) within STATE_ATOL; a
    forward issues two all-reduces a mamba layer (x_proj, out_proj), one
    for the embedding and the logits' all-gather, nothing else."""
    ref, got, tmp = runs
    name = TP_CASES[case][0]
    full = ref[name]["ssm"]                           # (L, B, di, N)
    di = full.shape[2]
    L = PARAMS[name][1]["n_layers"]
    for rank, res in enumerate(got["tp"]):
        assert res[case]["local_d_inner"] == di // 2
        mine = np.load(f"{tmp}/{case}_ssm.{rank}.npy")
        want = full[:, :, rank * di // 2:(rank + 1) * di // 2]
        np.testing.assert_allclose(mine, want, rtol=0, atol=STATE_ATOL)
        c = res[case]["forward_collectives"]
        assert c == {"all_gather": 1, "all_reduce": 2 * L + 1,
                     "broadcast": 0, "reduce_scatter": 0, "send": 0,
                     "recv": 0}


def test_dp_and_ep_together(runs):
    """(2, 2): the slots split over "data" (2 a rank), the 8 experts over
    "model" (4 a rank); continuous and static: tokens == the single
    process == the JAX Server."""
    ref, got, _ = runs
    want = ref["dp_ep"]["jax"]
    assert ref["dp_ep"]["port"] == want
    for res in got["dp_ep"]:
        assert res["local"] == [2, [4, 1024, 256]]
        for mode in ("cont", "static"):
            assert _rids(res[mode]["tokens"]) == want
            assert res[mode]["slot_shards"] == 2
            assert res[mode]["collectives"]["all_gather"] > 0
