"""Tensor parallelism of the port on gloo ranks (CPU), part two: the f32
row-parallel sums, KV heads that do not split over "model" (the dense KV
ring split over it), the RG-LRU hybrid's channels and speculation with
TP, against the port's single process and the JAX package's Server.

Jobs and helpers follow ``test_torch_distributed.py``: one ``python -c``
process a rank, joined through a ``FileStore``, each job under its own
time limit with faulthandler; params come from the JAX package's
``init`` + ``quantize`` and reach every rank by interop.  Narrow configs
(``d_model`` 1024, so tensor parallelism engages):

* (1, 2), qwen3-8b at bf16: a row-parallel leaf's output (``wo``,
  ``w_down``) on a rank equals the single process's in at least 99 % of
  its entries bit for bit and nowhere by more than one bf16 ulp (each
  rank's partial sum stays f32 until the all-reduce has added them);
  greedy tokens identical;
* (1, 2), granite (MQA) on the dense layout: the ring's 64 positions
  split 32 a rank; and with a sliding window of 32 over prompts and
  budgets past it, so the ring wraps on both ranks;
* (1, 4), chatglm3 (2 KV heads) on the dense layout (the ring split 4
  ways, two query heads a rank reading one KV head) and on the paged
  pool (the query heads gathered around the kernel read);
* (1, 2), recurrentgemma (``d_rnn`` 256 split 128 a rank, its SWA ring
  split too) at horizon 1 and 4: ``rglru_block`` and a decode step's
  ``h`` within ``STATE_ATOL`` on each rank's channels;
* (1, 2), qwen3-8b psi8 with ``--speculative 3:4``: the draft tree is
  wrapped as the target's.

Tokens identical to the single process and the JAX Server; forward logits,
and the logits of a few decode steps over the split ring, within ``ATOL``
of the single process's.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch.scheduler import Request as JRequest
from repro.launch.serve import Server as JServer
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch.scheduler import Request
from repro_torch.launch.serve import Server
from repro_torch.models import rglru as trglru
from repro_torch.quant import linear as tlinear
from repro_torch.runtime.executor import Executor
from test_torch_distributed import (NARROW, RAGGED, _collect, _jax_params,
                                    _rids, np_tree)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4                     # the logits tolerance of test_torch_model
STATE_ATOL = 1e-5               # the RG-LRU tolerance of test_torch_hybrid
JOB_TIMEOUT_S = 240
RAGGED_TP = (RAGGED[0][:4], RAGGED[1][:4])
# prompts and budgets past the reduced window of 32: the ring wraps
LONG = ([20, 30, 40, 26], [20, 12, 8, 16])
PROBE_PROMPT = 30               # the decode probe: a 30-token prompt ...
PROBE_STEPS = 6                 # ... then 6 greedy steps (past 32: wraps)
HYBRID = dict(d_model=1024, n_layers=3, n_heads=8, head_dim=128, d_ff=256,
              vocab_size=512, d_rnn=256)
SWA = dict(attn_type="swa", window=32)
# name: (arch, config overrides, bits)
PARAMS = {"bf16": ("qwen3-8b", dict(NARROW, dtype="bfloat16"), 8),
          "granite": ("granite-34b", dict(NARROW, n_kv_heads=1), 5),
          "granite_swa": ("granite-34b", dict(NARROW, n_kv_heads=1, **SWA),
                          5),
          "chatglm": ("chatglm3-6b", dict(NARROW, n_kv_heads=2), 8),
          "hybrid": ("recurrentgemma-9b", HYBRID, 8),
          "spec": ("qwen3-8b", NARROW, 8)}
# serves: case -> (params, mesh, layout, trace, server kwargs)
CASES = {
    "bf16": ("bf16", (1, 2), "paged", "ragged_tp", {}),
    "granite_dense": ("granite", (1, 2), "dense", "ragged_tp", {}),
    "granite_swa": ("granite_swa", (1, 2), "dense", "long", {}),
    "chatglm_dense": ("chatglm", (1, 4), "dense", "ragged_tp", {}),
    "chatglm_paged": ("chatglm", (1, 4), "paged", "ragged_tp", {}),
    "hybrid_h1": ("hybrid", (1, 2), "dense", "long", {}),
    "hybrid_h4": ("hybrid", (1, 2), "dense", "ragged_tp",
                  {"decode_horizon": 4}),
    "spec": ("spec", (1, 2), "paged", "ragged_tp", {"speculative": [3, 4]}),
}
# the jobs: name -> (world, cases); they run side by side
JOBS = {"two": (2, ["bf16", "granite_dense", "granite_swa", "hybrid_h1",
                    "hybrid_h4", "spec"]),
        "four": (4, ["chatglm_dense", "chatglm_paged"])}
# the dense cases whose decode logits the probe reads
PROBED = ("granite_dense", "granite_swa", "chatglm_dense", "hybrid_h1")

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
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.scheduler import Request
from repro_torch.launch.serve import Server
from repro_torch.models import rglru
from repro_torch.quant import linear
from repro_torch.runtime import parallel

SPECS = json.loads(sys.argv[5])

def load(name):
    with open(f"{tmp}/{name}.pkl", "rb") as f:
        arch, cfg_kw, tree = pickle.load(f)
    cfg = reduced_config(get_config(arch), **cfg_kw)
    return cfg, params_from_numpy(tree, device="cpu")

def serve(server, spec, vocab):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]
    done, st = server.serve([Request(rid=i, prompt=prompts[i], max_new=mn,
                                     arrival_s=0.0)
                             for i, mn in enumerate(budgets)])
    return {"tokens": {r.rid: [int(t) for t in r.tokens] for r in done},
            "collectives": st["collectives"]}

PROBE

toks = torch.as_tensor(np.stack([np.arange(8) * 7 % 512,
                                 np.arange(8) * 3 + 1]).astype(np.int32))
meshes = {}
out = {}
for case in SPECS["jobs"][job]:
    name, shape, layout, trace, kw = SPECS["cases"][case]
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"))
    cfg, params = load(name)
    cfg = dataclasses.replace(cfg, cache_layout=layout)
    s = Server(cfg, params, max_batch=2, max_seq=64, device="cpu",
               mesh=meshes[shape], **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in kw.items()})
    ex = s.executor
    res = serve(s, SPECS["traces"][trace], cfg.vocab_size)
    res["local"] = [ex.local_cfg.n_heads, ex.local_cfg.n_kv_heads,
                    ex.local_cfg.resolved_d_rnn, ex._ring_split]
    kv = [t for layer in ex.init_cache().kv for n, t in layer.items()
          if n in ("k", "h")]
    res["cache_shapes"] = [list(t.shape) for t in kv]
    with torch.inference_mode():
        lg, _ = ex.model.forward(ex.params, toks)
    np.save(f"{tmp}/{case}_logits.{rank}.npy", lg.float().numpy())
    if case in SPECS["probed"]:
        parallel.reset_collective_counts()
        np.save(f"{tmp}/{case}_probe.{rank}.npy", decode_probe(ex))
        res["probe_collectives"] = parallel.collective_counts()
    if case == "bf16":
        # the row-parallel leaves of layer 0 on the same bf16 rows, each
        # rank its K chunk
        for leaf, p in (("wo", ex.params["layers"][0]["attn"]["wo"]),
                        ("w_down", ex.params["layers"][0]["mlp"]["w_down"])):
            K = p.w.data.shape[-2] * 2
            x = torch.randn((16, K), generator=torch.Generator().manual_seed(5)
                            ).to(torch.bfloat16)
            with torch.inference_mode():
                y = linear(p, x[:, rank * K // 2:(rank + 1) * K // 2])
            res[f"{leaf}_dtype"] = str(y.dtype)
            np.save(f"{tmp}/bf16_{leaf}.{rank}.npy", y.float().numpy())
    if case == "hybrid_h1":
        p = ex.params["layers"][0]["rec"]
        gen = torch.Generator().manual_seed(1)
        x = torch.randn((2, 8, cfg.d_model), generator=gen)
        x1 = torch.randn((2, 1, cfg.d_model), generator=gen)
        with torch.inference_mode():
            y, st = rglru.rglru_block(p, x, ex.local_cfg)
            y1, st1 = rglru.rglru_decode_step(p, x1, ex.local_cfg, st)
        np.savez(f"{tmp}/rglru.{rank}.npz", y=y.numpy(), h=st["h"].numpy(),
                 y1=y1.numpy(), h1=st1["h"].numpy())
    if case == "spec":
        res["draft_kinds"] = [ex.draft_params["layers"][0]["attn"][n].kind
                              for n in ("wq", "wo")]
    out[case] = res
with open(f"{tmp}/{job}.{rank}.json", "w") as f:
    json.dump(out, f)
# every rank is past its last collective; leave without running the
# process group's teardown, which can race a peer's exit under load
dist.barrier()
os._exit(0)
'''

# the decode probe, run by the ranks and by the single process alike: a
# prompt prefilled into slot 0, then greedy decode steps with slot 1 idle;
# returns slot 0's logits at every step (the vocab-parallel logits are
# gathered, so every rank holds them whole)
PROBE = r'''
def decode_probe(ex):
    import numpy as np, torch
    V = ex.cfg.vocab_size
    prompt = (np.arange(PROBE_PROMPT) * 5 % V).astype(np.int32)[None]
    cache = ex.init_cache()
    with torch.inference_mode():
        first, cache = ex.prefill_insert(prompt, np.asarray([PROBE_PROMPT]),
                                         cache, 0)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        tok[0, 0] = int(np.asarray(first)[0])
        pos = torch.zeros((2, 1), dtype=torch.int32)
        pos[0, 0] = PROBE_PROMPT
        act = torch.tensor([True, False])
        rows = []
        for _ in range(PROBE_STEPS):
            lg, cache = ex.model.decode_step(
                ex.params, {"token": tok, "pos": pos, "active": act}, cache)
            rows.append(lg[0].float().numpy())
            tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
            pos = pos + 1
    return np.stack(rows)
'''.replace("PROBE_PROMPT", str(PROBE_PROMPT)).replace(
    "PROBE_STEPS", str(PROBE_STEPS))
_probe_ns = {}
exec(PROBE, _probe_ns)
decode_probe = _probe_ns["decode_probe"]


def _launch(tmp, job, world, specs):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    src = WORKER.replace("JOB_TIMEOUT_S", str(JOB_TIMEOUT_S)).replace(
        "PROBE\n", PROBE + "\n")
    return [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(world), tmp, job,
         json.dumps(specs)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _trace(spec, vocab, mod):
    lens, budgets = spec
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in lens]
    return [mod(rid=i, prompt=prompts[i], max_new=mn, arrival_s=0.0)
            for i, mn in enumerate(budgets)]


def _tokens(done):
    return {r.rid: [int(t) for t in r.tokens] for r in done}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both jobs, compute the references meanwhile, then collect."""
    tmp = str(tmp_path_factory.mktemp("torch_tp_ring"))
    jax_p = {name: _jax_params(arch, kw, bits)
             for name, (arch, kw, bits) in PARAMS.items()}
    for name, (arch, kw, bits) in PARAMS.items():
        with open(f"{tmp}/{name}.pkl", "wb") as f:
            pickle.dump((arch, dict(kw, quant_mode=f"psi{bits}"),
                         np_tree(jax_p[name][1])), f)
    traces = {"ragged_tp": RAGGED_TP, "long": LONG}
    specs = {"cases": CASES, "jobs": {j: c for j, (_, c) in JOBS.items()},
             "traces": traces, "probed": PROBED}
    procs = {job: _launch(tmp, job, world, specs)
             for job, (world, _) in JOBS.items()}
    toks = torch.as_tensor(np.stack([np.arange(8) * 7 % 512,
                                     np.arange(8) * 3 + 1]).astype(np.int32))
    ref = {}
    tparams = {}
    for name, (arch, kw, bits) in PARAMS.items():
        with open(f"{tmp}/{name}.pkl", "rb") as f:
            tparams[name] = params_from_numpy(pickle.load(f)[2], device="cpu")
    for case, (name, _, layout, trace, kw) in CASES.items():
        arch, ckw, bits = PARAMS[name]
        jcfg, jparams = jax_p[name]
        jcfg = dataclasses.replace(jcfg, cache_layout=layout)
        tcfg = tconfigs.reduced_config(tconfigs.get_config(arch), **ckw,
                                       quant_mode=f"psi{bits}",
                                       cache_layout=layout)
        skw = {k: tuple(v) if isinstance(v, list) else v
               for k, v in kw.items()}
        spec = traces[trace]
        srv = Server(tcfg, tparams[name], max_batch=2, max_seq=64,
                     device="cpu", **skw)
        r = {"port": _tokens(srv.serve(_trace(spec, tcfg.vocab_size,
                                              Request))[0])}
        if case != "bf16":
            jsrv = JServer(jcfg, jparams, max_batch=2, max_seq=64, **skw)
            r["jax"] = _tokens(jsrv.serve(_trace(spec, jcfg.vocab_size,
                                                 JRequest))[0])
        if case == "spec":
            plain = Server(tcfg, tparams[name], max_batch=2, max_seq=64,
                           device="cpu")
            r["plain"] = _tokens(plain.serve(_trace(spec, tcfg.vocab_size,
                                                    Request))[0])
        with torch.inference_mode():
            lg, _ = srv.executor.model.forward(srv.executor.params, toks)
        r["logits"] = lg.float().numpy()
        if case in PROBED:
            ex = Executor(tcfg, tparams[name], max_batch=2, max_seq=64,
                          device="cpu")
            r["probe"] = decode_probe(ex)
        ref[case] = r
    # the single process's row-parallel leaves and RG-LRU block
    lay = tparams["bf16"]["layers"][0]
    for leaf, p in (("wo", lay["attn"]["wo"]), ("w_down", lay["mlp"]["w_down"])):
        K = p.data.shape[-2]
        x = torch.randn((16, K), generator=torch.Generator().manual_seed(5)
                        ).to(torch.bfloat16)
        with torch.inference_mode():
            ref[f"bf16_{leaf}"] = tlinear(p, x)
    hcfg = tconfigs.reduced_config(tconfigs.get_config("recurrentgemma-9b"),
                                   **HYBRID, quant_mode="psi8")
    p = tparams["hybrid"]["layers"][0]["rec"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, hcfg.d_model), generator=gen)
    x1 = torch.randn((2, 1, hcfg.d_model), generator=gen)
    with torch.inference_mode():
        y, st = trglru.rglru_block(p, x, hcfg)
        y1, st1 = trglru.rglru_decode_step(p, x1, hcfg, st)
    ref["rglru"] = {"y": y.numpy(), "h": st["h"].numpy(), "y1": y1.numpy(),
                    "h1": st1["h"].numpy()}
    got = {job: _collect(tmp, job, p) for job, p in procs.items()}
    by_case = {}
    for job, (_, cases) in JOBS.items():
        for case in cases:
            by_case[case] = [res[case] for res in got[job]]
    return ref, by_case, tmp


def _bf16_bits(a) -> np.ndarray:
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64)


@pytest.mark.parametrize("leaf", ["wo", "w_down"])
def test_row_parallel_sums_in_f32(runs, leaf):
    """(1, 2), bf16 rows: the row-parallel output on each rank equals the
    single process's in >= 99 % of entries bit for bit and nowhere by
    more than one bf16 ulp (each rank's partial stays f32 through the
    all-reduce; only the order of the f32 sum differs)."""
    ref, got, tmp = runs
    want = _bf16_bits(ref[f"bf16_{leaf}"].float().numpy())
    for rank, res in enumerate(got["bf16"]):
        assert res[f"{leaf}_dtype"] == "torch.bfloat16"
        mine = _bf16_bits(np.load(f"{tmp}/bf16_{leaf}.{rank}.npy"))
        diff = np.abs(mine - want)
        assert diff.max() <= 1, diff.max()
        assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_bf16_tokens_match(runs):
    ref, got, _ = runs
    for res in got["bf16"]:
        assert _rids(res["tokens"]) == ref["bf16"]["port"]


@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_serve_matches(runs, case):
    """Tokens identical to the single process and to the JAX Server;
    forward logits within ATOL of the single process's on every rank."""
    ref, got, tmp = runs
    r = ref[case]
    assert r["port"] == r["jax"]
    for rank, res in enumerate(got[case]):
        assert _rids(res["tokens"]) == r["port"]
        lg = np.load(f"{tmp}/{case}_logits.{rank}.npy")
        np.testing.assert_allclose(lg, r["logits"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", PROBED)
def test_split_ring_decode(runs, case):
    """The dense KV ring split over "model": each rank holds C/m ring
    positions (here 64 / m, or the window's 32 / 2), and a 30-token
    prompt's next 6 decode steps (past the window: the ring wraps) give
    logits within ATOL of the single process's on every rank; each step
    gathers the query heads and the partial sums once an attention
    layer."""
    ref, got, tmp = runs
    name, shape, *_ = CASES[case]
    m = shape[1]
    arch, ckw, _ = PARAMS[name]
    C = 32 if "window" in ckw or arch == "recurrentgemma-9b" else 64
    n_attn = (1 if arch == "recurrentgemma-9b" else ckw["n_layers"])
    for rank, res in enumerate(got[case]):
        assert res["local"][3] == m
        kv = [s for s in res["cache_shapes"] if len(s) == 4]
        assert kv and all(s[1] == C // m for s in kv), res["cache_shapes"]
        mine = np.load(f"{tmp}/{case}_probe.{rank}.npy")
        np.testing.assert_allclose(mine, ref[case]["probe"], rtol=0,
                                   atol=ATOL)
        # per step and attention layer: the query heads and the partial
        # sums; per step the logits (and the prefill's none)
        c = res["probe_collectives"]
        assert c["all_gather"] >= PROBE_STEPS * (2 * n_attn + 1)


def test_local_shares(runs):
    """What each rank holds: chatglm3's 2 KV heads whole (the projection
    gathered) beside 2 of the 8 query heads, on the dense ring split 4
    ways and on the paged pool; the hybrid's 4 query heads, its 1 KV head
    and 128 of its 256 RG-LRU channels (state h (B, 128))."""
    _, got, _ = runs
    for res in got["chatglm_dense"]:
        assert res["local"] == [2, 2, 1024, 4]
    for res in got["chatglm_paged"]:
        assert res["local"] == [2, 2, 1024, 1]
    for case in ("hybrid_h1", "hybrid_h4"):
        for res in got[case]:
            assert res["local"] == [4, 1, 128, 2]
            hs = [s for s in res["cache_shapes"] if len(s) == 2]
            assert hs and all(s == [2, 128] for s in hs)


def test_rglru_channels_match(runs):
    """The hybrid's rec block on (1, 2): the block's output (after the
    row-parallel w_out) and each rank's state h on its channels [r dr/2,
    (r+1) dr/2) within STATE_ATOL of the single process, at prefill and
    after one decode step."""
    ref, got, tmp = runs
    want = ref["rglru"]
    dr = want["h"].shape[-1]
    for rank in range(len(got["hybrid_h1"])):
        mine = np.load(f"{tmp}/rglru.{rank}.npz")
        cut = slice(rank * dr // 2, (rank + 1) * dr // 2)
        for k in ("y", "y1"):
            np.testing.assert_allclose(mine[k], want[k], rtol=0,
                                       atol=STATE_ATOL)
        for k in ("h", "h1"):
            np.testing.assert_allclose(mine[k], want[k][:, cut], rtol=0,
                                       atol=STATE_ATOL)


def test_speculation_with_tp(runs):
    """--speculative 3:4 on (1, 2): tokens identical to plain decode, the
    single process and the JAX Server; the draft tree's leaves are
    wrapped as the target's (wq column-parallel, wo row-parallel)."""
    ref, got, _ = runs
    r = ref["spec"]
    assert r["port"] == r["plain"] == r["jax"]
    for res in got["spec"]:
        assert _rids(res["tokens"]) == r["port"]
        assert res["draft_kinds"] == ["column", "row"]
