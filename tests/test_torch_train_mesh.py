"""Sharded training and the GPipe pipeline of the port on gloo ranks (CPU),
against the port's single process and the JAX package.

One job of four ``python -c`` rank processes, joined through a
``FileStore`` in a temporary directory and run under its own time limit
(faulthandler dumps a hang's stacks), starts when the module's fixture is
first used and runs while the main process computes the JAX references.
Params come from the JAX package's ``init``, carried to every rank by
interop.  Rank 0 also runs the port's single-process ``make_train_step``
in lockstep and compares every gathered state with it (every rank reports
a digest of its gathered states, which must equal rank 0's).

* (2, 2) mesh, reduced qwen3-8b (``d_model`` 64: TP off, every leaf
  replicated, the rows split four ways), batch 8 x 32, quant ``none`` and
  ``qat8``, 3 AdamW steps (clip on).
* The ``NARROW`` qwen3-8b (``d_model`` 1024, 2 layers: TP on, so the
  weights split over "data" x "model" and the rows over "data" only): one
  step on the (1, 2) mesh; on the (2, 2) mesh 2 steps, a checkpoint
  written from the chunks, a third step, and the checkpoint restored with
  ``shardings=`` onto the (1, 2) mesh ``plan_remesh(2, model_parallel=2)``
  gives and stepped once: both against three single-process steps; one
  step on a (2, 1, 2) ("pod", "data", "model") mesh.
* Reduced recurrentgemma-9b and reduced qwen3-moe on (2, 2): one step
  each (the MoE load-balancing loss over the global batch).
* The twin of the JAX package's ``test_elastic_restart_resharded``: an 8 x
  8 ``arange`` leaf under ``P("data", "model")`` saved from (2, 2) chunks
  restores onto (1, 2), each rank its own chunk.
* ``pipeline_apply`` on ("stage",) meshes of 4 and 2 ranks (and M < S):
  the JAX sequential apply within 1e-5 on every rank.

Tolerances.  Losses and gradient norms: ``LOSS_RTOL`` of the single
process's at every step (a mesh's loss is a mean of per-rank means, its
gradient a sum over ranks: the same f32 terms grouped otherwise), the
first loss also of JAX's.  One step on (1, 2), whose ranks hold the same
rows: ``OPT_RTOL`` / ``OPT_ATOL`` of ``test_torch_train``.  Where the rows
split, those cannot hold, and the states are held to stated bounds
instead.  Adam's ``m / (sqrt(v) + eps)`` is about +-1 for any gradient
well above eps, so an element whose gradient is a rounding away from
eps-size takes an update anywhere within lr of the other run's.  So after
the first step ``m`` and ``v`` (the clipped gradient and its square) are
held within ``GRAD_REL`` of each leaf's largest value and the params
within ``LR``; after three (the gradients now taken at params that
parted) ``m`` and ``v`` within ``STATE_REL`` of each leaf's largest value
and the params within ``2 x LR x STEPS``, the most two runs part by when
an update flips sign every step.  Measured on the CPU: ``m`` / ``v``
within 4.2e-6 after one step, 2.7e-4 after three; params 1.1e-4 and
1.15e-3 apart (the ``NARROW`` mesh), 1.8e-7 / 4.5e-6 (reduced, ``none``
/ ``qat8``).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import build_model
from repro.runtime.pipeline_par import pipeline_bubble_fraction as j_bubble
from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.optim import adamw
from repro_torch.runtime.pipeline_par import (pipeline_apply,
                                              pipeline_bubble_fraction)
from repro_torch.runtime.sharding import AxisMesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
OPT_RTOL = 1e-6            # test_torch_train's, three optimizer steps
OPT_ATOL = 1e-9
GRAD_REL = 1e-5
STATE_REL = 1e-3
LR = 1e-3
STEPS = 3
NARROW = dict(d_model=1024, n_layers=2, n_heads=8, head_dim=128, d_ff=2048,
              vocab_size=512)
CASES = {"qwen": ("qwen3-8b", {}), "narrow": ("qwen3-8b", NARROW),
         "rg": ("recurrentgemma-9b", {}), "moe": ("qwen3-moe-30b-a3b", {})}
# the JAX package's GPipe test: layers, microbatches, rows, width
PIPE = dict(L=8, M=6, mb=4, d=16)

WORKER = r'''
import faulthandler, hashlib, json, pickle, sys, warnings
faulthandler.dump_traceback_later(JOB_TIMEOUT_S - 30, exit=True)    # a hang: say where
import numpy as np, torch, torch.distributed as dist
warnings.simplefilter("ignore")
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/job.store", world),
                        rank=rank, world_size=world)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import make_sharded_train_step, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import parallel, sharding as shr
from repro_torch.runtime.elastic import make_mesh_from_plan, plan_remesh
from repro_torch.runtime.fsdp import TrainShare
from repro_torch.runtime.pipeline_par import pipeline_apply

with open(f"{tmp}/inputs.pkl", "rb") as f:
    INP = pickle.load(f)
LR = INP["lr"]

def load(name, quant="none"):
    arch, kw, tree = INP["params"][name]
    cfg = reduced_config(get_config(arch), quant_mode=quant, **kw)
    return cfg, params_from_numpy(tree, device="cpu")

def batch(name, i):
    return {"tokens": torch.from_numpy(INP["batches"][name][i])}

class Single:
    """The port's single process (rank 0 only)."""
    def __init__(self, cfg, params):
        opt = adamw(lr=LR)
        self.p = tree_map(lambda t: t.clone(), params)
        self.s = opt.init(self.p)
        self.step_fn = make_train_step(build_model(cfg), opt)
    def step(self, b):
        self.p, self.s, _, met = self.step_fn(self.p, self.s, {}, b)
        return [float(met["loss"]), float(met["grad_norm"]), float(met["aux"])]
    def diff(self, got):
        out = {}
        for kind, want in (("params", self.p), ("m", self.s.m), ("v", self.s.v)):
            pairs = [(g.detach().numpy(), w.detach().numpy())
                     for g, w in zip(tree_leaves(got[kind]), tree_leaves(want))]
            out[kind] = {
                "max_abs": float(max(np.abs(g - w).max() for g, w in pairs)),
                "max_rel_leaf": float(max(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                                          for g, w in pairs)),
                "opt_tol": bool(all(np.allclose(g, w, rtol=1e-6, atol=1e-9)
                                    for g, w in pairs))}
        return out

def digest(tree):
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()

def run(cfg, share, local, st, name, steps, ref):
    """Sharded steps on ``steps``' batches; after each the gathered states,
    their digest and (rank 0) their distance from ``ref``, which takes the
    same step unless it already has."""
    step = make_sharded_train_step(build_model(cfg), adamw(lr=LR), share)
    rec = {"loss": [], "grad_norm": [], "aux": [], "digest": [], "single": [],
           "diff": []}
    for i in steps:
        local, st, met = step(local, st, share.local_batch(batch(name, i)))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        rec["aux"].append(float(met["aux"]))
        got = {"params": share.gather_tree(local), "m": share.gather_tree(st.m),
               "v": share.gather_tree(st.v)}
        rec["digest"].append(digest(got))
        if ref is not None:
            if ref.s.step == i:
                rec["single"].append(ref.step(batch(name, i)))
            rec["diff"].append(ref.diff(got))
    return local, st, rec

def fresh(cfg, mesh, params):
    share = TrainShare(cfg, mesh, params)
    local = share.place(tree_map(lambda t: t.clone(), params))
    return share, local, adamw(lr=LR).init(local)

out = {}
mesh22 = make_mesh((2, 2), ("data", "model"))
mesh12 = make_mesh_from_plan(plan_remesh(2, model_parallel=2))
on12 = shr.mesh_coordinate(mesh12) is not None
stage4 = make_mesh((4,), ("stage",))
stage2 = make_mesh((2,), ("stage",))

# (2, 2), reduced qwen3-8b (TP off): 3 steps at none and qat8
for quant in ("none", "qat8"):
    cfg, params = load("qwen", quant)
    share, local, st = fresh(cfg, mesh22, params)
    parallel.reset_collective_counts()
    local, st, rec = run(cfg, share, local, st, "qwen", range(3),
                         Single(cfg, params) if rank == 0 else None)
    rec["collectives"] = parallel.collective_counts()
    rec["specs"] = sorted({str(s) for s in tree_leaves(share.specs)})
    rec["rows"] = int(share.local_batch(batch("qwen", 0))["tokens"].shape[0])
    out[f"qwen_{quant}"] = rec

# a recurrent-state family on (2, 2): one step
cfg, params = load("rg")
share, local, st = fresh(cfg, mesh22, params)
out["rg"] = run(cfg, share, local, st, "rg", range(1),
                Single(cfg, params) if rank == 0 else None)[2]

# MoE on (2, 2): one step, the load-balancing loss over the global batch
cfg, params = load("moe")
share, local, st = fresh(cfg, mesh22, params)
parallel.reset_collective_counts()
out["moe"] = run(cfg, share, local, st, "moe", range(1),
                 Single(cfg, params) if rank == 0 else None)[2]
out["moe"]["collectives"] = parallel.collective_counts()
out["moe"]["rows"] = int(share.local_batch(batch("moe", 0))["tokens"].shape[0])

# NARROW (TP on) on (2, 2): 2 steps, a checkpoint, a third step
cfg, params = load("narrow")
share, local, st = fresh(cfg, mesh22, params)
ref = Single(cfg, params) if rank == 0 else None
local, st, rec = run(cfg, share, local, st, "narrow", range(2), ref)
rec["local_wq"] = list(local["layers"][0]["attn"]["wq"].shape)
rec["rows"] = int(share.local_batch(batch("narrow", 0))["tokens"].shape[0])
def ckpt_specs(specs):
    return {"params": specs, "opt": {"step": shr.P(), "m": specs, "v": specs}}
mgr = CheckpointManager(f"{tmp}/ckpt")
mgr.save(2, {"params": local, "opt": {"step": torch.tensor(st.step, dtype=torch.int32),
                                     "m": st.m, "v": st.v}},
         extra={"step": 2}, shardings=(ckpt_specs(share.specs), mesh22))
local, st, rec3 = run(cfg, share, local, st, "narrow", [2], ref)
for k in ("loss", "grad_norm", "aux", "digest", "single", "diff"):
    rec[k] += rec3[k]
out["narrow22"] = rec

# ... restored onto the (1, 2) mesh of plan_remesh(2, model_parallel=2)
if on12:
    share12 = TrainShare(cfg, mesh12, params)
    tree, extra = mgr.restore(shardings=(ckpt_specs(share12.specs), mesh12))
    st12 = AdamWState(int(tree["opt"]["step"][0]), tree["opt"]["m"], tree["opt"]["v"])
    local12, st12, rec = run(cfg, share12, tree["params"], st12, "narrow", [2], ref)
    rec.update(extra=extra, step=st12.step,
               local_wq=list(local12["layers"][0]["attn"]["wq"].shape))
    out["narrow12_restored"] = rec
    # one step from the initial params on (1, 2)
    share1, local1, st1 = fresh(cfg, mesh12, params)
    out["narrow12"] = run(cfg, share1, local1, st1, "narrow", range(1),
                          Single(cfg, params) if rank == 0 else None)[2]

# a pod mesh: the embedding's gradient all-reduced over ("pod", "data")
cfg, params = load("narrow")
mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"))
share3, local3, st3 = fresh(cfg, mesh3, params)
out["narrow3d"] = run(cfg, share3, local3, st3, "narrow", range(1),
                      Single(cfg, params) if rank == 0 else None)[2]
out["narrow3d"]["rows"] = int(share3.local_batch(batch("narrow", 0))["tokens"].shape[0])

# the arange leaf: saved from (2, 2) chunks, restored onto (1, 2)
full = torch.arange(64.0).reshape(8, 8)
spec = {"w": shr.P("data", "model")}
mgr8 = CheckpointManager(f"{tmp}/ckpt8")
mgr8.save(1, {"w": shr.local_shard(full, spec["w"], mesh22)}, extra={"step": 1},
          shardings=(spec, mesh22))
if on12:
    got, extra = mgr8.restore(shardings=(spec, mesh12))
    out["arange"] = {"chunk": got["w"].tolist(), "coord": shr.mesh_coordinate(mesh12),
                     "extra": extra}

# GPipe
ws = torch.from_numpy(INP["pipe"]["ws"])
xs = torch.from_numpy(INP["pipe"]["xs"])
layer = lambda w, x: torch.tanh(x @ w)
parallel.reset_collective_counts()
out["pipe4"] = pipeline_apply(layer, ws, xs, stage4).tolist()
out["pipe4_collectives"] = parallel.collective_counts()
out["pipe4_short"] = pipeline_apply(layer, ws, xs[:2], stage4).tolist()
if shr.mesh_coordinate(stage2) is not None:
    out["pipe2"] = pipeline_apply(layer, ws, xs, stage2).tolist()
with open(f"{tmp}/out.{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def _batches(vocab, seed, n=STEPS, shape=(8, 32)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=shape).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the job, compute the JAX references meanwhile, collect."""
    tmp = str(tmp_path_factory.mktemp("torch_train_mesh"))
    cfgs = {k: reduced_config(get_config(a), **kw)
            for k, (a, kw) in CASES.items()}
    jparams = {k: build_model(c).init(jax.random.PRNGKey(0))
               for k, c in cfgs.items()}
    batches = {k: _batches(c.vocab_size, seed=i)
               for i, (k, c) in enumerate(cfgs.items())}
    rng = np.random.default_rng(11)
    pipe = {"ws": (rng.normal(size=(PIPE["L"], PIPE["d"], PIPE["d"]))
                   * 0.2).astype(np.float32),
            "xs": rng.normal(size=(PIPE["M"], PIPE["mb"], PIPE["d"])
                             ).astype(np.float32)}
    with open(f"{tmp}/inputs.pkl", "wb") as f:
        pickle.dump({"lr": LR, "batches": batches, "pipe": pipe,
                     "params": {k: (a, kw, np_tree(jparams[k]))
                                for k, (a, kw) in CASES.items()}}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    world = 4
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.replace("JOB_TIMEOUT_S",
                                               str(JOB_TIMEOUT_S)),
         str(r), str(world), tmp], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    # the JAX references while the ranks run
    ref = {}
    for k, quant in (("qwen", "none"), ("qwen", "qat8"), ("narrow", "none"),
                     ("rg", "none"), ("moe", "none")):
        model = build_model(dataclasses.replace(cfgs[k], quant_mode=quant))
        ref[f"{k}_{quant}"] = float(model.loss(
            jparams[k], {"tokens": jnp.asarray(batches[k][0])})[0])
    # the MoE load-balancing loss over the whole batch, and the mean of the
    # four row shards' own (what a per-rank aux would give)
    moe_model = build_model(cfgs["moe"])
    rows = batches["moe"][0]
    ref["moe_aux"] = float(moe_model.loss(
        jparams["moe"], {"tokens": jnp.asarray(rows)})[1]["aux"])
    ref["moe_aux_shard_mean"] = float(np.mean([
        moe_model.loss(jparams["moe"], {"tokens": jnp.asarray(part)})[1]["aux"]
        for part in np.split(rows, 4)]))
    seq = jnp.asarray(pipe["xs"])
    for w in pipe["ws"]:
        seq = jnp.tanh(seq @ jnp.asarray(w))
    ref["pipe"] = np.asarray(seq)
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOB_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(err[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank overran {JOB_TIMEOUT_S} s (a wedged "
                    f"collective?)")
    assert not errs, errs[0]
    got = []
    for r in range(world):
        with open(f"{tmp}/out.{r}.json") as f:
            got.append(json.load(f))
    return ref, got


def _check_run(got, key, jax_loss, first, last, ranks=None):
    """Every rank's losses and gradient norms within LOSS_RTOL of rank 0's
    single process, the first loss of JAX's; every rank's gathered states
    equal rank 0's; rank 0's distances from the single process within
    ``first`` / ``last`` = (params atol, m and v relative to each leaf's
    largest value) after the first / the last step."""
    mine = got[0][key]
    single = mine["single"]
    assert len(single) == len(mine["loss"])
    assert abs(single[0][0] - jax_loss) <= LOSS_RTOL * abs(jax_loss)
    for r in ranks or range(len(got)):
        res = got[r][key]
        np.testing.assert_allclose(res["loss"], [s[0] for s in single],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["grad_norm"], [s[1] for s in single],
                                   rtol=LOSS_RTOL)
        assert res["digest"] == mine["digest"]
    for diff, (p_atol, rel) in ((mine["diff"][0], first),
                                (mine["diff"][-1], last)):
        assert diff["params"]["max_abs"] <= p_atol, diff
        for kind in ("m", "v"):
            assert diff[kind]["max_rel_leaf"] <= rel, diff


@pytest.mark.parametrize("quant", ["none", "qat8"])
def test_dp_loss_and_three_steps_match(runs, quant):
    """(2, 2), TP off: the rows split four ways (2 a rank), every leaf
    replicated (its gradient all-reduced over the mesh)."""
    ref, got = runs
    key = f"qwen_{quant}"
    _check_run(got, key, ref[key], (LR, GRAD_REL),
               (2 * LR * STEPS, STATE_REL))
    for res in got:
        assert res[key]["rows"] == 2 and res[key]["specs"] == ["P()"]
        assert res[key]["collectives"]["all_reduce"] > 0


def test_tp_on_one_step_matches(runs):
    """NARROW qwen3-8b on (1, 2): weights split over "model" (wq 512 of
    its 1024 columns a rank), both ranks hold all 8 rows: the loss ==
    JAX's, the states after one step within test_torch_train's OPT_RTOL
    / OPT_ATOL of the single process."""
    ref, got = runs
    _check_run(got, "narrow12", ref["narrow_none"], (LR, GRAD_REL),
               (LR, GRAD_REL), ranks=(0, 1))
    assert all(d["opt_tol"] for d in got[0]["narrow12"]["diff"][0].values())


def test_fsdp_checkpoint_restores_onto_the_remeshed_job(runs):
    """NARROW qwen3-8b on (2, 2): FSDP (wq (1024, 1024) is a (512, 512)
    chunk a rank, the rows 4 a rank); 2 steps, a checkpoint written from
    the chunks, a third step == three single-process steps; the
    checkpoint restored onto plan_remesh(2, model_parallel=2)'s (1, 2)
    mesh (each leaf cut at load, wq now (1024, 512)) and stepped once ==
    the same."""
    ref, got = runs
    _check_run(got, "narrow22", ref["narrow_none"], (LR, GRAD_REL),
               (2 * LR * STEPS, STATE_REL))
    for res in got:
        assert res["narrow22"]["local_wq"] == [512, 512]
        assert res["narrow22"]["rows"] == 4
    want = got[0]["narrow22"]["single"][-1]
    for rank in (0, 1):
        res = got[rank]["narrow12_restored"]
        assert res["extra"] == {"step": 2} and res["step"] == 3
        assert res["local_wq"] == [1024, 512]
        assert res["digest"] == got[0]["narrow12_restored"]["digest"]
        np.testing.assert_allclose([res["loss"][0], res["grad_norm"][0]],
                                   want[:2], rtol=LOSS_RTOL)
    diff = got[0]["narrow12_restored"]["diff"][0]
    assert diff["params"]["max_abs"] <= 2 * LR * STEPS, diff
    assert max(diff[k]["max_rel_leaf"] for k in ("m", "v")) <= STATE_REL
    assert "narrow12_restored" not in got[2] and "narrow12" not in got[3]


def test_pod_mesh_one_step_matches(runs):
    """NARROW qwen3-8b on a (2, 1, 2) ("pod", "data", "model") mesh: the
    weights split over all three axes, the embedding over "model" only
    (its gradient all-reduced over the ("pod", "data") group), the rows
    over "pod" (4 a rank)."""
    ref, got = runs
    _check_run(got, "narrow3d", ref["narrow_none"], (LR, GRAD_REL),
               (LR, GRAD_REL))
    assert all(res["narrow3d"]["rows"] == 4 for res in got)


def test_recurrent_family_loss_matches(runs):
    ref, got = runs
    _check_run(got, "rg", ref["rg_none"], (LR, GRAD_REL), (LR, GRAD_REL))


def test_moe_refuses_the_sharded_step(runs):
    """Once a refusal, now parity: reduced qwen3-moe on (2, 2), the rows
    split four ways (2 a rank), one step == the single process (loss with
    its aux, gradient norm, m, v and params as the other families are
    held).  The load-balancing loss is the global batch's, all-reduced
    inside autograd: equal to JAX's over the whole batch, and measurably
    apart from the mean of the four shards' own."""
    ref, got = runs
    _check_run(got, "moe", ref["moe_none"], (LR, GRAD_REL), (LR, GRAD_REL))
    want, per_shard = ref["moe_aux"], ref["moe_aux_shard_mean"]
    assert abs(want - per_shard) > 1e-3 * abs(want)
    single_aux = got[0]["moe"]["single"][0][2]
    assert abs(single_aux - want) <= LOSS_RTOL * abs(want)
    for res in got:
        aux = res["moe"]["aux"][0]
        assert abs(aux - want) <= LOSS_RTOL * abs(want)
        assert abs(aux - per_shard) > 1e-3 * abs(want)
        assert res["moe"]["rows"] == 2
        assert res["moe"]["collectives"]["all_reduce"] > 0


def test_compression_refused_on_a_mesh():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.make_sharded_train_step(tbuild(cfg), adamw(), None,
                                       compress=True)


def test_elastic_restart_resharded(runs):
    """An 8 x 8 arange under P("data", "model"), saved from (2, 2) chunks,
    restored onto (1, 2): rank m holds columns [4m, 4m + 4)."""
    _, got = runs
    full = np.arange(64.0).reshape(8, 8)
    for rank in (0, 1):
        res = got[rank]["arange"]
        assert res["coord"] == {"data": 0, "model": rank}
        np.testing.assert_array_equal(res["chunk"],
                                      full[:, 4 * rank:4 * rank + 4])
        assert res["extra"] == {"step": 1}


@pytest.mark.parametrize("key,stages,n_micro", [
    ("pipe4", 4, PIPE["M"]), ("pipe2", 2, PIPE["M"]),
    ("pipe4_short", 4, 2)])
def test_pipeline_matches_sequential(runs, key, stages, n_micro):
    """GPipe over S stages == the JAX sequential apply within 1e-5 on
    every rank of the stage mesh (M < S included)."""
    ref, got = runs
    want = ref["pipe"][:n_micro]
    for res in got[:stages]:
        np.testing.assert_allclose(np.asarray(res[key], np.float32), want,
                                   rtol=1e-5, atol=1e-5)
    if key == "pipe4":
        for rank, res in enumerate(got):
            c = res["pipe4_collectives"]
            assert c["send"] == (n_micro if rank < 3 else 0)
            assert c["recv"] == (n_micro if rank > 0 else 0)
            assert c["broadcast"] == 1


@pytest.mark.parametrize("n_micro,n_stages", [
    (m, s) for m in (1, 2, 6, 16) for s in (1, 2, 4, 8)])
def test_bubble_fraction_matches_jax(n_micro, n_stages):
    assert pipeline_bubble_fraction(n_micro, n_stages) == j_bubble(
        n_micro, n_stages)


def test_one_stage_is_the_plain_loop():
    """S = 1 runs the layer loop and needs no process group."""
    rng = np.random.default_rng(3)
    ws = torch.from_numpy(rng.normal(size=(3, 8, 8)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    got = pipeline_apply(lambda w, x: torch.tanh(x @ w), ws, xs,
                         AxisMesh((1,), ("stage",)))
    want = xs
    for w in ws:
        want = torch.tanh(want @ w)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
