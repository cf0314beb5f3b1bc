"""The port's SLO scheduling and chunked prefill against the JAX package's.

Units: ``parse_slo_spec``, ``sort_key``, ``victim_key``, ``class_of``,
``mix`` and ``slo_report`` (``tests/test_slo.py::TestPolicy``); the
reservation growth and ``capacity_version`` audit
(``TestReservationGrowth``); preemption accounting — covered-only publish,
restore hits, and a seeded admit / emit / preempt / re-admit / retire
churn driven identically through both packages' ``Scheduler``
(``TestPreemptionAccounting``); the draws of ``poisson_trace`` with a
priority mix and of ``bursty_heavy_tail_trace``.  Then the port's
``Server`` on reduced qwen3-8b psi8 f32 (JAX ``init`` + ``quantize``,
carried across by interop) against the JAX ``Server``: ``--prefill-chunk``
alone (identical tokens, equal chunk and prefilled-token counts), and
``--slo`` on a tight pool — alone, with the prefix cache, and with chunk 16
at horizon 4 — emitting the JAX FIFO tokens with preemptions observed.
The preemption count depends on the clock, so it is compared only as
``> 0``.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.psi import QuantizedTensor
from repro.launch import prefix_cache as jpc
from repro.launch import scheduler as jsched
from repro.launch import slo as jslo
from repro.launch.serve import Server as JServer
from repro.models import build_model
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import prefix_cache as tpc
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import slo as tslo
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)


def np_tree(t):
    if isinstance(t, QuantizedTensor):
        return {"data": np.asarray(t.data), "scale": np.asarray(t.scale),
                "bits": t.fmt.bits, "packed": t.packed}
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _reqs(mod, seed, n=12):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                        max_new=4, arrival_s=float(rng.integers(0, 40)),
                        priority=int(rng.integers(0, 4)),
                        slo_class=str(rng.choice(["", "batch", "nope"])))
            for i in range(n)]


# ---------------------------------------------------------------------------
# Policy.
# ---------------------------------------------------------------------------
SPECS = ["off", "", "none", "default", "default@aging=7",
         "default@reserve=0.1",
         "rt:0:0.2:0.05,bulk:3:60:10@aging=7@reserve=0.5",
         "default@bogus=1", "default@aging=x", "name:only:three",
         "a:0:1:1,a:1:1:1", "a:0:0:1", "default@aging=0",
         "default@reserve=1.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_spec_matches_jax(spec):
    got_err = _raises(lambda: tslo.parse_slo_spec(spec))
    want_err = _raises(lambda: jslo.parse_slo_spec(spec))
    assert got_err == want_err
    if want_err is not None:
        return
    want, got = jslo.parse_slo_spec(spec), tslo.parse_slo_spec(spec)
    if want is None:
        assert got is None
        return
    assert [dataclasses.astuple(c) for c in got.classes] == \
        [dataclasses.astuple(c) for c in want.classes]
    assert (got.aging_s, got.reserve_frac) == (want.aging_s,
                                               want.reserve_frac)


@pytest.mark.parametrize("aging", [0.5, 10.0, 30.0])
def test_sort_and_victim_keys_match_jax(aging):
    jpol, tpol = jslo.SLOPolicy(aging_s=aging), tslo.SLOPolicy(aging_s=aging)
    jr, tr = _reqs(jsched, int(aging * 2)), _reqs(tsched, int(aging * 2))
    for a, b in zip(jr, tr):
        assert tpol.sort_key(b) == jpol.sort_key(a)
        assert tpol.victim_key(b) == jpol.victim_key(a)
        jc, tc = jpol.class_of(a), tpol.class_of(b)
        assert (tc and tc.name) == (jc and jc.name)
    assert [r.rid for r in sorted(tr, key=tpol.sort_key)] == \
        [r.rid for r in sorted(jr, key=jpol.sort_key)]
    assert max(tr, key=tpol.victim_key).rid == \
        max(jr, key=jpol.victim_key).rid
    assert tpol.mix([1.0, 2.0, 3.0]) == jpol.mix([1.0, 2.0, 3.0])
    assert _raises(lambda: tpol.mix([1.0])) == _raises(
        lambda: jpol.mix([1.0]))


def test_slo_report_matches_jax():
    pol_j, pol_t = jslo.SLOPolicy(), tslo.SLOPolicy()
    reps = []
    for mod, pol in ((jsched, pol_j), (tsched, pol_t)):
        reqs = _reqs(mod, 4, n=9)
        r2 = np.random.default_rng(9)
        for r in reqs:
            t = r.arrival_s
            for i in range(int(r2.integers(0, 5))):
                t += float(r2.uniform(0.01, 0.6))
                r.emit(i, t)
            r.preemptions = int(r2.integers(0, 3))
        reps.append((jslo if mod is jsched else tslo).slo_report(reqs, pol))
        reps.append(mod.summarize(reqs, wall_s=1.5))
    assert reps[2] == reps[0]
    assert {k: v for k, v in reps[3].items() if k in reps[1]} == {
        k: v for k, v in reps[1].items() if k in reps[3]}
    assert reps[3]["preemptions"] == reps[1]["preemptions"] > 0


# ---------------------------------------------------------------------------
# Reservation growth and capacity_version.
# ---------------------------------------------------------------------------
GROWTH = [("reserve", (1, 1)), ("alloc", (1,)), ("reserved_of", (1,)),
          ("grow_reserve", (1, 2)), ("reserved_of", (1,)),
          ("grow_reserve", (1, 0)), ("grow_reserve", (2, 1)),
          ("grow_reserve", (1, 4)), ("ref_block", (0,)), ("release", (1,)),
          ("unref_block", (0,)), ("reserve", (3, 3)), ("release", (3,)),
          ("reserve", (4, 2)), ("alloc", (4,)), ("release", (4,))]


def test_grow_reserve_and_capacity_version_match_jax():
    """The op sequence of TestReservationGrowth (growth, its three errors,
    a pin's last reference freeing a block, a pure refund): the same
    results, errors, capacity_version and reservations after every op."""
    ja, ta = jsched.BlockAllocator(4), tsched.BlockAllocator(4)
    versions = []
    for name, args in GROWTH:
        want = _raises(lambda: getattr(ja, name)(*args)) \
            if name != "reserved_of" else ja.reserved_of(*args)
        got = _raises(lambda: getattr(ta, name)(*args)) \
            if name != "reserved_of" else ta.reserved_of(*args)
        assert got == want, (name, args)
        assert (ta.capacity_version, dict(ta._reserved), ta.free_count) == \
            (ja.capacity_version, dict(ja._reserved), ja.free_count)
        versions.append(ta.capacity_version)
    assert versions == sorted(versions) and versions[-1] >= 4


# ---------------------------------------------------------------------------
# Preemption accounting in the Scheduler.
# ---------------------------------------------------------------------------
def _sched_pair(reqs_fn, n_blocks, max_batch, needed, policy=True,
                prefix_bs=4):
    out = []
    for mod, pmod, smod in ((jsched, jpc, jslo), (tsched, tpc, tslo)):
        blocks = mod.BlockAllocator(n_blocks)
        prefix = (pmod.PrefixCache(prefix_bs, align_tokens=prefix_bs)
                  if prefix_bs else None)
        pol = smod.SLOPolicy(aging_s=1000.0) if policy else None
        out.append((mod.Scheduler(reqs_fn(mod), max_batch, blocks=blocks,
                                  blocks_needed=needed, prefix=prefix,
                                  policy=pol), blocks, prefix))
    return out


def _sched_state(sched, blocks, prefix):
    return ([(s, r.rid) for s, r in sorted(sched.running.items())],
            [r.rid for r in sched.waiting], [r.rid for r in sched.finished],
            sched._hol_blocked, blocks.free_count, list(blocks.refcount),
            blocks.capacity_version,
            None if prefix is None else (list(prefix._entries.values()),
                                         prefix.stats()))


def test_hol_blocked_admission_retries_after_preempt_matches_jax():
    def reqs(mod):
        return [mod.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                            max_new=4, arrival_s=0.0, priority=2),
                mod.Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                            max_new=4, arrival_s=1.0, priority=0)]
    pair = _sched_pair(reqs, 4, 2, lambda r: 3, prefix_bs=0)
    (j, *jrest), (t, *trest) = pair
    for now in (0.0, 1.0, 1.1):
        j.poll(now), t.poll(now)
        assert [(s, r.rid) for s, r in t.admit(now)] == \
            [(s, r.rid) for s, r in j.admit(now)]
        assert _sched_state(t, *trest) == _sched_state(j, *jrest)
    assert t._hol_blocked is not None
    j.preempt(j.running[0].slot, 2.0), t.preempt(t.running[0].slot, 2.0)
    assert [r.rid for _, r in t.admit(2.0)] == \
        [r.rid for _, r in j.admit(2.0)] == [1]
    assert _sched_state(t, *trest) == _sched_state(j, *jrest)


@pytest.mark.parametrize("covered,emitted", [(0, 0), (8, 1), (4, 1),
                                             (None, 1)])
def test_preempt_publishes_only_covered_tokens_matches_jax(covered, emitted):
    """covered= caps the publish at the KV actually written (0: nothing
    pinned, every block free), and a later re-admission attaches what
    was published as a restore hit."""
    def reqs(mod):
        return [mod.Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                            max_new=8)]
    states = []
    for sched, blocks, prefix in _sched_pair(reqs, 8, 1, lambda r: 4,
                                             policy=False):
        sched.poll(0.0)
        sched.admit(0.0)
        req = sched.running[0]
        for _ in range(2):
            blocks.alloc(req.rid)
        for i in range(emitted):
            req.emit(3 + i, 0.5)
        sched.preempt(req.slot, 1.0, covered=covered)
        after = _sched_state(sched, blocks, prefix)
        admits = sched.admit(2.0)
        states.append((after, [(s, r.rid) for s, r in admits],
                       req.prefix_blocks, req.prefix_hit_tokens,
                       req.preemptions, _sched_state(sched, blocks, prefix)))
    assert states[1] == states[0]
    if covered == 0:
        assert states[1][0][4] == 8 and states[1][2] == []


@pytest.mark.parametrize("seed", range(4))
def test_preemption_churn_matches_jax(seed):
    """The admit -> emit -> preempt -> re-admit -> retire churn of
    TestPreemptionAccounting.test_accounting_churn_invariants, one seeded
    sequence of decisions applied to both schedulers: the same admissions
    at every step, the same queue, prefix-cache and allocator state, the
    same per-request accounting, and a leak-free end."""
    rng0 = random.Random(seed)
    bs = 4
    n_blocks = rng0.randint(10, 24)
    max_batch = rng0.randint(1, 3)
    aging = rng0.choice([0.5, 5.0, 50.0])
    specs = [(rng0.randint(1, 12), rng0.randint(1, 6),
              round(rng0.random() * 2, 3), rng0.randint(0, 2))
             for _ in range(rng0.randint(2, 10))]

    def reqs(mod):
        return [mod.Request(rid=i, prompt=np.arange(p, dtype=np.int32) + i,
                            max_new=m, arrival_s=a, priority=pr)
                for i, (p, m, a, pr) in enumerate(specs)]

    needed = lambda r: min(n_blocks, len(r.full_seq) // bs + 2)
    runs = []
    for mod, pmod, smod in ((jsched, jpc, jslo), (tsched, tpc, tslo)):
        rng = random.Random(seed * 7919)
        blocks = mod.BlockAllocator(n_blocks)
        prefix = pmod.PrefixCache(bs, align_tokens=bs)
        sched = mod.Scheduler(reqs(mod), max_batch, blocks=blocks,
                              blocks_needed=needed, prefix=prefix,
                              policy=smod.SLOPolicy(aging_s=aging))
        log, now = [], 0.0
        while not sched.done:
            assert len(log) < 5000, "churn failed to drain"
            now += 0.05 + rng.random() * 0.2
            sched.poll(now)
            for slot, req in sched.admit(now):
                want = min(needed(req), len(req.full_seq) // bs + 1)
                for _ in range(max(0, want - len(req.prefix_blocks))):
                    blocks.alloc(req.rid)
                req.emit(rng.randrange(100), now)
                log.append(("admit", slot, req.rid, list(req.prefix_blocks)))
            for slot in list(sched.running):
                req = sched.running[slot]
                if len(req.tokens) >= req.max_new:
                    sched.retire(slot, now)
                    log.append(("retire", slot, req.rid))
                elif rng.random() < 0.25:
                    covered = ((len(req.full_seq) // bs) * bs
                               if rng.random() < 0.5 else 0)
                    sched.preempt(slot, now, covered=covered)
                    log.append(("preempt", slot, req.rid, covered))
                else:
                    req.emit(rng.randrange(100), now)
            log.append(_sched_state(sched, blocks, prefix))
        acct = [(r.rid, r.tokens, r.preemptions, r.prefix_hit_tokens,
                 r.queue_s, r.ttft_s, r.latency_s) for r in sched.finished]
        prefix.drain(blocks)
        runs.append((log, acct, blocks.free_count))
    assert runs[1] == runs[0]
    assert runs[1][2] == n_blocks


# ---------------------------------------------------------------------------
# Traces.
# ---------------------------------------------------------------------------
def _same_trace(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival_s, x.priority, x.slo_class) == \
            (y.rid, y.max_new, y.arrival_s, y.priority, y.slo_class)
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("shared,mix", [(0, None), (24, None),
                                        (0, (1.0, 1.0, 2.0)),
                                        (16, (3.0, 0.0, 1.0))])
def test_poisson_trace_draws_match_jax(shared, mix):
    kw = dict(rate_rps=10, prompt_len=8, max_new=6, vocab_size=100, seed=3,
              prompt_jitter=2, shared_prefix_len=shared)
    jmix = jslo.SLOPolicy().mix(mix) if mix else None
    tmix = tslo.SLOPolicy().mix(mix) if mix else None
    _same_trace(jsched.poisson_trace(24, priority_mix=jmix, **kw),
                tsched.poisson_trace(24, priority_mix=tmix, **kw))
    for bad in (dict(priority_mix=[]), dict(priority_mix=[("a", 0, -1.0)]),
                dict(shared_prefix_len=-1)):
        kb = dict(kw, **bad)
        assert _raises(lambda: tsched.poisson_trace(4, **kb)) == \
            _raises(lambda: jsched.poisson_trace(4, **kb)) is not None


@pytest.mark.parametrize("kw", [
    dict(burst_size=4),
    dict(burst_size=8, burst_gap_s=0.3, long_frac=0.6, mix=(3.0, 2.0, 1.0)),
    dict(burst_size=4, long_prompt=448, short_prompt=32, long_new=24,
         short_new=8)], ids=["plain", "mixed", "long"])
def test_bursty_trace_draws_match_jax(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "mix" in kw:
        jkw["mix"] = jslo.SLOPolicy().mix(kw["mix"])
        tkw["mix"] = tslo.SLOPolicy().mix(kw["mix"])
    _same_trace(jslo.bursty_heavy_tail_trace(16, vocab_size=256, seed=7,
                                             **jkw),
                tslo.bursty_heavy_tail_trace(16, vocab_size=256, seed=7,
                                             **tkw))
    for bad in (dict(long_frac=1.5), dict(n_requests=0)):
        args = dict(dict(n_requests=4, vocab_size=10, seed=0), **bad)
        assert _raises(lambda: tslo.bursty_heavy_tail_trace(**args)) == \
            _raises(lambda: jslo.bursty_heavy_tail_trace(**args)) \
            is not None


# ---------------------------------------------------------------------------
# The Server: chunked prefill and SLO scheduling against the JAX Server.
# ---------------------------------------------------------------------------
POLICY = "default@aging=5@reserve=0.1"


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen3-8b"))
    model = build_model(cfg)
    params = model.quantize(model.init(jax.random.PRNGKey(0)), 8)
    cfg = dataclasses.replace(cfg, quant_mode="psi8")
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-8b"),
                                   quant_mode="psi8")
    tparams = params_from_numpy(np_tree(params), device="cpu")
    return cfg, params, tcfg, tparams


def _toks(done):
    return {r.rid: list(r.tokens) for r in done}


def _bursty(mod, smod, n=16):
    pol = smod.parse_slo_spec(POLICY)
    return smod.bursty_heavy_tail_trace(
        n, vocab_size=256, seed=7, burst_size=8, burst_gap_s=0.3,
        long_frac=0.6, mix=pol.mix([3.0, 2.0, 1.0]))


@pytest.fixture(scope="module")
def jax_fifo(setup):
    """The JAX FIFO baseline's tokens on the bursty trace, tight pool."""
    cfg, params, _, _ = setup
    fifo = JServer(cfg, params, max_batch=4, max_seq=112, n_blocks=8)
    done, stats = fifo.serve(_bursty(jsched, jslo), continuous=True)
    assert stats["blocks_free_end"] == 8
    return _toks(done)


def test_chunked_prefill_matches_jax(setup):
    """--prefill-chunk alone: identical tokens, the same chunk count,
    prefilled-token count and block accounting; the pieces that are not
    the last skip the lm-head."""
    cfg, params, tcfg, tparams = setup
    trace = lambda mod: mod.poisson_trace(6, rate_rps=500, prompt_len=56,
                                          max_new=10, min_new=10,
                                          vocab_size=256, seed=2)
    jdone, js = JServer(cfg, params, max_batch=2, max_seq=96,
                        prefill_chunk=16).serve(trace(jsched))
    srv = tserve.Server(tcfg, tparams, max_batch=2, max_seq=96,
                        prefill_chunk=5, device="cpu")
    assert srv.prefill_chunk == 16          # lcm(block 16, bucket 16)
    tdone, ts = srv.serve(trace(tsched))
    assert _toks(tdone) == _toks(jdone)
    keys = ("tokens", "prefill_chunks", "prefilled_tokens",
            "blocks_free_end", "peak_blocks_in_use")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["prefill_chunks"] == 6 * 4    # 56 tokens: 16 + 16 + 16 + 8
    assert ts["prefill_forwards_headless"] == 6 * 3
    assert ts["prefill_forwards"] == 6 * 4


@pytest.mark.parametrize("chunk,horizon,prefix", [
    (0, 1, False), (0, 1, True), (16, 4, False)],
    ids=["slo", "slo-prefix-cache", "slo-chunk16-horizon4"])
def test_slo_preemptive_serving_matches_jax_fifo(setup, jax_fifo, chunk,
                                                  horizon, prefix):
    """--slo on the tight pool (n_blocks 8) of test_slo.py and
    test_multistep.py::test_preemption_between_rounds: preemptions and
    restores happen, the tokens are the JAX FIFO baseline's, the decode
    path keeps its one shape and no block leaks."""
    _, _, tcfg, tparams = setup
    cfg = dataclasses.replace(tcfg, prefix_cache=prefix)
    srv = tserve.Server(cfg, tparams, max_batch=4, max_seq=112, n_blocks=8,
                        prefill_chunk=chunk, slo=tslo.parse_slo_spec(POLICY),
                        decode_horizon=horizon, device="cpu")
    done, s = srv.serve(_bursty(tsched, tslo), continuous=True)
    assert _toks(done) == jax_fifo
    assert s["preemptions"] > 0
    assert s["prefix_cache"]["restores"] > 0
    assert s["blocks_free_end"] == s["n_blocks"] == 8
    rep = s["slo"]["classes"]
    assert sum(c["n_requests"] for c in rep.values()) == 16
    assert sum(c["preemptions"] for c in rep.values()) == s["preemptions"]
    if chunk:
        assert s["prefill_chunks"] > 0
        assert s["decode_rounds"] * horizon == s["decode_steps"]


def test_context_serving_flags_are_validated(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="RoPE"):
        tserve.Server(dataclasses.replace(tcfg, rope="sinusoidal"), tparams,
                      max_batch=2, max_seq=64, prefill_chunk=16,
                      device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        tserve.Server(tcfg, tparams, max_batch=2, max_seq=64,
                      prefill_chunk=-1, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tserve.Server(dataclasses.replace(tcfg, cache_layout="dense"),
                      tparams, max_batch=2, max_seq=64,
                      slo=tslo.parse_slo_spec("default"), device="cpu")
