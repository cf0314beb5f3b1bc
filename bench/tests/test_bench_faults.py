"""The check fails a broken timed path: the rest of a run is driven on
the CPU (the look for a card skipped) with the served path broken under
it, and ``correct`` comes out false; and the control, the reference in
float8 put in the program's place, reads above the limit."""
import pytest
import torch

import bench_toy
from benchlib import check, program


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_toy.make_root(tmp_path_factory.mktemp("toyf"))


def _break(monkeypatch, fault):
    orig = program.build_server

    def broken(*a, **k):
        srv = orig(*a, **k)
        ex = srv.executor
        decode = ex.decode

        def token_altered(token, pos, active, cache, block_table=None):
            nxt, cache = decode(token, pos, active, cache, block_table)
            return (nxt + 1) % bench_toy.TOY_MODEL["vocab_size"], cache

        def state_unchanged(token, pos, active, cache, block_table=None):
            # the step's writes to the KV pool are thrown away
            saved = [{k: v.clone() for k, v in layer.items()
                      if isinstance(v, torch.Tensor)} for layer in cache.kv]
            nxt, cache = decode(token, pos, active, cache, block_table)
            for layer, old in zip(cache.kv, saved):
                for k, v in old.items():
                    layer[k].copy_(v)
            return nxt, cache

        ex.decode = {"token_altered": token_altered,
                     "state_unchanged": state_unchanged}[fault]
        return srv

    monkeypatch.setattr(program, "build_server", broken)


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_a_broken_decode_is_not_correct(root, monkeypatch, fault):
    _break(monkeypatch, fault)
    res, _ = bench_toy.run_toy(root, seed=21, seconds=1.0)
    assert res["correct"] is False
    gap = res["check"]["max_logit_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_a_sound_run_is_correct(root):
    res, _ = bench_toy.run_toy(root, seed=21, seconds=1.0)
    assert res["correct"] is True


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_reads_above_the_limit(seed):
    from reference.model import Reference
    conf = bench_toy.TOY_CONFIG
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(0, 256, (n,), generator=g) for n in (40, 64)]
    rows = [range(n - 8, n) for n in (40, 64)]
    ref = Reference(conf["model"], 8, seed, "cpu").logits_at(seqs, rows)
    low = Reference(conf["model"], 8, seed, "cpu", act="fp8").logits_at(
        seqs, rows)
    got = check.control_gaps(ref, low)
    assert got["max_logit_gap"] > conf["check"]["max_logit_gap"]
    assert check.control_gaps(ref, ref)["max_logit_gap"] == 0.0
