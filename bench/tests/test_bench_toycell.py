"""A cell added from new files alone (a configuration, a mix and a
per-layer metric, and manifest entries) runs end to end on the CPU."""
import math

import pytest

import bench_toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_toy.make_root(tmp_path_factory.mktemp("toy"))


def test_untraced_run_reports_the_end_to_end_metrics(root):
    res, lines = bench_toy.run_toy(root, seed=2**31 + 9, trace=False)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == round(bench_toy.TOY_MIX["rate_rps"] * 1.0)
    assert set(res["metrics"]) == {"output_tok_s", "ttft_p80_ms",
                                   "itl_worst1pct_ms", "setup_s"}
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert list(res)[-1] == "check"
    assert res["check"]["max_logit_gap"]["value"] <= 1e-3
    assert [ln.split()[0] for ln in lines] == ["setup", "power", "window",
                                               "check"]


def test_traced_run_reads_the_new_metric_by_its_file(root):
    res, _ = bench_toy.run_toy(root, seed=3, trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    # the toy metric is found by name; host counters read on the CPU too
    assert got["toy_prefill_calls"]["value"] >= 1
    assert 0 < got["prefill_rows_useful_pct"]["value"] <= 100
    assert got["decode_batch_mean"]["value"] >= 1
    assert got["decode_gap_p99_ms"]["value"] > 0
    # device metrics read nothing without a card, and are left out
    for name in ("decode_step_ms", "psi_decode_roofline", "device_idle_pct",
                 "prefill_mfu_pct"):
        assert name not in got


def test_the_same_seed_serves_the_same_tokens(root):
    import time
    from benchlib import cell, program
    seen = []
    orig = program.requests

    def keep(arrivals):
        reqs = orig(arrivals)
        seen.append(reqs)
        return reqs

    program.requests = keep
    try:
        for _ in range(2):
            cell.run(root, "toy.chat", 17, 1.0, False, "cpu",
                     time.perf_counter(), log=lambda s: None)
    finally:
        program.requests = orig
    a, b = ([(r.rid, list(r.tokens)) for r in reqs] for reqs in seen)
    assert a == b
