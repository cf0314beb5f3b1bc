"""The window's arithmetic: rates, tails and missing requests."""
import math
from types import SimpleNamespace

import pytest

import bench_toy  # noqa: F401
from benchlib import window


def req(arrival, toks, max_new=None):
    return SimpleNamespace(arrival_s=arrival, token_s=list(toks),
                           tokens=[0] * len(toks),
                           max_new=len(toks) if max_new is None else max_new,
                           first_token_s=toks[0] if toks else None)


def test_nearest_rank_percentile():
    vals = list(range(1, 101))
    assert window.pctile(vals, 90) == 90
    assert window.pctile(vals, 99) == 99
    assert window.pctile([5.0], 50) == 5.0
    assert window.pctile([], 90) == math.inf
    assert window.pctile([1, 2, 3, 4], 50) == 2


def test_tokens_and_gaps_inside_the_window_only():
    reqs = [req(0.0, [0.5, 1.0, 1.5]), req(1.0, [1.8, 2.4, 3.0])]
    w = window.measure(reqs, 2.0)
    assert w["tokens_in_window"] == 4
    assert w["output_tok_s"] == 2.0
    # gaps whose later token falls before 2.0 s: 0.5, 0.5 (the second
    # request's 1.8 -> 2.4 ends after the window)
    assert w["gaps"] == 2 and w["itl_p99_ms"] == pytest.approx(500.0)
    # time to first token counts every request of the window
    assert w["ttft_p90_ms"] == pytest.approx(800.0)
    assert w["failed"] == 0


def test_the_mean_of_the_slowest_gaps():
    gaps = [0.02] * 190 + [0.5, 0.6]                 # 192 gaps: slowest 2
    assert window.worst_mean(gaps, 1.0) == pytest.approx(0.55)
    assert window.worst_mean([0.1, 0.3], 1.0) == pytest.approx(0.3)
    assert window.worst_mean([], 1.0) == math.inf
    reqs = [req(0.0, [0.01 * i for i in range(1, 101)] + [2.0])]
    w = window.measure(reqs, 3.0)
    assert w["itl_worst1pct_ms"] == pytest.approx(1000.0)


def test_a_failed_request_counts_as_missing():
    reqs = [req(0.1 * i, [0.1 * i + 0.05]) for i in range(9)]
    reqs.append(req(0.95, [], max_new=4))          # never served
    w = window.measure(reqs, 1.0)
    assert w["failed"] == 1
    assert w["ttft_p90_ms"] == pytest.approx(50.0)
    assert w["ttft_p50_ms"] == pytest.approx(50.0)
    reqs.append(req(0.97, [0.99], max_new=3))       # cut short: failed
    w = window.measure(reqs, 1.0)
    assert w["failed"] == 2
    assert math.isinf(window.pctile([math.inf] * 2 + [0.05] * 9, 90))
