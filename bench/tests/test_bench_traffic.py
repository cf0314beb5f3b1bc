"""The traffic generator: one schedule a mix, the prompt tokens from the
run's seed."""
import json
from pathlib import Path

import numpy as np
import pytest

import bench_toy  # noqa: F401
from benchlib import traffic

ROOT = Path(__file__).resolve().parents[2]
MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((ROOT / "bench" / "traffic").glob("*.json"))}


def _key(arr):
    return [(a.arrival_s, a.max_new, a.prompt.tobytes()) for a in arr]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_arrivals(name):
    mix = MIXES[name]
    a = traffic.generate(mix, 2**31 + 77, 20.0, 1000)
    b = traffic.generate(mix, 2**31 + 77, 20.0, 1000)
    c = traffic.generate(mix, 12, 20.0, 1000)
    assert _key(a) == _key(b) and _key(a) != _key(c)
    assert len(a) == round(mix["rate_rps"] * 20.0)
    for r in a:
        assert 0.0 < r.arrival_s < 20.0
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert r.prompt.dtype == np.int32 and r.prompt.max() < 1000
    assert [r.arrival_s for r in a] == sorted(r.arrival_s for r in a)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_replays_one_schedule(name):
    mix = MIXES[name]
    a, b = (traffic.generate(mix, s, 30.0, 1000) for s in (4, 2**31 + 3))
    assert [(r.arrival_s, len(r.prompt), r.max_new) for r in a] == \
        [(r.arrival_s, len(r.prompt), r.max_new) for r in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    other = traffic.generate(dict(mix, schedule_seed=7), 4, 30.0, 1000)
    assert sorted(len(r.prompt) for r in other) == \
        sorted(len(r.prompt) for r in a)
    assert [r.arrival_s for r in other] != [r.arrival_s for r in a]


def test_lengths_are_the_quantiles():
    spec = {"dist": "lognormal", "median": 100, "sigma": 0.6, "min": 40,
            "max": 200}
    u = (np.arange(1001) + 0.5) / 1001
    x = traffic._lengths(spec, u)
    assert x[500] == 100 and x.min() == 40 and x.max() == 200
    uni = traffic._lengths({"dist": "uniform", "min": 16, "max": 128},
                           (np.arange(113) + 0.5) / 113)
    assert list(uni) == list(range(16, 129))


def test_the_gaps_fill_the_window():
    mix = dict(MIXES["rag"], rate_rps=2.0)
    arr = traffic.generate(mix, 1, 40.0, 100)
    gaps = np.diff([0.0] + [r.arrival_s for r in arr])
    assert len(arr) == 80 and arr[-1].arrival_s < 40.0
    # exponential quantiles: the median gap is ln 2 of the mean
    assert np.median(gaps) == pytest.approx(np.log(2) * 40.0 / 81, rel=0.1)
