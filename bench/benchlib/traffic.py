"""The one traffic generator: an open-loop arrival schedule over the
window, from a mix's data file and the run's seed.

A mix file (``bench/traffic/<name>.json``) holds::

    {"slots": 16,                      # the server's decode slots
     "rate_rps": 1.28,                 # offered load, requests a second
     "schedule_seed": 20261018,        # fixes the schedule
     "prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.6,
                "min": 256, "max": 3072},
     "output": {"dist": "uniform", "min": 16, "max": 128}}

A window of ``seconds`` holds ``round(rate_rps * seconds)`` requests.
Their prompt and output lengths are the distributions' quantiles at
(i + 1/2) / n, and their gaps the exponential's quantiles (a Poisson
process's) scaled to fill the window; the schedule seed shuffles each
list.  So every run replays one schedule, like a recorded trace, and runs
differ by the system alone: with the order drawn from the run's seed
instead, the tails of runs on different seeds spread threefold.  The
run's seed draws the prompt tokens, uniform over the vocabulary.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Arrival:
    rid: int
    arrival_s: float
    prompt: np.ndarray          # (L,) int32
    max_new: int


def _lengths(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Lengths at the quantiles ``u`` of a length distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    if spec["dist"] == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(float(p)) for p in u])
        x = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def generate(mix: Dict, seed: int, seconds: float, vocab: int
             ) -> List[Arrival]:
    """The arrivals of one run, all inside ``[0, seconds)``."""
    rate = float(mix["rate_rps"])
    if not rate > 0 or not seconds > 0:
        raise ValueError(f"rate {rate} and seconds {seconds} must be > 0")
    order = np.random.default_rng(int(mix["schedule_seed"]))
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    plens = order.permutation(_lengths(mix["prompt"], u))
    outs = order.permutation(_lengths(mix["output"], u))
    # n + 1 gaps fill the window, so the last arrival falls inside it
    g = -np.log1p(-(np.arange(n + 1) + 0.5) / (n + 1))
    times = np.cumsum(order.permutation(g) * (seconds / g.sum()))[:n]
    rng = np.random.default_rng(int(seed))
    return [Arrival(i, float(times[i]),
                    rng.integers(0, vocab, size=int(plens[i]))
                    .astype(np.int32), int(outs[i]))
            for i in range(n)]
