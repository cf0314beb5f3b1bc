"""Straggler detection: per-host step-time heartbeats against the fleet
median.

In a synchronous data-parallel step the slowest host sets the pace.  The
monitor keeps an EWMA of each host's step time, flags hosts slower than
``threshold`` x the fleet median for ``patience`` consecutive windows, and
recommends eviction; ``input_weights`` gives soft data-shard weights
(inverse smoothed step time) for rebalancing first.  numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2            # EWMA smoothing
    threshold: float = 1.25       # x median
    patience: int = 3

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.strikes = np.zeros(self.n_hosts, np.int32)
        self.initialized = False

    def observe(self, step_times: List[float]) -> Dict:
        t = np.asarray(step_times, np.float64)
        if not self.initialized:
            self.ewma[:] = t
            self.initialized = True
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        med = np.median(self.ewma)
        slow = self.ewma > self.threshold * med
        self.strikes = np.where(slow, self.strikes + 1, 0)
        flagged = np.nonzero(self.strikes >= self.patience)[0].tolist()
        return {
            "median_s": float(med),
            "slowest_host": int(np.argmax(self.ewma)),
            "slowdown": float(self.ewma.max() / max(med, 1e-12)),
            "flagged_hosts": flagged,
            "evict_recommended": bool(flagged),
        }

    def input_weights(self) -> np.ndarray:
        """Relative data-shard weights: inverse smoothed step time,
        normalized."""
        if not self.initialized:
            return np.ones(self.n_hosts) / self.n_hosts
        w = 1.0 / np.maximum(self.ewma, 1e-9)
        return w / w.sum()
