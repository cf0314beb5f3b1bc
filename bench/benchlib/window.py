"""The window's arithmetic: what each end-to-end metric counts.

Every request arrives inside ``[0, seconds)`` of the serve's clock.

* Output tokens a second: the tokens emitted before ``seconds``, over
  ``seconds``.
* Time to first token: from each request's due time to its first token,
  over every request of the window, wherever its first token falls (a
  request still queued at the window's end is timed when it gets one).  A
  request that never got one counts as missing: +inf.
* Gap between tokens: every gap between two tokens of one request whose
  later token was emitted before ``seconds``.
* Percentiles are nearest-rank: the smallest value with at least p % of
  the sample at or below it, so a tail is always a measured value (or
  +inf where a missing request reaches it).
* ``itl_worst1pct_ms`` is the mean of the slowest 1 % of the gaps.  Where
  a few long prefills stall every running request at once, the gaps'
  99th percentile jumps between the sizes of two stalls from run to run;
  the mean over the slowest 1 % moves with each stall's share instead.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence


def pctile(values: Sequence[float], p: float) -> float:
    if not values:
        return math.inf
    s = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[k - 1])


def worst_mean(values: Sequence[float], pct: float) -> float:
    """The mean of the largest ``pct`` % of the values (at least one)."""
    if not values:
        return math.inf
    k = max(1, math.ceil(pct / 100.0 * len(values)))
    return float(sum(sorted(values)[-k:]) / k)


def measure(reqs: Sequence, seconds: float) -> Dict[str, float]:
    """``reqs``: objects with ``arrival_s``, ``max_new``, ``tokens``,
    ``token_s`` and ``first_token_s`` (None before the first token)."""
    ttft, gaps, in_window, failed = [], [], 0, 0
    for r in reqs:
        if r.first_token_s is None:
            ttft.append(math.inf)
        else:
            ttft.append(r.first_token_s - r.arrival_s)
        ts = list(r.token_s)
        in_window += sum(1 for t in ts if t < seconds)
        gaps += [b - a for a, b in zip(ts, ts[1:]) if b < seconds]
        if len(r.tokens) < r.max_new:
            failed += 1
    return {
        "requests": len(reqs),
        "failed": failed,
        "tokens_in_window": in_window,
        "output_tok_s": in_window / seconds,
        "ttft_p50_ms": 1e3 * pctile(ttft, 50),
        "ttft_p80_ms": 1e3 * pctile(ttft, 80),
        "ttft_p90_ms": 1e3 * pctile(ttft, 90),
        "itl_p50_ms": 1e3 * pctile(gaps, 50),
        "itl_p99_ms": 1e3 * pctile(gaps, 99),
        "itl_worst1pct_ms": 1e3 * worst_mean(gaps, 1.0),
        "gaps": len(gaps),
    }
