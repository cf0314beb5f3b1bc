"""SLO classes, scheduling policy, and bursty traffic shapes (the port's
copy of the JAX package's ``launch/slo.py``).

* ``SLOClass`` — a named priority tier with per-class TTFT/ITL deadlines
  (interactive / standard / batch by default).
* ``SLOPolicy`` — orders admission by an aged priority key and picks
  preemption victims.  The sort key ``priority + arrival_s / aging_s`` is
  time-invariant (the relative order of two requests never changes as the
  clock advances), so ``Scheduler.waiting`` stays an insertion-sorted
  list; aging still keeps any class from starving.
* ``parse_slo_spec`` — the ``--slo`` flag.
* ``bursty_heavy_tail_trace`` — bursty arrivals, heavy-tail prompt lengths
  and decode budgets, mixed classes (the same draws from the same seed as
  the JAX package's).
* ``slo_report`` — per-class deadline attainment.

This module imports the scheduler's ``Request``; the scheduler takes any
policy with a ``sort_key`` and does not import this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.scheduler import Request


# ---------------------------------------------------------------------------
# Classes.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service tier: ``priority`` orders admission (lower = more
    urgent); the deadlines are *reporting* targets (``slo_report``), not
    hard gates — the scheduler optimizes for them, it does not reject."""
    name: str
    priority: int
    ttft_deadline_s: float      # arrival -> first token target
    itl_deadline_s: float       # per-token gap target

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLOClass needs a non-empty name")
        if not (self.ttft_deadline_s > 0 and self.itl_deadline_s > 0):
            raise ValueError(
                f"class {self.name!r}: deadlines must be > 0, got "
                f"ttft={self.ttft_deadline_s} itl={self.itl_deadline_s}")


# Finite deadlines even for batch (strict JSON has no Infinity) — batch
# just gets generous ones.
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", 0, ttft_deadline_s=0.5, itl_deadline_s=0.10),
    SLOClass("standard", 1, ttft_deadline_s=2.0, itl_deadline_s=0.25),
    SLOClass("batch", 2, ttft_deadline_s=30.0, itl_deadline_s=5.0),
)


# ---------------------------------------------------------------------------
# Policy.
# ---------------------------------------------------------------------------
class SLOPolicy:
    """Aged-priority admission ordering + preemption victim selection.

    ``aging_s`` is the seconds of waiting that count as one priority level:
    ``sort_key`` = ``(priority + arrival_s / aging_s, arrival_s, rid)``.
    Smaller sorts first; within a class this is FIFO, across classes an
    older low-priority request eventually outranks younger urgent ones —
    no class starves.  ``reserve_frac`` is the optimistic-admission knob
    admission reserves blocks for the bucketed prompt plus
    only this fraction of the remaining decode budget, instead of the
    worst case; the shortfall is paid on demand under the preemption
    pressure path.
    """

    def __init__(self, classes: Sequence[SLOClass] = DEFAULT_CLASSES, *,
                 aging_s: float = 30.0, reserve_frac: float = 0.25):
        if not classes:
            raise ValueError("SLOPolicy needs at least one class")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        if not aging_s > 0:
            raise ValueError(f"aging_s must be > 0, got {aging_s}")
        if not 0.0 <= reserve_frac <= 1.0:
            raise ValueError(
                f"reserve_frac must be in [0, 1], got {reserve_frac}")
        self.classes: Tuple[SLOClass, ...] = tuple(classes)
        self.aging_s = float(aging_s)
        self.reserve_frac = float(reserve_frac)
        self._by_name: Dict[str, SLOClass] = {c.name: c for c in self.classes}

    # ---- class resolution ----
    def class_of(self, req: Request) -> Optional[SLOClass]:
        """The request's class by name, else the first class matching its
        priority, else None (unclassed requests still schedule by their
        bare ``priority``; they just don't appear in ``slo_report``)."""
        cls = self._by_name.get(req.slo_class)
        if cls is not None:
            return cls
        return next((c for c in self.classes if c.priority == req.priority),
                    None)

    def mix(self, weights: Sequence[float]) -> List[Tuple[str, int, float]]:
        """``poisson_trace(priority_mix=...)`` entries for these classes."""
        if len(weights) != len(self.classes):
            raise ValueError(f"need {len(self.classes)} weights, "
                             f"got {len(weights)}")
        return [(c.name, c.priority, float(w))
                for c, w in zip(self.classes, weights)]

    # ---- scheduler hooks ----
    def sort_key(self, req: Request) -> Tuple[float, float, int]:
        """Admission order (smaller first). Time-invariant — see class doc."""
        return (req.priority + req.arrival_s / self.aging_s,
                req.arrival_s, req.rid)

    def victim_key(self, req: Request) -> Tuple[int, float, int]:
        """Preemption victim order (LARGER = preferred victim): lowest
        priority tier first, youngest within a tier (it has the least
        pool-resident work to throw away and re-prefill)."""
        return (req.priority, req.arrival_s, req.rid)


def parse_slo_spec(spec: str) -> Optional[SLOPolicy]:
    """Parse the ``--slo`` flag.

    Grammar:

      off                      -> None (FIFO + worst-case reservation)
      default                  -> SLOPolicy(DEFAULT_CLASSES)
      name:prio:ttft:itl,...   -> custom classes
      ...@aging=S@reserve=F    -> policy knobs, appendable to either form
    """
    spec = (spec or "").strip()
    if spec in ("", "off", "none"):
        return None
    head, *knob_parts = spec.split("@")
    knobs: Dict[str, float] = {}
    for part in knob_parts:
        k, eq, v = part.partition("=")
        if not eq or k not in ("aging", "reserve"):
            raise ValueError(
                f"bad --slo knob {part!r}: expected aging=S or reserve=F")
        try:
            knobs["aging_s" if k == "aging" else "reserve_frac"] = float(v)
        except ValueError:
            raise ValueError(f"bad --slo knob value {part!r}") from None
    if head == "default":
        return SLOPolicy(DEFAULT_CLASSES, **knobs)
    classes = []
    for item in head.split(","):
        fields = item.split(":")
        if len(fields) != 4:
            raise ValueError(
                f"bad --slo class {item!r}: expected name:priority:"
                f"ttft_deadline_s:itl_deadline_s")
        try:
            classes.append(SLOClass(fields[0], int(fields[1]),
                                    ttft_deadline_s=float(fields[2]),
                                    itl_deadline_s=float(fields[3])))
        except ValueError as e:
            raise ValueError(f"bad --slo class {item!r}: {e}") from None
    return SLOPolicy(classes, **knobs)


# ---------------------------------------------------------------------------
# Bursty heavy-tail traffic.
# ---------------------------------------------------------------------------
def bursty_heavy_tail_trace(
        n_requests: int, *, vocab_size: int, seed: int,
        burst_size: int = 4, burst_gap_s: float = 0.5,
        intra_gap_s: float = 0.005,
        short_prompt: int = 8, long_prompt: int = 56, long_frac: float = 0.3,
        short_new: int = 8, long_new: int = 32,
        mix: Optional[Sequence[Tuple[str, int, float]]] = None
) -> List[Request]:
    """The traffic shape SLO scheduling exists for: requests arrive in
    bursts of ``burst_size`` (back-to-back within a burst, ``burst_gap_s``
    between bursts), and a ``long_frac`` heavy tail of requests carries a
    long prompt AND a long decode budget — without chunked prefill one of
    those stalls every running decode; without preemption the worst-case
    reservation of a few of them empties the pool.  Deterministic given
    ``seed``; classes drawn from ``mix`` (same format as
    ``poisson_trace(priority_mix=...)``), long requests biased toward the
    LAST (lowest-priority) entry so the preemption victims are the cheap
    ones.
    """
    if n_requests <= 0:
        raise ValueError(f"n_requests must be > 0, got {n_requests}")
    if not 0.0 <= long_frac <= 1.0:
        raise ValueError(f"long_frac must be in [0, 1], got {long_frac}")
    rng = np.random.default_rng(seed)
    mix_p = None
    if mix:
        w = np.asarray([m[2] for m in mix], np.float64)
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"mix weights must be non-negative with a "
                             f"positive sum, got {list(w)}")
        mix_p = w / w.sum()
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        if i and i % burst_size == 0:
            t += burst_gap_s
        elif i:
            t += intra_gap_s
        is_long = bool(rng.random() < long_frac)
        plen = long_prompt if is_long else short_prompt
        budget = long_new if is_long else short_new
        name, prio = "", 0
        if mix_p is not None:
            if is_long:           # heavy tail skews to the last (batchiest)
                j = len(mix_p) - 1 if rng.random() < 0.7 else \
                    int(rng.choice(len(mix_p), p=mix_p))
            else:
                j = int(rng.choice(len(mix_p), p=mix_p))
            name, prio, _ = mix[j]
        prompt = rng.integers(0, vocab_size, size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=int(budget),
                            arrival_s=t, priority=int(prio),
                            slo_class=str(name)))
    return reqs


# ---------------------------------------------------------------------------
# Reporting.
# ---------------------------------------------------------------------------
def slo_report(requests: Sequence[Request],
               policy: SLOPolicy) -> Dict[str, Dict]:
    """Per-class deadline attainment over a finished request set: fraction
    of requests whose TTFT met the class deadline, fraction of TOKEN GAPS
    that met the ITL deadline (an ITL SLO is per token, not per request),
    plus the tail percentiles behind them.  Requests no class claims are
    skipped.  All values finite (JSON-strict)."""
    by_class: Dict[str, List[Request]] = {c.name: [] for c in policy.classes}
    for r in requests:
        cls = policy.class_of(r)
        if cls is not None:
            by_class[cls.name].append(r)
    report: Dict[str, Dict] = {}
    for cls in policy.classes:
        rs = by_class[cls.name]
        ttfts = np.asarray([r.ttft_s for r in rs], np.float64)
        ttfts = ttfts[~np.isnan(ttfts)]
        gaps = (np.concatenate([r.itl_gaps for r in rs])
                if rs else np.empty((0,), np.float64))
        report[cls.name] = {
            "priority": cls.priority,
            "n_requests": len(rs),
            "ttft_deadline_s": cls.ttft_deadline_s,
            "itl_deadline_s": cls.itl_deadline_s,
            "p50_ttft_s": float(np.percentile(ttfts, 50)) if ttfts.size
            else 0.0,
            "p99_ttft_s": float(np.percentile(ttfts, 99)) if ttfts.size
            else 0.0,
            "ttft_attainment": float(np.mean(ttfts <= cls.ttft_deadline_s))
            if ttfts.size else 1.0,
            "p99_itl_s": float(np.percentile(gaps, 99)) if gaps.size
            else 0.0,
            "itl_attainment": float(np.mean(gaps <= cls.itl_deadline_s))
            if gaps.size else 1.0,
            "preemptions": int(sum(r.preemptions for r in rs)),
        }
    return report
