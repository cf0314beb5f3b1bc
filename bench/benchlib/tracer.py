"""Spans of the traced run (``--trace 1``), taken from the benchmark's own
wrappers around the executor instance's calls; nothing inside the program
is changed.

* Each ``Executor.prefill`` and ``Executor.decode`` call of the window is
  logged on the host (its rows and true prompt tokens, or its active slots
  and their contexts) and timed on the device by a pair of CUDA events.
* Over the window's last tenth the profiler collects device activity
  alone.
  Each call in the slice launches a marker kernel (``torch.cuda._sleep``,
  the kernel ``spin_kernel``) before and after itself, a short one and a
  long one, so every kernel of the trace is attributed to the call that
  launched it, by its place between the markers in the stream's order,
  and not by its name.  The
  idle gaps of the slice are named by the host span that was open: inside
  a call, or in the serve loop between two calls.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

MARKER = "spin_kernel"
PSI = "psi_gemm"
# an opening marker spins for no cycles, a closing one for 20000 (~10 us
# at 2 GHz); they are told apart by their length
OPEN_CYCLES, CLOSE_CYCLES = 0, 20000
SPLIT_NS = 5000.0


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return 1e3 * float(getattr(ev, f"{what}_us")())


class Tracer:
    """``slice_frac``: the part of the window, as fractions of it, over
    which the profiler collects."""

    def __init__(self, executor, seconds: float,
                 slice_frac: Tuple[float, float] = (0.9, 1.0)):
        self.ex = executor
        self.seconds = float(seconds)
        self.prof_from = slice_frac[0] * self.seconds
        self.prof_to = slice_frac[1] * self.seconds
        self.cuda = executor.device.type == "cuda"
        self.t0: Optional[float] = None
        self.calls: List[Dict] = []
        self.prof = None
        self.done = False
        self.prof_host: List[float] = []
        self.events = None

    # ------------------------------------------------------------ wrapping
    def install(self) -> None:
        """Wrap the executor's calls.  On a card the profiler starts and
        stops once here, in set-up: its first start initializes the
        tracing library, which takes seconds; later starts take
        milliseconds."""
        ex = self.ex
        if self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.cuda._sleep(0)
                torch.cuda.synchronize()
        init_cache, prefill, decode = ex.init_cache, ex.prefill, ex.decode

        def init_cache_w(*a, **k):
            out = init_cache(*a, **k)
            # the serve's clock starts right after its init_cache
            self.t0 = time.perf_counter()
            return out

        def prefill_w(tokens, true_lens, *a, **k):
            tl = np.asarray(true_lens).reshape(-1)
            rec = {"kind": "prefill", "rows": int(np.size(tokens)),
                   "prompt_lens": [int(x) for x in tl]}
            return self._timed(rec, prefill, (tokens, true_lens) + a, k)

        def decode_w(token, pos, active, *a, **k):
            act = np.asarray(active).astype(bool).reshape(-1)
            p = np.asarray(pos).reshape(-1)
            rec = {"kind": "decode", "active": int(act.sum()),
                   "contexts": [int(x) + 1 for x in p[act]]}
            return self._timed(rec, decode, (token, pos, active) + a, k)

        ex.init_cache, ex.prefill, ex.decode = init_cache_w, prefill_w, \
            decode_w

    def _timed(self, rec, fn, a, k):
        import torch
        now = time.perf_counter()
        t = now - self.t0 if self.t0 is not None else -1.0
        self._profile_at(t)
        marked = self.prof is not None
        ev = None
        if marked:
            torch.cuda._sleep(OPEN_CYCLES)
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = fn(*a, **k)
        if self.cuda:
            ev[1].record()
        if marked:
            torch.cuda._sleep(CLOSE_CYCLES)
        rec.update(t=t, ev=ev, marked=marked)
        self.calls.append(rec)
        return out

    def _profile_at(self, t: float) -> None:
        if not self.cuda or self.done:
            return
        if self.prof is None and t >= self.prof_from:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_host = [time.perf_counter()]
        elif self.prof is not None and t >= self.prof_to:
            self._stop()

    def _stop(self) -> None:
        """End the slice: its last kernels finish first.  Stopping takes
        ~20 us an event, so the slice ends with the window and the stop
        delays only the drain."""
        import torch
        torch.cuda.synchronize()
        self.prof_host.append(time.perf_counter())
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.done = True

    # ------------------------------------------------------------ results
    def finish(self) -> Dict:
        """{"calls": the window's calls (device ms from the events),
        "trace": the profiled slice's attribution or None}."""
        import torch
        if self.prof is not None:
            self._stop()
        if self.cuda:
            torch.cuda.synchronize()
        calls = [c for c in self.calls if 0.0 <= c["t"] < self.seconds]
        for c in calls:
            ev = c.pop("ev")
            c["ms"] = ev[0].elapsed_time(ev[1]) if ev is not None else None
        trace = None
        if self.events is not None:
            trace = attribute(device_ops(self.events),
                              [c for c in self.calls if c["marked"]],
                              self.prof_host[1] - self.prof_host[0])
        return {"calls": calls, "trace": trace}


def device_ops(events) -> List[Tuple[float, float, str]]:
    """(start ns, end ns, name) of the device's operations, in order."""
    from torch.autograd import DeviceType
    ops = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s = _ns(e, "start")
        ops.append((s, s + _ns(e, "duration"), e.name()))
    ops.sort()
    return ops


def attribute(ops, marked: List[Dict], window_s: float) -> Optional[Dict]:
    """Each operation to the call between whose markers it ran; the busy
    union, the idle gaps named by the open span, the top operations.  The
    markers pair up as (open, close) by their length; the pairs and the
    marked calls are matched from the end, as the first marker can fall
    before collection took effect."""
    marks = [i for i, (_, _, n) in enumerate(ops) if MARKER in n]
    if len(marks) == len(ops):
        return None
    pairs, opened = [], None
    for i in marks:
        s, e, _ = ops[i]
        if e - s < SPLIT_NS:
            opened = i
        elif opened is not None:
            pairs.append((opened, i))
            opened = None
    k = min(len(pairs), len(marked))
    owner = {}
    for (a, b), call in zip(pairs[len(pairs) - k:], marked[len(marked) - k:]):
        call["psi_s"] = call["dev_s"] = 0.0
        for j in range(a + 1, b):
            owner[j] = call
    by_name: Dict[str, float] = {}
    gaps: List[Tuple[str, float]] = []
    busy, end, prev, last = 0.0, None, None, "start"
    for j, (s, e, name) in enumerate(ops):
        if MARKER in name:
            continue
        call = owner.get(j)
        d = (e - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + d
        if call is not None:
            call["dev_s"] += d
            if PSI in name:
                call["psi_s"] += d
        if end is not None and s > end:
            # inside one call, or between two (the host's serve loop and
            # the next call's launches)
            label = (f"in {call['kind']}" if call is not None
                     and call is prev else f"serve loop after {last}")
            gaps.append((label, (s - end) / 1e9))
        prev = call
        if call is not None:
            last = call["kind"]
        if end is None or s > end:
            busy += d
            end = e
        elif e > end:
            busy += (e - end) / 1e9
            end = e
    idle_by: Dict[str, float] = {}
    for label, g in gaps:
        idle_by[label] = idle_by.get(label, 0.0) + g
    by_call: Dict[str, Dict[str, float]] = {}
    for call in {id(c): c for c in owner.values()}.values():
        k = by_call.setdefault(call["kind"], {"calls": 0, "dev_s": 0.0,
                                              "psi_s": 0.0})
        k["calls"] += 1
        k["dev_s"] += call["dev_s"]
        k["psi_s"] += call["psi_s"]
    return {"busy_s": busy, "window_s": window_s, "by_call": by_call,
            "markers": len(marks), "pairs": len(pairs),
            "marked_calls": len(marked),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])[:10],
            "idle_by_span": idle_by}
