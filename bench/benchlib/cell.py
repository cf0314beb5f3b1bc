"""One run of one cell: set-up, the window, the check, the result line."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import check, counts, program, traffic, window
from .manifest import Manifest
from .power import PowerSampler
from .tracer import Tracer

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is
    forbidden (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, log=print) -> Dict:
    """The result dict of one run; ``log`` gets the earlier lines."""
    device = torch.device(device)
    man = Manifest(root)
    cell = man.cell(cell_name)
    conf = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    arrivals = traffic.generate(mix, seed, seconds,
                                conf["model"]["vocab_size"])
    server = program.build_server(conf, mix, seed, device)
    warm_shapes = program.warm(server, mix)
    reqs = program.requests(arrivals)
    tracer = None
    if trace:
        tracer = Tracer(server.executor, seconds)
        tracer.install()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    power = PowerSampler(device.index or 0)
    power.start()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    _, stats = server.serve(reqs, continuous=True, warmup=False)
    t1 = time.perf_counter()
    power.stop()
    traced = tracer.finish() if tracer is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    w = window.measure(reqs, seconds)
    del server, tracer
    _free(device)

    log("setup " + json.dumps({"setup_s": setup_s, "warm_shapes":
                               warm_shapes}))
    log("power " + json.dumps(power.summary(t0, t0 + seconds)))
    keep = ("decode_steps", "prefill_forwards", "host_syncs",
            "peak_concurrency", "loop_iters", "peak_blocks_in_use")
    log("window " + json.dumps(dict(
        w, drain_s=(t1 - t0) - seconds, serve_wall_s=t1 - t0,
        **{k: stats[k] for k in keep if k in stats})))

    t_chk = time.perf_counter()
    chk = check.run(conf, seed, [r for r in reqs if r.tokens], device)
    chk["check_s"] = time.perf_counter() - t_chk
    # every number whose limit the configuration states, and the failures
    compared = {k: {"value": chk[k], "limit": float(conf["check"][k])}
                for k in check.NUMBERS if k in conf["check"]}
    compared["failed"] = {"value": w["failed"], "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    log("check " + json.dumps(chk))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": w["requests"],
              "failed": w["failed"]}
    if not trace:
        values = dict(w, setup_s=setup_s)
        # a tail that a missing request reaches is +inf, which JSON cannot
        # hold: it is left out (such a run has failed > 0, so not correct)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in man.end_to_end(cell_name)
                             if math.isfinite(values[m["name"]])}
    else:
        ctx = SimpleNamespace(model=conf["model"], quant=conf["quant"],
                              seconds=seconds, calls=traced["calls"],
                              trace=traced["trace"], counts=counts,
                              window=w)
        result["metrics"] = {}
        for m in man.per_layer(cell_name):
            v = man.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        tr = traced["trace"]
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in tr["device_ops"]],
                "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
            log("trace " + json.dumps({k: tr[k] for k in
                                       ("markers", "marked_calls", "by_call",
                                        "idle_by_span")}))
    result["device"] = dev
    result["check"] = compared
    return result


def check_lines(result: Dict) -> List[str]:
    """The numbers compared, each beside its limit."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in result["check"].items()]


def main(argv: Optional[List[str]], root: Path, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Manifest(root).cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if int(cell["chips"]) != 1:
        # a cell on several cards runs through bench/runners/chips<n>.py,
        # which launches its ranks on the port's mesh path
        runner = root / "bench" / "runners" / f"chips{cell['chips']}.py"
        if not runner.is_file():
            print(f"no runner for {cell['chips']} cards ({runner.name})",
                  file=sys.stderr)
            return 2
        spec = importlib.util.spec_from_file_location("bench_runner", runner)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main(args, root, t_start)
    result = run(root, args.workload, args.seed, args.seconds,
                 bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in check_lines(result):
        print(line, file=sys.stderr)
    return 0
