"""The check's two readings on the card, at a cell's own size and load:
the served path's logit gaps (``check.NUMBERS``) on each of ``--seeds``,
and the controls' (the reference with float8 activations put in the
program's place: ``reference.model``'s ``act="fp8"``) on each of
``--control-seeds``.  One process; each seed draws its
own weights and traffic and serves a window of ``--seconds``.

    python3 bench/tools/readings.py --workload phi3-psi8.rag \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 12

A limit in the configuration's ``check`` block is set between the two:
above the largest served reading, below the smallest control reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import check, program, traffic, window  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402
from reference.model import Reference  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import torch
    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    conf, mix = man.config(cell["config"]), man.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | ctrl):
        t = time.perf_counter()
        server = program.build_server(conf, mix, seed, "cuda:0")
        program.warm(server, mix)
        reqs = program.requests(traffic.generate(
            mix, seed, args.seconds, conf["model"]["vocab_size"]))
        server.serve(reqs, continuous=True, warmup=False)
        w = window.measure(reqs, args.seconds)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        picked = check.sample([r for r in reqs if r.tokens],
                              int(conf["check"]["sample"]), seed)
        seqs, pos = check.sequences(picked)
        t_ref = time.perf_counter()
        ref = Reference(conf["model"], conf["quant"]["bits"], seed,
                        "cuda:0").logits_at(seqs, pos)
        row = {"seed": seed, "failed": w["failed"],
               "served_tokens": sum(len(r.tokens) for r in picked),
               "reference_s": time.perf_counter() - t_ref}
        if seed in seeds:
            row["served"] = check.served_gaps(ref, picked)
        if seed in ctrl:
            low = Reference(conf["model"], conf["quant"]["bits"], seed,
                            "cuda:0", act="fp8").logits_at(seqs, pos)
            row["control"] = check.control_gaps(ref, low)
            del low
        del ref
        torch.cuda.empty_cache()
        row["wall_s"] = time.perf_counter() - t
        rows.append(row)
        print("reading " + json.dumps(row), flush=True)
    out = ROOT / args.out
    out.mkdir(exist_ok=True)
    (out / f"readings_{args.workload}.json").write_text(json.dumps(
        {"workload": args.workload, "seconds": args.seconds,
         "card": torch.cuda.get_device_name(0), "rows": rows}, indent=1))
    summary = {}
    for key in ("served", "control"):
        got = [r[key] for r in rows if key in r]
        for n in check.NUMBERS:
            vals = [g[n] for g in got]
            if vals:
                summary[f"{key}.{n}"] = [min(vals), max(vals)]
    print("summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
