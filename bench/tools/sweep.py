"""Knee sweep of one cell on the card: one set-up, then the cell's mix
served at each offered rate for ``--seconds``, printing a line a rate.

    python3 bench/tools/sweep.py --workload phi3-psi8.rag \
        --rates 1,1.5,2,2.5,3 --seconds 25 --seed 11

The knee is the highest rate whose backlog stays flat: requests still
waiting for their first token at the window's end stay few, and the
time to first token does not grow with the rate.  A cell's rate is then
written into its traffic file as a number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import program, traffic, window  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import torch
    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    conf, mix = man.config(cell["config"]), man.traffic(cell["traffic"])
    t = time.perf_counter()
    server = program.build_server(conf, mix, args.seed, "cuda:0")
    program.warm(server, mix)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t:.1f} s", flush=True)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        arr = traffic.generate(dict(mix, rate_rps=rate), args.seed,
                               args.seconds, conf["model"]["vocab_size"])
        reqs = program.requests(arr)
        t0 = time.perf_counter()
        _, stats = server.serve(reqs, continuous=True, warmup=False)
        wall = time.perf_counter() - t0
        w = window.measure(reqs, args.seconds)
        waiting = sum(1 for r in reqs if r.first_token_s is None
                      or r.first_token_s >= args.seconds)
        row = dict(rate=rate, waiting_at_end=waiting,
                   drain_s=wall - args.seconds,
                   decode_steps=stats["decode_steps"],
                   prefill_forwards=stats["prefill_forwards"], **w)
        rows.append(row)
        print("rate " + json.dumps(row), flush=True)
    out = ROOT / args.out
    out.mkdir(exist_ok=True)
    (out / f"sweep_{args.workload}.json").write_text(json.dumps(
        {"workload": args.workload, "seconds": args.seconds,
         "seed": args.seed, "card": torch.cuda.get_device_name(0),
         "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
