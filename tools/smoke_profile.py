"""Where one phase of ``chip_smoke.py`` spends its host time, on the card.

    python tools/smoke_profile.py [--phase serve_psi8] [--top 40]

Builds the port's kernels, runs the phase under ``cProfile`` and prints its
wall seconds, then the ``--top`` functions by cumulative and by own time.
Phases: ``serve_psi8`` (with its horizon, dense and mesh parts),
``serve_psi5``, ``serve_psi8_ctx``, ``serve_psi5_spec``, ``card_vs_cpu``.
``chip_smoke.py`` keeps inside a fixed time limit; this says what to cut
first.  Needs a card; imports no JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="serve_psi8",
                    choices=("serve_psi8", "serve_psi5", "serve_psi8_ctx",
                             "serve_psi5_spec", "card_vs_cpu"))
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("smoke_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t:.3f}", flush=True)
    dev = torch.device("cuda")
    run = {"serve_psi8": lambda: cs.phase_serve(torch, dev, {}, "psi8"),
           "serve_psi5": lambda: cs.phase_serve(torch, dev, {}, "psi5"),
           "serve_psi8_ctx": lambda: cs.phase_serve_ctx(torch, dev, {}),
           "serve_psi5_spec": lambda: cs.phase_serve_spec(torch, dev, {}),
           "card_vs_cpu": lambda: cs.phase_card_vs_cpu(torch, dev)}
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    run[args.phase]()
    prof.disable()
    print(f"{args.phase}_s {time.perf_counter() - t:.3f} (under cProfile)",
          flush=True)
    for key in ("cumulative", "tottime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
