"""A toy cell built from new files alone, for the CPU tests: a copy of the
benchmark's folders with one more configuration (a 2-layer, 64-wide
phi3-style decoder served in float32 on the CPU), one more traffic mix and
one more per-layer metric, and a manifest that names them."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 16, "d_ff": 128, "vocab_size": 256,
             "act": "swiglu", "norm_eps": 1e-05, "rope_theta": 10000.0}

TOY_CONFIG = {
    "name": "toy-psi8",
    "model": TOY_MODEL,
    "quant": {"bits": 8, "pack": False},
    "run": {"preset": "phi3-medium-14b",
            "overrides": dict({k: v for k, v in TOY_MODEL.items()
                               if k not in ("act", "rope_theta")},
                              dtype="float32")},
    "serve": {"decode_horizon": 1},
    # float32 on both sides: the served path agrees with the reference to
    # rounding (~1e-5 on logits of ~4), and a wrong token is ~1 away
    "check": {"sample": 4, "max_logit_gap": 1e-3},
}

TOY_MIX = {"slots": 4, "rate_rps": 12.0, "schedule_seed": 1,
           "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                      "min": 8, "max": 64},
           "output": {"dist": "uniform", "min": 3, "max": 8}}

TOY_METRIC = '''"""Prefill calls in the window (a metric added as one file)."""


def read(ctx):
    return float(sum(1 for c in ctx.calls if c["kind"] == "prefill"))
'''


def make_root(tmp: Path, config=None) -> Path:
    """A checkout-like tree at ``tmp``: ``bench/`` copied, the toy files
    added, and a manifest whose only cell is ``toy.chat``."""
    shutil.copytree(BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "bench" / "configs" / "toy-psi8.json").write_text(
        json.dumps(config or TOY_CONFIG))
    (tmp / "bench" / "traffic" / "toychat.json").write_text(
        json.dumps(TOY_MIX))
    (tmp / "bench" / "metrics" / "toy_prefill_calls.py").write_text(
        TOY_METRIC)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "toy-psi8", "source": "a test fixture",
                       "file": "bench/configs/toy-psi8.json", "reduced": [],
                       "why": "CPU rehearsal"}]
    man["workloads"] = [{"name": "toy.chat", "config": "toy-psi8",
                         "traffic": "toychat", "chips": 1,
                         "why": "CPU rehearsal"}]
    for m in man["end_to_end"] + man["per_layer"]:
        m.pop("workloads", None)
    man["per_layer"].append({"name": "toy_prefill_calls", "unit": "calls",
                             "better": "lower", "source": "program_counter",
                             "layer": "server", "moves": "ttft_p80_ms"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def run_toy(root: Path, seed: int = 5, seconds: float = 1.0,
            trace: bool = False):
    import time
    from benchlib import cell
    lines = []
    res = cell.run(root, "toy.chat", seed, seconds, trace, "cpu",
                   time.perf_counter(), log=lines.append)
    return res, lines
