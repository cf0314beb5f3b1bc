"""Continuous-batching serving with PSI-compressed weights in the PyTorch/
CUDA port: the paper's inference regime (weight traffic is the
bottleneck) mapped to LM decode.

Runs the slot-based Server over an arrival trace for each weight format
and reports the serving-weight footprint: the bytes each decode step's
PSI matmuls stream (kernel 1 at psi8, kernel 2 at psi5 / psi4 and the
mixed policy, kernel 3 for the paged attention read, on the card).

  PYTHONPATH=src python examples/serve_quantized_torch.py              # card
  PYTHONPATH=src python examples/serve_quantized_torch.py --device cpu

Each line names where it ran: "CPU", or the card's name and power limit
as nvidia-smi reports them.
"""
import argparse
import dataclasses
import subprocess

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quantizer import quantized_bytes
from repro_torch.launch.scheduler import poisson_trace
from repro_torch.launch.serve import Server, card_uuid
from repro_torch.models import build_model

MAX_NEW = 8
# uniform widths from the PsiFormat registry, plus a mixed-precision policy
# (embeddings keep 8 bits, the bulk rides the sub-5-bit frontier)
FORMATS = (("none", {}),
           ("psi8", dict(bits=8)),
           ("psi5", dict(bits=5, pack=True)),
           ("psi4", dict(bits=4, pack=True)),
           ("mixed", dict(policy={"embed": 8, "default": 4}, pack=True)))


def where(device) -> str:
    """"CPU", or the card's `nvidia-smi --query-gpu=name,power.limit` line."""
    if device.type != "cuda":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", card_uuid(device)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def main(device=None, steps=None) -> dict:
    """Serve 4 requests of at most ``steps`` new tokens (default MAX_NEW)
    in each format on ``device`` (the card unless the caller names
    another); returns {format: (finished requests, stats)}."""
    device = resolve_device(device)
    max_new = MAX_NEW if steps is None else steps
    cfg = reduced_config(get_config("chatglm3-6b"))
    model = build_model(cfg)
    params = model.init(0, device)
    base_bytes = quantized_bytes(params)
    at = where(device)
    served = {}
    for quant, spec in FORMATS:
        p = model.quantize(params, **spec) if spec else params
        scfg = cfg if not spec else dataclasses.replace(
            cfg, quant_mode=quant if quant.startswith("psi") else "none")
        reqs = poisson_trace(4, rate_rps=500.0, prompt_len=24,
                             max_new=max_new, vocab_size=cfg.vocab_size,
                             seed=0)
        server = Server(scfg, p, max_batch=4, max_seq=48, device=device)
        done, stats = server.serve(reqs, continuous=True)
        nbytes = quantized_bytes(p)
        print(f"{quant:5s}: {stats['tok_per_s']:8.1f} tok/s ({at}), "
              f"weights {nbytes / 1e6:7.2f} MB "
              f"({base_bytes / nbytes:.2f}x smaller), "
              f"sample: {done[0].out[:6].tolist()}")
        served[quant] = (done, stats)
    return served


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=MAX_NEW,
                    help="the trace's largest decode budget")
    a = ap.parse_args()
    main(a.device, a.steps)
