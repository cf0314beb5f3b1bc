"""Quickstart of the PyTorch/CUDA port: train a reduced qwen3-style LM with
PSI-INT8 QAT, quantize it to the serving format (INT5, packed bit-planes)
and generate tokens: the paper technique's whole lifecycle in one script.

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card every psi5 product of the generation runs kernel 2
(``src/repro_torch/csrc/psi_matmul.cu``); on the CPU its plain version.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quantizer import tree_map
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule

STEPS = 120
PROMPT_LEN, NEW_TOKENS, CACHE_LEN = 16, 12, 48


def generate(model, qparams, prompt: torch.Tensor) -> torch.Tensor:
    """Greedy decoding: the prefill's argmax, then NEW_TOKENS decode steps
    on the prefill's cache -> (B, 1 + NEW_TOKENS) token ids."""
    B = prompt.shape[0]
    logits, cache = model.prefill(qparams, prompt, cache_len=CACHE_LEN)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(NEW_TOKENS):
        pos = torch.full((B, 1), PROMPT_LEN + i, dtype=torch.int32,
                         device=prompt.device)
        lg, cache = model.decode_step(qparams, {"token": tok, "pos": pos},
                                      cache)
        tok = torch.argmax(lg, -1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def main(device=None, steps=None) -> torch.Tensor:
    """``steps`` QAT steps (default STEPS) on ``device`` (the card unless
    the caller names another), then psi5 generation; returns the
    generated tokens."""
    device = resolve_device(device)
    steps = STEPS if steps is None else steps
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="qat8")
    model = build_model(cfg)
    params = model.init(0, device)
    opt = adamw(lr=cosine_schedule(3e-3, 10, 200))
    opt_state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, seq_len=64, global_batch=16)
    train_step = make_train_step(model, opt)

    print("== training (QAT-INT8: the paper's 'trained with the proposed "
          "quantization') ==")
    for step in range(steps):
        tokens = torch.from_numpy(next(stream)).to(device)
        params, opt_state, _, met = train_step(params, opt_state, {},
                                               {"tokens": tokens})
        if step % 20 == 0:
            print(f"  step {step:4d}  loss {float(met['loss']):.4f}")

    print("== quantize to PSI serving format (INT5, packed bit-planes) ==")
    params = tree_map(torch.Tensor.detach, params)
    with torch.no_grad():
        qparams = model.quantize(params, bits=5, pack=True)
        serve_model = build_model(dataclasses.replace(cfg, quant_mode="psi5"))
        prompt = torch.from_numpy(next(stream)[:2, :PROMPT_LEN]).to(device)
        gen = generate(serve_model, qparams, prompt)
    print(f"  generated (psi5 weights, 0.625 B/weight): {gen[0].tolist()}")
    print("done.")
    return gen


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args()
    main(a.device, a.steps)
