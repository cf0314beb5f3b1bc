"""Table I end to end in the PyTorch/CUDA port: LeNet-5 on procedural MNIST
digits, FP32 against QAT and post-training PSI quantization at INT8 and
INT5.

Paper claim: LeNet-5 Top-1 degradation is 0 % at both INT5 and INT8.

  PYTHONPATH=src python examples/train_lenet_qat_torch.py              # card
  PYTHONPATH=src python examples/train_lenet_qat_torch.py --device cpu

The initial weights are drawn on the CPU from seed 0 and moved to the
device, so every device starts from the same network.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.data import synthetic_mnist
from repro_torch.models import cnn

STEPS, BATCH, LR = 300, 128, 0.05


def train(cfg, device, steps=STEPS, lr=LR, seed=0):
    """``steps`` steps of plain SGD on ``cnn_loss`` under ``cfg``'s quant
    mode, batches of BATCH in order from synthetic_mnist(4096, seed=1)."""
    params = tree_map(lambda t: t.to(device),
                      cnn.init_cnn(cnn.LENET5, seed, "cpu"))
    xs, ys = synthetic_mnist(4096, seed=1)
    xs, ys = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    for i in range(steps):
        lo = (i * BATCH) % (len(xs) - BATCH)
        batch = {"images": xs[lo:lo + BATCH], "labels": ys[lo:lo + BATCH]}
        loss, _ = cnn.cnn_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
    return tree_map(torch.Tensor.detach, params)


def evaluate(params, cfg, device) -> float:
    """Top-1 accuracy on synthetic_mnist(2048, seed=2)."""
    xt, yt = synthetic_mnist(2048, seed=2)
    test = {"images": torch.from_numpy(xt).to(device),
            "labels": torch.from_numpy(yt).to(device)}
    with torch.no_grad():
        _, m = cnn.cnn_loss(params, test, cfg)
    return float(m["acc"])


def main(device=None, steps=None) -> dict:
    """Train FP32, QAT-INT8 and QAT-INT5 LeNet-5 for ``steps`` steps each
    (default STEPS) on ``device`` (the card unless the caller names
    another); returns {"fp32": acc, "ptq8": acc, "qat8": acc, ...}."""
    device = resolve_device(device)
    steps = STEPS if steps is None else steps
    fp32 = cnn.LENET5
    params = train(fp32, device, steps)
    acc32 = evaluate(params, fp32, device)
    accs = {"fp32": acc32}
    print(f"FP32 test accuracy: {acc32:.4f}")
    for bits in (8, 5):
        # post-training quantization (what the deployed accelerator runs)
        qcfg = dataclasses.replace(fp32, quant_mode=f"psi{bits}")
        acc_ptq = evaluate(cnn.quantize_cnn(params, bits), qcfg, device)
        # QAT (the paper trains WITH the quantization)
        qat_params = train(dataclasses.replace(fp32, quant_mode=f"qat{bits}"),
                           device, steps)
        acc_qat = evaluate(cnn.quantize_cnn(qat_params, bits), qcfg, device)
        print(f"PSI-INT{bits}: PTQ {acc_ptq:.4f} "
              f"({100 * (acc32 - acc_ptq):+.2f}pp)  "
              f"QAT {acc_qat:.4f} ({100 * (acc32 - acc_qat):+.2f}pp)   "
              f"[paper: 0.0pp]")
        accs[f"ptq{bits}"], accs[f"qat{bits}"] = acc_ptq, acc_qat
    return accs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args()
    main(a.device, a.steps)
