"""AlexNet on the TMA accelerator in the PyTorch/CUDA port: functional PSI
inference and the cycle / energy model, the paper's headline numbers end
to end.

  PYTHONPATH=src python examples/alexnet_tma_torch.py                 # card
  PYTHONPATH=src python examples/alexnet_tma_torch.py --device cpu

The weights and the two images are drawn on the CPU (seeds 0 and 1) and
moved to the device, so every device runs the same network on the same
input.  The accelerator model is analytic: its lines are the same on
every device.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as bl, tma_model as tm
from repro_torch.core.quantizer import tree_map
from repro_torch.models import cnn

BATCH = 2


def tma_lines() -> list:
    """What the 4x4x16 NE array does with AlexNet (``core.tma_model``),
    against Eyeriss on conv1-5."""
    layers = tm.alexnet_layers()
    lines = []
    for bits in (5, 8):
        fps = tm.frame_rate(layers, bits)
        e = tm.energy_per_frame_j(layers, bits)
        lines.append(f"TMA INT{bits}: {fps:5.1f} fps @200 MHz, "
                     f"{e * 1e3:.2f} mJ/frame @250 MHz/1.0 V, "
                     f"{tm.macs_per_watt(bits) / 1e12:.2f} TMACs/W")
    ey = sum(bl.EYERISS.layer_time_s(layer) for layer in layers[:5])
    t5 = sum(r.time_s for r in tm.analyze_network(layers[:5], 5))
    lines.append(f"conv1-5 vs Eyeriss: {ey / t5:.1f}x faster (INT5)")
    return lines


def main(device=None, steps=None) -> float:
    """AlexNet's logits with PSI-INT5 weights against FP32 on ``device``
    (the card unless the caller names another), then the accelerator
    model; returns the logits' relative error.  ``steps`` is accepted so
    that every example is called alike: this one trains nothing."""
    del steps
    device = resolve_device(device)
    # 1. functional: AlexNet forward with PSI-INT5 weights (bit-faithful to
    #    what the SAM array computes)
    params = tree_map(lambda t: t.to(device),
                      cnn.init_cnn(cnn.ALEXNET, 0, "cpu"))
    x = torch.randn((BATCH,) + cnn.ALEXNET.in_shape,
                    generator=torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad():
        y32 = cnn.cnn_forward(params, x, cnn.ALEXNET)
        qp = cnn.quantize_cnn(params, 5)
        y5 = cnn.cnn_forward(qp, x, dataclasses.replace(cnn.ALEXNET,
                                                        quant_mode="psi5"))
    rel = float(torch.linalg.norm(y5 - y32) / torch.linalg.norm(y32))
    print(f"AlexNet logits: PSI-INT5 vs FP32 relative error {rel:.4f}")

    # 2. performance: the accelerator's cycle and energy model
    for line in tma_lines():
        print(line)
    return rel


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.device)
