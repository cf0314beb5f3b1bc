"""AlexNet / LeNet-5, the paper's benchmark networks (Table I, §III).

The JAX package's parameter tree: a conv kernel ``convk`` in HWIO
(kernel, kernel, in/groups, out) and a fully connected ``w`` as (in,
out), so the port's quantizer gives bit-equal codes (``convk`` scales
over all axes but the output channel).  ``cnn_forward`` takes NHWC
input, as the JAX package does, and runs each conv as ``F.conv2d`` on
an NCHW view with the kernel permuted to OIHW (grouped convs split the
output channels into contiguous groups in both packages), pools with
``F.max_pool2d(pool, stride=2)`` and flattens in NHWC order before
``fc0``, the order the JAX package's reshape of an NHWC tensor gives.
The convs and products are plain PyTorch: the reference computes them
with ``lax.conv_general_dilated`` and ``x @ w``, outside any kernel.

Under ``qatN`` and ``psiN`` a float weight is fake-quantized with the
straight-through gradient (the paper's training with the quantizer in
the loop, and its forward at the PSI grid); a ``QuantizedTensor`` weight
(``quantize_cnn``) dequantizes to f32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import psi, quantizer


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: int
    stride: int
    pad: int
    pool: int = 1          # max-pool window (1 = none)
    groups: int = 1


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    in_shape: Tuple[int, int, int]         # (H, W, C)
    convs: Tuple[ConvSpec, ...]
    fcs: Tuple[int, ...]
    n_classes: int
    quant_mode: str = "none"


ALEXNET = CNNConfig(
    name="alexnet", in_shape=(227, 227, 3),
    convs=(ConvSpec(96, 11, 4, 0, pool=3),
           ConvSpec(256, 5, 1, 2, pool=3, groups=2),
           ConvSpec(384, 3, 1, 1),
           ConvSpec(384, 3, 1, 1, groups=2),
           ConvSpec(256, 3, 1, 1, pool=3, groups=2)),
    fcs=(4096, 4096), n_classes=1000)

LENET5 = CNNConfig(
    name="lenet5", in_shape=(32, 32, 1),
    convs=(ConvSpec(6, 5, 1, 0, pool=2),
           ConvSpec(16, 5, 1, 0, pool=2)),
    fcs=(120, 84), n_classes=10)


def init_cnn(cfg: CNNConfig, seed: int = 0, device=None) -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device`` (CUDA
    unless the caller names another), at the JAX init's scales: kernels
    and weights normal times fan_in^-0.5, biases zero."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * std

    params = {}
    H, W, C = cfg.in_shape
    for i, cs in enumerate(cfg.convs):
        fan_in = cs.kernel * cs.kernel * (C // cs.groups)
        params[f"conv{i}"] = {
            "convk": normal((cs.kernel, cs.kernel, C // cs.groups,
                             cs.out_ch), fan_in ** -0.5),
            "b": torch.zeros((cs.out_ch,), dtype=torch.float32,
                             device=device),
        }
        H = (H + 2 * cs.pad - cs.kernel) // cs.stride + 1
        W = (W + 2 * cs.pad - cs.kernel) // cs.stride + 1
        if cs.pool > 1:
            H, W = (H - cs.pool) // 2 + 1, (W - cs.pool) // 2 + 1
        C = cs.out_ch
    dim = H * W * C
    for j, out in enumerate(tuple(cfg.fcs) + (cfg.n_classes,)):
        params[f"fc{j}"] = {
            "w": normal((dim, out), dim ** -0.5),
            "b": torch.zeros((out,), dtype=torch.float32, device=device),
        }
        dim = out
    return params


def _maybe_q(w, quant_mode, conv=False):
    if isinstance(w, psi.QuantizedTensor):
        return quantizer.dequantize(w, torch.float32)
    kind, bits = quantizer.parse_quant_mode(quant_mode)
    if kind is None:
        return w
    axis = tuple(range(w.dim() - 1)) if conv else (w.dim() - 2,)
    return psi.fake_quant_ste(w, bits, axis)


def cnn_forward(params: dict, x: torch.Tensor, cfg: CNNConfig
                ) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes)."""
    qm = cfg.quant_mode
    x = x.permute(0, 3, 1, 2)                                  # NCHW
    for i, cs in enumerate(cfg.convs):
        w = _maybe_q(params[f"conv{i}"]["convk"], qm, conv=True)
        x = F.conv2d(x, w.permute(3, 2, 0, 1), stride=cs.stride,
                     padding=cs.pad, groups=cs.groups)
        x = F.relu(x + params[f"conv{i}"]["b"][:, None, None])
        if cs.pool > 1:
            x = F.max_pool2d(x, cs.pool, stride=2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # NHWC order
    n_fc = len(cfg.fcs) + 1
    for j in range(n_fc):
        w = _maybe_q(params[f"fc{j}"]["w"], qm)
        x = x @ w + params[f"fc{j}"]["b"]
        if j < n_fc - 1:
            x = F.relu(x)
    return x


def cnn_loss(params, batch, cfg: CNNConfig):
    """(mean cross-entropy, {"acc"}) of ``batch`` = {"images" (B, H, W,
    C), "labels" (B,)}."""
    logits = cnn_forward(params, batch["images"], cfg).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"acc": acc}


def quantize_cnn(params: dict, bits: int = None, policy=None) -> dict:
    return quantizer.quantize_param_tree(params, bits, policy=policy)
