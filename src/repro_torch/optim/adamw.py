"""Optimizers over the port's parameter trees (nested dicts and lists of
tensors): AdamW and SGD with momentum, the cosine learning-rate schedule
and global-norm clipping, in the JAX package's order of operations.

``torch.optim.AdamW`` is not used: it applies the weight decay as a
separate multiply of the parameter (another rounding) and has no
global-norm clip.  Here, per leaf and in f32::

    g      = (g * clip_scale).to(g.dtype)   (the clip comes first)
    m      = b1 * m + (1 - b1) * g
    v      = b2 * v + (1 - b2) * g * g
    delta  = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
    p      = (p - lr * delta).to(p.dtype)

The updates write p, m and v in place (the JAX package returns new trees
of the same values): at full width a second copy of the params and both
moments would not fit beside them.  Only one leaf's temporaries are live
at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.quantizer import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """step -> learning rate (a float holding the f32 value the JAX
    schedule computes): linear warmup over ``warmup`` steps, then a cosine
    from ``base_lr`` to 0 at ``total``."""
    def lr(step):
        s = _f32(step)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(torch.where(s < warmup, warm, cos))
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares: a 0-d f32 tensor on the leaves' device."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / global norm), each in its own
    dtype; the global norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=0, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, grad_norm=None):
        """One step: clip, then the moments and the parameters, in place.
        Returns (params, state, {"grad_norm", "lr"}), the trees those of
        the arguments.  ``grad_norm``: the global norm when the leaves are
        one rank's chunks (``runtime.fsdp.TrainShare.global_norm``); by
        default the norm of ``grads``."""
        gn = global_norm(grads) if grad_norm is None else grad_norm
        scale = _clip_scale(gn, self.clip_norm)
        step = state.step + 1
        lr = _lr_at(self.lr, step)
        b1c = float(1 - _f32(self.b1) ** _f32(step))
        b2c = float(1 - _f32(self.b2) ** _f32(step))
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            gf = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            del gf
            pf = p.to(torch.float32)
            # tensor divisors: CUDA divides by a Python scalar as a
            # product with its reciprocal (another rounding)
            delta = ((m2 / m2.new_full((), b1c))
                     / (torch.sqrt(v2 / v2.new_full((), b2c)) + self.eps)
                     + self.weight_decay * pf)
            p.copy_((pf - lr * delta).to(p.dtype))
            m.copy_(m2)
            v.copy_(v2)
            del m2, v2, pf, delta
        return (params, AdamWState(step, state.m, state.v),
                {"grad_norm": gn, "lr": lr})


@dataclasses.dataclass(frozen=True)
class sgd:
    lr: Callable | float = 1e-2
    momentum: float = 0.9
    clip_norm: float = 0.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=0, m=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params), v={})

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """``m = momentum * m + g``, ``p -= lr * m`` (f32), in place; the
        clip only with ``clip_norm``."""
        gn = torch.zeros((), dtype=torch.float32)
        scale = None
        if self.clip_norm:
            gn = global_norm(grads)
            scale = _clip_scale(gn, self.clip_norm)
        step = state.step + 1
        lr = _lr_at(self.lr, step)
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state.m)):
            if scale is not None:
                g = (g.to(torch.float32) * scale).to(g.dtype)
            m2 = self.momentum * m + g.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * m2).to(p.dtype))
            m.copy_(m2)
        return (params, AdamWState(step, state.m, {}),
                {"grad_norm": gn, "lr": lr})
