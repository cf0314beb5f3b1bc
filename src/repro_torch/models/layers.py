"""Shared building blocks: RMSNorm, qk-norm, RoPE and the SwiGLU MLP.

Plain functions over explicit parameter dicts; every matmul routes through
:func:`repro_torch.quant.linear` so PSI weights take the kernel path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.quant import linear


def apply_norm(p, x, cfg):
    """RMSNorm: f32 statistics, activation-dtype application."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + cfg.norm_eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def rms_head_norm(scale, x, eps):
    """qk-norm: RMSNorm over the head dim, scale shared across heads."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def _rope_freqs(dim, theta, device):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, cfg):
    """x (B, S, H, D); positions (B, S) int -> full-dim NeoX rotate-half."""
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet")
    D = x.shape[-1]
    freqs = _rope_freqs(D, cfg.rope_theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_mlp(p, x, cfg):
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet")
    qm = cfg.quant_mode
    g = linear(p["w_gate"], x, qm)
    u = linear(p["w_up"], x, qm)
    return linear(p["w_down"], F.silu(g) * u, qm)
