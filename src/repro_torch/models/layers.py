"""Shared building blocks: RMSNorm and LayerNorm, qk-norm, RoPE (plain, 2-D
and the multimodal M-RoPE), sinusoidal positions and the MLPs (gated
SwiGLU / GeGLU, 2-matrix GELU).

Plain functions over explicit parameter dicts; every matmul routes through
:func:`repro_torch.quant.linear` so PSI weights take the kernel path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant import linear


def apply_norm(p, x, cfg):
    """RMSNorm, or LayerNorm with a bias: f32 statistics, activation-dtype
    application (LayerNorm rounds ``x - mu`` and the product by ``inv`` in
    the activation dtype, then ``* scale + bias``)."""
    if cfg.norm == "layernorm":
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        inv = torch.rsqrt(var + cfg.norm_eps)
        y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
        return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
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


def _rotate(x, cos, sin):
    """NeoX rotate-half over x's last dim (cos, sin cover half of it)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, cfg):
    """x (B, S, H, D); positions (B, S) int, or (B, 3, S) for mrope.

    * "rope":   full-dim NeoX rotate-half.
    * "rope2d": the ChatGLM scheme as the JAX package writes it — rotate-half
      over the first D/2 head dims with the frequencies of a D/2-dim RoPE,
      the second half passed through unchanged.
    * "mrope":  Qwen2-VL multimodal RoPE — the D/2 frequencies split 2:1:1
      into the t, h and w sections, each rotated by its own position
      stream; three equal streams are plain RoPE.
    * "sinusoidal" / "none": positions enter at the embedding (or not at
      all): the identity here.
    """
    if cfg.rope in ("sinusoidal", "none"):
        return x
    if cfg.rope not in ("rope", "rope2d", "mrope"):
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported")
    D = x.shape[-1]
    rot = D // 2 if cfg.rope == "rope2d" else D
    freqs = _rope_freqs(rot, cfg.rope_theta, x.device)
    if cfg.rope == "mrope":
        nf = freqs.shape[0]
        cuts = (0, nf // 2, nf // 2 + nf // 4, nf)
        pos = positions.to(torch.float32)                     # (B, 3, S)
        ang = torch.cat([pos[:, i, :, None] * freqs[cuts[i]:cuts[i + 1]]
                         for i in range(3)], dim=-1)          # (B, S, nf)
    else:
        ang = positions[..., None].to(torch.float32) * freqs  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    if rot == D:
        return _rotate(x, cos, sin)
    return torch.cat([_rotate(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


def sinusoidal_from_positions(positions, D, dtype=torch.float32):
    """positions (B, S) -> (B, S, D): ``[sin, cos]`` of the position times
    ``exp(-ln(1e4) * i / max(D/2 - 1, 1))``, i < D/2, in f32 and cast last
    (whisper's prefill and, at the token's absolute position, its
    decode)."""
    i = torch.arange(D // 2, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / max(D // 2 - 1, 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal_embedding(S, D, offset=0, dtype=torch.float32, device=None):
    """The (S, D) table of positions ``[offset, offset + S)``."""
    pos = torch.arange(offset, offset + S, dtype=torch.int32,
                       device=device)[None]
    return sinusoidal_from_positions(pos, D, dtype)[0]


def positions_1d(positions):
    """The stream that drives cache slots and the causal mask: positions
    (B, S) as they are, or the temporal stream of mrope's (B, 3, S)."""
    return positions[:, 0] if positions.ndim == 3 else positions


def _gelu(x):
    # jax.nn.gelu's default is the tanh form; torch's default is exact erf
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg):
    """swiglu / geglu: w_down(act(w_gate x) * w_up x); gelu: the 2-matrix
    w_down(gelu(w_up x)), no gate."""
    qm = cfg.quant_mode
    if cfg.act in ("swiglu", "geglu"):
        g = linear(p["w_gate"], x, qm)
        u = linear(p["w_up"], x, qm)
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        return linear(p["w_down"], act * u, qm)
    if cfg.act != "gelu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet")
    return linear(p["w_down"], _gelu(linear(p["w_up"], x, qm)), qm)
