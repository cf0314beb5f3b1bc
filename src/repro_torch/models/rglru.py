"""RG-LRU recurrent block (Griffin / recurrentgemma-9b, arXiv:2402.19427).

Two branches from the residual stream, merged by an elementwise product
and projected out:

  branch 1: linear -> GeLU                            (gate)
  branch 2: linear -> causal conv1d(cw) -> RG-LRU     (recurrence)

RG-LRU, per channel::

  r_t = sigmoid(W_a x_t + b_a)                  recurrence gate
  i_t = sigmoid(W_x x_t + b_x)                  input gate
  a_t = exp(-c * softplus(Lambda) * r_t)        in (0, 1), c = rglru_c
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The five projections go through :func:`repro_torch.quant.linear` (the PSI
kernels); the conv, the gates and the recurrence are plain PyTorch in f32,
as the JAX package leaves them to XLA.  The prefill recurrence is a
doubling (Hillis-Steele) scan over the whole sequence: log2(S) steps of a
few elementwise ops, the same associative combine the JAX package runs
inside its chunks in another order (so h agrees to f32 rounding, not
bit for bit).  A prompt of any length runs; the JAX package's chunk
reshape needs ``S % max(S // CHUNK, 1) == 0``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.layers import _gelu
from repro_torch.quant import linear

# the JAX package's scan chunk (its ``repro.models.ssm.CHUNK``): the prefill
# lengths its chunked scan accepts are those with S % max(S // CHUNK, 1) == 0
CHUNK = 256


def param_specs(cfg, pre: str):
    """(path, shape, init) of one rec block's leaves under ``pre`` at the
    JAX init's scales: a float init is a normal draw times that std, a
    ``("fill", v)`` init the constant v."""
    d, dr, cw = cfg.d_model, cfg.resolved_d_rnn, cfg.ssm_conv
    return [(f"{pre}/w_in_rec", (d, dr), d ** -0.5),
            (f"{pre}/w_in_gate", (d, dr), d ** -0.5),
            (f"{pre}/conv1d_w", (cw, dr), 0.1),
            (f"{pre}/conv1d_b", (dr,), ("fill", 0.0)),
            (f"{pre}/rglru_wa", (dr, dr), dr ** -0.5),
            (f"{pre}/rglru_wx", (dr, dr), dr ** -0.5),
            (f"{pre}/rglru_ba", (dr,), ("fill", 0.0)),
            (f"{pre}/rglru_bx", (dr,), ("fill", 0.0)),
            (f"{pre}/rglru_lambda", (dr,), ("fill", 0.7)),
            (f"{pre}/w_out", (dr, d), dr ** -0.5)]


def _softplus(x):
    """``jax.nn.softplus`` as JAX computes it: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _conv_causal(p, x, cw):
    """Depthwise causal conv over the sequence: x (B, S, dr) in the
    activation dtype, f32 taps -> f32."""
    w = p["conv1d_w"]
    S = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], cw - 1, x.shape[2])), x], 1)
    return sum(xp[:, i:i + S, :] * w[i] for i in range(cw)) + p["conv1d_b"]


def _gates(p, x, cfg):
    """a_t (decay) and the gated input, both (B, S, dr) f32."""
    qm = cfg.quant_mode
    r = torch.sigmoid(linear(p["rglru_wa"], x, qm).to(torch.float32)
                      + p["rglru_ba"])
    i = torch.sigmoid(linear(p["rglru_wx"], x, qm).to(torch.float32)
                      + p["rglru_bx"])
    a = torch.exp(-cfg.rglru_c * _softplus(p["rglru_lambda"]) * r)
    gated = (torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
             * (i * x.to(torch.float32)))
    return a, gated


def _scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over the sequence; a, b (B, S, dr), h0
    (B, dr).  Returns (h (B, S, dr), h_last (B, dr))."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b, b[:, -1]


def rglru_block(p, x, cfg, state=None):
    """The prefill block over x (B, S, d).  Returns (y, {"h": (B, dr) f32,
    "conv": (B, cw-1, dr) f32}): the last state and the last cw-1 rows of
    the conv's input (zeros before the first token)."""
    B, S, _ = x.shape
    cw, qm = cfg.ssm_conv, cfg.quant_mode
    gate = _gelu(linear(p["w_in_gate"], x, qm))
    xr = linear(p["w_in_rec"], x, qm)
    tail = xr[:, -(cw - 1):, :].to(torch.float32)
    if tail.shape[1] < cw - 1:
        tail = torch.cat([tail.new_zeros((B, cw - 1 - tail.shape[1],
                                          tail.shape[2])), tail], 1)
    xr = _conv_causal(p, xr, cw).to(x.dtype)
    a, b = _gates(p, xr, cfg)
    h0 = (torch.zeros((B, a.shape[-1]), dtype=torch.float32,
                      device=x.device) if state is None else state["h"])
    hs, h_last = _scan(a, b, h0)
    y = hs.to(x.dtype) * gate
    return linear(p["w_out"], y, qm), {"h": h_last, "conv": tail}


def init_rglru_state(cfg, batch, device=None):
    """One rec layer's decode state on ``device`` (CUDA unless the caller
    names another): zeros."""
    device = resolve_device(device)
    dr = cfg.resolved_d_rnn
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, dr),
                                dtype=torch.float32, device=device)}


def rglru_decode_step(p, x, cfg, state):
    """One-token update, x (B, 1, d).  Returns (y, new state); ``state``
    is not written."""
    qm = cfg.quant_mode
    gate = _gelu(linear(p["w_in_gate"], x, qm))                # (B, 1, dr)
    xr = linear(p["w_in_rec"], x, qm)
    conv_buf = torch.cat([state["conv"], xr.to(torch.float32)], 1)
    xc = ((conv_buf * p["conv1d_w"]).sum(1) + p["conv1d_b"])[:, None, :]
    a, b = _gates(p, xc.to(x.dtype), cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = h[:, None, :].to(x.dtype) * gate
    return linear(p["w_out"], y, qm), {"h": h, "conv": conv_buf[:, 1:, :]}
