"""Mamba-1 selective state-space block (falcon-mamba-7b, arXiv:2410.05355).

From the residual stream ``x`` (B, S, d)::

  xs, z  = in_proj(x)                         two (B, S, d_inner) halves
  xc     = silu(causal conv1d(xs))            f32 from the f32 taps on
  dt, B, C = x_proj(xc)                       dt_rank, N, N columns
  dt     = softplus(dt_proj(dt) + dt_b)       f32 (B, S, d_inner)
  h_t    = exp(dt_t A) h_{t-1} + dt_t xc_t B_t      A = -exp(a_log), state
                                                   (B, d_inner, N) f32
  y      = (h_t . C_t + d_skip xc_t) * silu(z)
  out    = out_proj(y)

The four projections go through :func:`repro_torch.quant.linear` (the PSI
kernels); the conv, the discretization, the recurrence and the gating are
plain PyTorch, as the JAX package leaves them to XLA.  The two paths
follow the reference's dtypes: at prefill ``xc`` stays f32, so ``x_proj``
and ``dt_proj`` run on f32 rows; at decode ``xc`` is cast to the
activation dtype before ``x_proj`` (the skip term keeps the f32 ``xc``).

The prefill recurrence runs chunk by chunk (``CHUNK`` positions, the last
chunk shorter), each chunk a doubling scan (``rglru._scan``) carrying ``h``
into the next, so no (B, S, d_inner, N) tensor longer than a chunk is
live; ``x_proj`` / ``dt_proj`` run once over all S rows (the PSI kernels'
rows do not depend on the batch).  The reference scans ``max(S // CHUNK,
1)`` equal chunks with an associative scan inside each, the same
recurrence in another summation order; a prompt of any length runs here,
while the reference's chunk reshape needs ``S % max(S // CHUNK, 1) ==
0``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.rglru import _conv_causal, _scan, _softplus
from repro_torch.quant import linear

CHUNK = 256


def param_specs(cfg, pre: str):
    """(path, shape, init) of one mamba block's leaves under ``pre`` at the
    JAX init's scales: a float init is a normal draw times that std, None
    ones, ``("fill", v)`` the constant v, ``("dt_bias", lo, hi)`` the
    inverse softplus of a uniform draw in [lo, hi) and ``("a_log",)``
    ``log(1..N)`` on every row."""
    d, di = cfg.d_model, cfg.d_inner
    r, N, cw = cfg.resolved_dt_rank, cfg.ssm_state, cfg.ssm_conv
    return [(f"{pre}/in_proj", (d, 2 * di), d ** -0.5),
            (f"{pre}/conv1d_w", (cw, di), 0.1),
            (f"{pre}/conv1d_b", (di,), ("fill", 0.0)),
            (f"{pre}/x_proj", (di, r + 2 * N), di ** -0.5),
            (f"{pre}/dt_proj_w", (r, di), r ** -0.5),
            (f"{pre}/dt_proj_b", (di,), ("dt_bias", 1e-3, 1e-1)),
            (f"{pre}/a_log", (di, N), ("a_log",)),
            (f"{pre}/d_skip", (di,), None),
            (f"{pre}/out_proj", (di, d), di ** -0.5)]


def init_leaf(init, shape, gen, device):
    """The two mamba-only inits of :func:`param_specs` (f32)."""
    if init[0] == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * (init[2] - init[1]) + init[1]
        return torch.log(torch.exp(u) - 1 + 1e-9)
    if init[0] == "a_log":
        n = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device)
        return torch.log(n).expand(shape).contiguous()
    raise ValueError(f"unknown init {init!r}")


def _project(p, xc, cfg):
    """x_proj and dt_proj of the conv output ``xc`` (B, S, d_inner):
    (dt (B, S, d_inner) f32 after softplus, B (B, S, N), C (B, S, N)), the
    projections in xc's dtype."""
    N, r, qm = cfg.ssm_state, cfg.resolved_dt_rank, cfg.quant_mode
    dbl = linear(p["x_proj"], xc, qm)                         # (B, S, r+2N)
    dt = linear(p["dt_proj_w"], dbl[..., :r], qm) + p["dt_proj_b"]
    return (_softplus(dt.to(torch.float32)), dbl[..., r:r + N],
            dbl[..., r + N:])


def _discretize(p, dt, xc, Bm):
    """dA = exp(dt A) and dBx = dt xc B, both (B, S, d_inner, N) f32."""
    A = -torch.exp(p["a_log"])                                # (di, N)
    dA = torch.exp(dt[..., None] * A)
    dBx = ((dt * xc.to(torch.float32))[..., None]
           * Bm.to(torch.float32)[:, :, None, :])
    return dA, dBx


def _ssm_inputs(p, xc, cfg):
    """The reference's pre-scan step over ``xc`` (B, S, d_inner): (dA, dBx
    (B, S, d_inner, N), C (B, S, N)), all f32."""
    dt, Bm, Cm = _project(p, xc, cfg)
    dA, dBx = _discretize(p, dt, xc, Bm)
    return dA, dBx, Cm.to(torch.float32)


def _selective_scan(p, dt, xc, Bm, Cm, h):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t xc_t B_t`` from ``h`` over the
    sequence, CHUNK positions at a time, and ``y_t = h_t . C_t``.
    Returns (y (B, S, d_inner) f32, the last h (B, d_inner, N))."""
    ys = []
    for c0 in range(0, dt.shape[1], CHUNK):
        c = slice(c0, c0 + CHUNK)
        dA, dBx = _discretize(p, dt[:, c], xc[:, c], Bm[:, c])
        hs, h = _scan(dA, dBx, h)
        ys.append((hs * Cm[:, c, None, :]).sum(-1))
        del dA, dBx, hs
    return (ys[0] if len(ys) == 1 else torch.cat(ys, 1)), h


def mamba_block(p, x, cfg, state=None):
    """The prefill block over x (B, S, d).  Returns (y, {"ssm": (B,
    d_inner, N) f32, "conv": (B, cw-1, d_inner) f32}): the last state and
    the last cw-1 rows of the conv's input (zeros before the first
    token).  ``state``: a carried {"ssm"} to start from (zeros if None)."""
    B = x.shape[0]
    di, cw, qm = cfg.d_inner, cfg.ssm_conv, cfg.quant_mode
    xz = linear(p["in_proj"], x, qm)
    xs, z = xz[..., :di], xz[..., di:]
    tail = xs[:, -(cw - 1):, :].to(torch.float32)
    if tail.shape[1] < cw - 1:
        tail = torch.cat([tail.new_zeros((B, cw - 1 - tail.shape[1], di)),
                          tail], 1)
    xc = F.silu(_conv_causal(p, xs, cw))                      # f32
    dt, Bm, Cm = _project(p, xc, cfg)
    h = (torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                     device=x.device) if state is None else state["ssm"])
    y, h = _selective_scan(p, dt, xc, Bm, Cm.to(torch.float32), h)
    y = (y + xc * p["d_skip"]).to(x.dtype) * F.silu(z)
    return linear(p["out_proj"], y, qm), {"ssm": h, "conv": tail}


def init_mamba_state(cfg, batch, device=None):
    """One mamba layer's decode state on ``device`` (CUDA unless the caller
    names another): zeros."""
    device = resolve_device(device)
    return {"ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=torch.float32, device=device)}


def mamba_decode_step(p, x, cfg, state):
    """One-token update, x (B, 1, d).  Returns (y, new state); ``state``
    is not written."""
    di, qm = cfg.d_inner, cfg.quant_mode
    xz = linear(p["in_proj"], x, qm)
    xs, z = xz[..., :di], xz[..., di:]                        # (B, 1, di)
    conv_buf = torch.cat([state["conv"], xs.to(torch.float32)], 1)
    xc = F.silu((conv_buf * p["conv1d_w"]).sum(1) + p["conv1d_b"])
    dA, dBx, Cm = _ssm_inputs(p, xc[:, None, :].to(x.dtype), cfg)
    h = state["ssm"] * dA[:, 0] + dBx[:, 0]                   # (B, di, N)
    y = (h * Cm[:, 0, None, :]).sum(-1)
    y = (y + xc * p["d_skip"]).to(x.dtype)
    y = y[:, None, :] * F.silu(z)
    return linear(p["out_proj"], y, qm), {"ssm": h, "conv": conv_buf[:, 1:]}
