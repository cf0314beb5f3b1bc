"""Mixture-of-Experts FFN: top-k router, capacity-based dispatch, per-expert
SwiGLU, load-balancing auxiliary loss.

The JAX package's batch-local slot-loop design, step for step: routing
metadata is (B, S)-shaped and every sort runs per row.  For each top-k slot
j in turn, a stable per-row argsort of the slot's expert ids ranks each
token within its expert group; its position is that rank plus the
per-expert occupancy of the earlier slots, and past the per-row capacity
``C = max(ceil(k * S * cf / E), 1)`` (S the padded length) the token
drops to the sentinel slot ``E * C``.  All slots index one (B, E, C, d)
buffer, one batched expert GEMM runs, and each slot gathers its results
back weighted by its gate.

PSI expert weights dequantize whole, through bf16 as in the JAX package
(even for a float32 activation), and the expert GEMMs are plain batched
products: the reference has no kernel for them.  Every op has a fixed
shape and no host sync, so the decode and verify CUDA graphs capture it.

On a serving mesh's model axis the layer's params carry a
``runtime.parallel.ExpertShard`` under "shard": the router runs
replicated over the same rows on every rank (slots, keeps and C are the
single process's), each rank runs its experts (or its columns of every
expert) on the dispatch buffer, and the shard joins the outputs before
the combine.  On a training mesh they carry "batch_sum"
(``runtime.fsdp.BatchSum``): the load-balancing loss's two means are
then taken over every rank's rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import psi, quantizer
from repro_torch.quant.linear import maybe_fake_quant


def param_specs(cfg, pre: str):
    """(path, shape, std) of one layer's MoE leaves under ``pre``, at the
    JAX init's scales: the router (d, E) and the expert blocks
    ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return [(f"{pre}/router", (d, E), d ** -0.5),
            (f"{pre}/w_gate", (E, d, f), d ** -0.5),
            (f"{pre}/w_up", (E, d, f), d ** -0.5),
            (f"{pre}/w_down", (E, f, d), f ** -0.5)]


def _dequantize_bf16(leaf: psi.QuantizedTensor) -> torch.Tensor:
    """codes * scale in f32, rounded once to bf16: ``leaf.dequantize()``.
    On the card one elementwise pass (no f32 block in between: the three
    passes of the plain form through a 2.4 GB temporary per full-width
    qwen3-moe layer); on the CPU the plain form, which vectorizes.  The
    two are bit-equal."""
    if not leaf.data.is_cuda:
        return leaf.dequantize(torch.bfloat16)
    out = torch.empty(leaf.shape, dtype=torch.bfloat16,
                      device=leaf.data.device)
    return torch.mul(leaf.codes, leaf.scale, out=out)


def _expert_weights(leaf, dtype, quant_mode="none"):
    """One expert block in ``dtype``: a PSI leaf dequantizes through bf16
    (the JAX package's default dequantize dtype, then the cast), a float
    leaf is cast as it is, fake-quantized first under a ``qatN`` mode
    (per expert and output channel, as a linear weight)."""
    if isinstance(leaf, psi.QuantizedTensor):
        return _dequantize_bf16(leaf).to(dtype)
    return maybe_fake_quant(leaf, quant_mode, (leaf.dim() - 2,)).to(dtype)


def _expert_bmm(a, w):
    """(E, T, K) @ (E, K, N) with f32 products and sums: bf16 operands on
    the card through ``out_dtype`` (no upcast copy of the block), anything
    else upcast to f32 (so is a product autograd records: ``out_dtype``
    has no derivative; a bf16 product is exact in f32 either way)."""
    if (a.is_cuda and a.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or w.requires_grad))):
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


def _row_ranks(eidx_slot: torch.Tensor, E: int) -> torch.Tensor:
    """Per-row rank of each token within its expert group, in position
    order: eidx_slot (B, S) -> ranks (B, S) int64.  Sorts along S only."""
    B, S = eidx_slot.shape
    e = eidx_slot.to(torch.int64)
    order = torch.argsort(e, dim=1, stable=True)
    sorted_e = torch.gather(e, 1, order)
    experts = torch.arange(E, dtype=torch.int64,
                           device=e.device).expand(B, E).contiguous()
    first = torch.searchsorted(sorted_e, experts)             # (B, E)
    rank_sorted = (torch.arange(S, device=e.device)[None]
                   - torch.gather(first, 1, sorted_e))
    return torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)


def route(p, x, cfg, capacity_override=None):
    """The router and the slot assignment of ``x`` (B, S, d).

    Returns (gate (B, S, k) f32, slots (B, k, S) int64 — ``e * C + pos``,
    or the sentinel ``E * C`` for a dropped token — keep (B, k, S) bool,
    aux scalar f32, C)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    router = quantizer.dequantize(p["router"], torch.float32)
    logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    # a stable descending sort: on ties the lower expert id comes first,
    # as jax.lax.top_k orders them (torch.topk promises no order)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch/GShard): global means
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), dtype=torch.float32,
                                        device=x.device))
    batch_sum = p.get("batch_sum")
    if batch_sum is None:
        me = probs.mean(dim=(0, 1))
        ce = counts / (B * S * k)
    else:
        # a training mesh's rows: the sums over every rank's rows (one
        # all-reduce under autograd), then the global means
        sums, n = batch_sum(torch.stack([probs.sum(dim=(0, 1)), counts]),
                            B * S)
        me, ce = sums[0] / n, sums[1] / (n * k)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    C = capacity_override or max(
        int(math.ceil(k * S * cfg.capacity_factor / E)), 1)
    occupancy = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    ones = torch.ones((B, S), dtype=torch.int64, device=x.device)
    slots, keeps = [], []
    for j in range(k):
        ej = eidx[:, :, j]                                    # (B, S)
        pos = _row_ranks(ej, E) + torch.gather(occupancy, 1, ej)
        keep = pos < C
        slots.append(torch.where(keep, ej * C + pos,
                                 torch.full_like(pos, E * C)))
        keeps.append(keep)
        occupancy = torch.clamp_max(occupancy.scatter_add(1, ej, ones), C)
    return gate, torch.stack(slots, 1), torch.stack(keeps, 1), aux, C


def moe_ffn(p, x, cfg, capacity_override=None):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gate, slots, keep, aux, C = route(p, x, cfg, capacity_override)

    # dispatch: an index-only scatter builds each row's inverse map slot ->
    # token (E*C + 1 entries, S = empty), then one gather of the rows; only
    # the discarded sentinel entry takes duplicate writes
    inv = torch.full((B, E * C + 1), S, dtype=torch.int64, device=x.device)
    tok = torch.arange(S, dtype=torch.int64, device=x.device).expand(B, S)
    for j in range(k):
        inv.scatter_(1, slots[:, j], tok)
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)     # empty -> 0
    xe = torch.gather(x_pad, 1, inv[:, :-1, None].expand(B, E * C, d))
    xe = xe.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    shard = p.get("shard")
    if shard is not None:
        xe = shard.local(xe)

    # the expert GEMMs, each block dequantized just before its product
    qm = cfg.quant_mode
    g = _expert_bmm(xe, _expert_weights(p["w_gate"], x.dtype, qm))
    u = _expert_bmm(xe, _expert_weights(p["w_up"], x.dtype, qm))
    h = (F.silu(g) * u).to(x.dtype)
    del g, u
    ye = _expert_bmm(h, _expert_weights(p["w_down"], x.dtype, qm))
    ye = ye.to(x.dtype) if shard is None else shard.join(ye, x.dtype)
    ye = ye.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)

    # combine: per-slot gathers weighted by the gate, summed in slot order
    # in x's dtype
    gk = (gate.transpose(1, 2) * keep).to(x.dtype)            # (B, k, S)
    idx = torch.clamp_max(slots, E * C - 1)
    y = torch.zeros_like(x)
    for j in range(k):
        got = torch.gather(ye, 1, idx[:, j, :, None].expand(B, S, d))
        y = y + got * gk[:, j, :, None]
    return y, aux
