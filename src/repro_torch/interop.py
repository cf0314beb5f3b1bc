"""Parameters from the JAX package's layout into the port's.

The input is a neutral numpy tree with the JAX package's structure::

    {"embed": leaf, "lm_head": leaf, "norm_f": {"scale": array},
     "stack": {"groups": {"b0_attn": {...}}, "tail": []}}

(the hybrid's groups are ``b0_rec``, ``b1_rec``, ``b2_attn`` and its tail
a list of unstacked blocks; the SSM's one group is ``b0_mamba``,
whisper's ``b0_xattn``, and whisper adds ``"encoder"``, one stacked dict of
blocks with a leading axis of ``n_enc_layers``, and ``"enc_norm_f"``)
where every array is a numpy array and every
quantized weight is a dict ``{"data", "scale", "bits", "packed"}``.
Leaves under ``stack/groups`` carry a leading group axis (a quantized
GEMM weight's scale is ``(L, 1, N)``).  The port keeps one dict per layer instead, so layers are
unstacked here; nothing is re-quantized — codes, planes and scales are
copied bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import psi
from repro_torch.optim.adamw import AdamWState


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"data", "scale", "bits",
                                              "packed"}


def _to_torch(x, device, index=None):
    if _is_qleaf(x):
        data, scale = np.asarray(x["data"]), np.asarray(x["scale"])
        if index is not None:
            data, scale = data[index], scale[index]
        return psi.QuantizedTensor(
            torch.from_numpy(np.array(data, copy=True)).to(device),
            torch.from_numpy(np.array(scale, np.float32, copy=True)
                             ).to(device),
            psi.get_format(int(x["bits"])), bool(x["packed"]))
    if isinstance(x, dict):
        return {k: _to_torch(v, device, index) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v, device, index) for v in x]
    a = np.asarray(x)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _n_layers(groups) -> int:
    for v in groups.values():
        if _is_qleaf(v):
            return int(np.asarray(v["data"]).shape[0])
        if isinstance(v, dict):
            n = _n_layers(v)
            if n:
                return n
        else:
            return int(np.asarray(v).shape[0])
    return 0


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's parameter structure (``embed``, ``layers`` — one dict per
    layer with ``norm1``, ``attn``, ``rec`` or ``mamba``, ``norm_x`` and
    ``xattn`` (whisper), ``norm2``, ``mlp`` or ``moe`` — ``norm_f``, when
    untied ``lm_head``, and whisper's ``encoder`` (one dict per layer) and
    ``enc_norm_f``) on ``device``
    (CUDA unless the caller names another).  The JAX stack's scanned
    groups (``b0_attn``, or the hybrid's ``b0_rec``, ``b1_rec``,
    ``b2_attn``: each a leading axis of groups) unstack group by group,
    each group's blocks in order, and its unrolled ``tail`` blocks follow:
    the order of ``transformer.layer_kinds``.  A ``moe`` subtree's stacked
    expert leaves ((L, E, d, f) codes, (L, E, bits, d/8, f) planes,
    (L, E, 1, f) scales) unstack like any other.  Float leaves (norm
    scales and biases, the mamba block's ``conv1d_*``, ``dt_proj_b``,
    ``a_log`` and ``d_skip``) are copied as they are."""
    device = resolve_device(device)
    stack = tree["stack"]
    groups = stack["groups"]
    names = sorted(groups, key=lambda n: int(n.split("_")[0][1:]))
    if [n.split("_")[0] for n in names] != [f"b{i}"
                                           for i in range(len(names))]:
        raise ValueError(f"expected groups b0_<kind>, b1_<kind>, ..., got "
                         f"{list(groups)}")
    n_groups = _n_layers(groups[names[0]])
    out = {
        "embed": _to_torch(tree["embed"], device),
        "layers": ([_to_torch(groups[n], device, index=g)
                    for g in range(n_groups) for n in names]
                   + [_to_torch(t, device) for t in stack.get("tail", [])]),
        "norm_f": _to_torch(tree["norm_f"], device),
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = [_to_torch(enc, device, index=i)
                          for i in range(_n_layers(enc))]
        out["enc_norm_f"] = _to_torch(tree["enc_norm_f"], device)
    return out


def opt_state_from_numpy(tree: Dict[str, Any], device=None) -> AdamWState:
    """An AdamW state in the JAX package's layout — {"step", "m", "v"},
    the moments trees of the params' structure (stacked groups) — as the
    port's :class:`~repro_torch.optim.AdamWState`: the moments unstack as
    :func:`params_from_numpy` unstacks the params, so each moment leaf
    sits beside its parameter."""
    # a 0-d array is written with shape (1,) (np.ascontiguousarray)
    return AdamWState(step=int(np.asarray(tree["step"]).reshape(-1)[0]),
                      m=params_from_numpy(tree["m"], device),
                      v=params_from_numpy(tree["v"], device))


def cnn_params_from_numpy(tree: Dict[str, Any], device=None
                          ) -> Dict[str, Any]:
    """A CNN's params (``models.cnn``: the same tree in both packages,
    ``convk`` HWIO and ``w`` (in, out)) on ``device`` (CUDA unless the
    caller names another), copied as they are; quantized leaves
    (``{"data", "scale", "bits", "packed"}``) become QuantizedTensors."""
    return _to_torch(tree, resolve_device(device))
