"""Parameters from the JAX package's layout into the port's.

The input is a neutral numpy tree with the JAX package's structure::

    {"embed": leaf, "lm_head": leaf, "norm_f": {"scale": array},
     "stack": {"groups": {"b0_attn": {...}}, "tail": []}}

where every array is a numpy array and every quantized weight is a dict
``{"data", "scale", "bits", "packed"}``.  Leaves under ``stack/groups``
carry a leading layer axis L (a quantized GEMM weight's scale is
``(L, 1, N)``).  The port keeps one dict per layer instead, so layers are
unstacked here; nothing is re-quantized — codes, planes and scales are
copied bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import psi


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
    layer with ``norm1``, ``attn``, ``norm2``, ``mlp`` — ``norm_f`` and,
    when untied, ``lm_head``) on ``device`` (CUDA unless the caller names
    another)."""
    device = resolve_device(device)
    stack = tree["stack"]
    if stack.get("tail"):
        raise ValueError("the port serves pure attention stacks; this tree "
                         "has tail blocks")
    groups = stack["groups"]
    if list(groups) != ["b0_attn"]:
        raise ValueError(f"expected one 'b0_attn' group, got {list(groups)}")
    g = groups["b0_attn"]
    out = {
        "embed": _to_torch(tree["embed"], device),
        "layers": [_to_torch(g, device, index=i)
                   for i in range(_n_layers(g))],
        "norm_f": _to_torch(tree["norm_f"], device),
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], device)
    return out
