"""Model-level PSI quantization: walk a parameter tree (nested dicts and
lists of tensors) and turn matmul weights and embedding tables into
:class:`~repro_torch.core.psi.QuantizedTensor` serving leaves.

Leaf selection, per-leaf mixed-precision policies, scale axes and pack rules
follow the JAX package's quantizer exactly, so the same float weights give
bit-equal codes, planes and scales in both packages.
"""
from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core import psi

WEIGHT_NAMES = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_out",
    "w_in_rec", "w_in_gate", "rglru_wa", "rglru_wx",
    "in_proj", "x_proj", "dt_proj_w", "out_proj",
    "embed", "lm_head", "convk", "w",
)
_INCLUDE_RE = re.compile(r"(^|/)(%s)$" % "|".join(WEIGHT_NAMES))

DEFAULT_EXCLUDE = (
    r"a_log",
    r"conv1d",
    r"norm",
    r"bias",
    r"router",
)

Policy = Mapping[str, Optional[int]]


def parse_quant_mode(mode: str) -> Tuple[Optional[str], Optional[int]]:
    """"none" -> (None, None); "qatN" -> ("qat", N); "psiN" -> ("psi", N)."""
    if mode in ("", "none", None):
        return None, None
    m = re.fullmatch(r"(qat|psi)(\d+)", mode)
    if not m:
        raise ValueError(f"unknown quant mode {mode!r} "
                         f"(expected none / qatN / psiN)")
    kind, bits = m.group(1), int(m.group(2))
    psi.get_format(bits)
    return kind, bits


def quant_mode_choices() -> Tuple[str, ...]:
    """Every valid quant mode: "none", then qatN and psiN for each
    registered width."""
    bits = psi.registered_bits()
    return (("none",) + tuple(f"qat{b}" for b in bits)
            + tuple(f"psi{b}" for b in bits))


def serving_mode_choices() -> Tuple[str, ...]:
    return ("none",) + tuple(f"psi{b}" for b in psi.registered_bits())


def parse_policy(spec: Union[str, Policy, None]
                 ) -> Optional[Dict[str, Optional[int]]]:
    """Normalize a mixed-precision policy: a mapping or the CLI string form
    "embed=8,w_down=4,default=5" (0 keeps a leaf in float)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        out: Dict[str, Optional[int]] = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            name, sep, val = item.partition("=")
            if not sep:
                raise ValueError(f"policy entry {item!r} is not name=bits")
            out[name.strip()] = int(val)
    else:
        out = dict(spec)
    for name, bits in out.items():
        if bits:
            psi.get_format(bits)
        if name == "default":
            continue
        try:
            re.compile(rf"(^|/)(?:{name})$")
        except re.error as e:
            raise ValueError(f"policy name {name!r} is not a valid leaf-name "
                             f"pattern ({e})") from None
    return out


def _policy_bits(path: str, policy, default):
    if policy:
        for name, bits in policy.items():
            if name == "default":
                continue
            if re.search(rf"(^|/)(?:{name})$", path):
                return bits
        if "default" in policy:
            return policy["default"]
    return default


def is_quantizable(path: str, leaf: Any, exclude=DEFAULT_EXCLUDE) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    if not leaf.is_floating_point():
        return False
    if not _INCLUDE_RE.search(path):
        return False
    return not any(re.search(p, path) for p in exclude)


def _scale_axis(path: str, leaf) -> tuple:
    if re.search(r"embed", path):
        return (leaf.dim() - 1,)           # per-row (per-token) scales
    if re.search(r"convk", path):
        return tuple(range(leaf.dim() - 1))
    return (leaf.dim() - 2,)               # contraction dim only


def quantize_leaf(path: str, leaf: torch.Tensor, bits: Optional[int],
                  pack: bool = False, policy=None):
    """Serving form of one leaf: a QuantizedTensor, or the leaf unchanged
    when it is not quantizable or its resolved width is 0/None."""
    leaf_bits = _policy_bits(path, policy, bits)
    if not leaf_bits:
        return leaf
    q = psi.quantize_weights(leaf, leaf_bits, axis=_scale_axis(path, leaf))
    if (pack and q.fmt.sub_byte and leaf.shape[-2] % 8 == 0
            and not re.search(r"embed", path)):
        return q.pack()
    return q


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_leaves(tree):
    """The leaves of a nested dict / list tree, in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (nested dicts and lists of the same structure);
    ``is_leaf`` stops the descent at a node it accepts."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def quantize_param_tree(params: Dict, bits: Optional[int] = None,
                        pack: bool = False, exclude: Optional[tuple] = None,
                        policy: Union[str, Policy, None] = None) -> Dict:
    """New tree whose quantizable leaves are QuantizedTensors (uniform
    ``bits`` and/or a per-leaf ``policy``; ``pack`` bit-plane packs
    sub-byte leaves whose contraction dim is a multiple of 8, embeddings
    excepted)."""
    exclude = DEFAULT_EXCLUDE if exclude is None else exclude
    policy = parse_policy(policy)
    if bits is None and not policy:
        raise ValueError("pass uniform bits= and/or a mixed-precision policy=")
    paths, qpaths = [], []

    def convert(path, leaf):
        paths.append(path)
        if not is_quantizable(path, leaf, exclude):
            return leaf
        qpaths.append(path)
        return quantize_leaf(path, leaf, bits, pack, policy)

    out = _walk(params, convert)
    if policy:
        def hit(key, pool):
            return any(re.search(rf"(^|/)(?:{key})$", p) for p in pool)

        dead = [k for k in policy if k != "default" and not hit(k, paths)]
        ineffective = [k for k in policy
                       if k != "default" and policy[k] and k not in dead
                       and not hit(k, qpaths)]
        if dead:
            warnings.warn(f"quantization policy entries matched no parameter "
                          f"leaf: {sorted(dead)} (known weight names: "
                          f"{WEIGHT_NAMES})", stacklevel=2)
        if ineffective:
            warnings.warn(f"quantization policy entries match only excluded/"
                          f"non-quantizable leaves and have no effect: "
                          f"{sorted(ineffective)} (see DEFAULT_EXCLUDE)",
                          stacklevel=2)
    return out


def draft_param_tree(params: Dict, draft_bits: int) -> Dict:
    """The self-speculative draft tree: every QuantizedTensor wider than
    ``draft_bits`` becomes its :meth:`~psi.QuantizedTensor.draft_view`
    (from the stored codes, no float round trip); float leaves and leaves
    at or below the draft width pass through, so the tree keeps its
    structure."""
    fmt = psi.get_format(draft_bits)

    def convert(_path, leaf):
        if isinstance(leaf, psi.QuantizedTensor) and leaf.fmt.bits > fmt.bits:
            return leaf.draft_view(fmt)
        return leaf

    return _walk(params, convert)


def dequantize(leaf: Any, dtype=torch.bfloat16):
    """The one shared dequantize: a QuantizedTensor leaf expanded to a
    dense ``dtype`` tensor (codes * scale in f32, then the cast); any other
    leaf passes through."""
    if isinstance(leaf, psi.QuantizedTensor):
        return leaf.dequantize(dtype)
    return leaf


dequantize_leaf = dequantize


def fake_quant_leaf(path: str, leaf: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """Quantize then dequantize one quantizable leaf in its own dtype, with
    the scale axis :func:`quantize_leaf` uses (the forward half of QAT)."""
    q = psi.quantize_weights(leaf, bits, axis=_scale_axis(path, leaf))
    return q.dequantize(leaf.dtype)


def fake_quant_param_tree(params: Dict, bits: int,
                          exclude: Optional[tuple] = None) -> Dict:
    """QAT forward transform: quantize-dequantize every quantizable leaf
    with a straight-through gradient (:func:`psi.fake_quant_ste`), so the
    gradient of a loss taken through the result flows to the float
    leaves unchanged."""
    exclude = DEFAULT_EXCLUDE if exclude is None else exclude

    def convert(path, leaf):
        if not is_quantizable(path, leaf, exclude):
            return leaf
        return psi.fake_quant_ste(leaf, bits, _scale_axis(path, leaf))

    return _walk(params, convert)


def quantized_bytes(params: Dict) -> int:
    """Total serving-format bytes: codes or planes plus scales, and float
    leaves at their own width."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, psi.QuantizedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
