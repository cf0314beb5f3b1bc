"""Partition rules: map every parameter / batch / cache leaf of the port to
a partition spec over a serving or training mesh.

Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod ("pod" joins "data" as an outer data-parallel / FSDP axis).

Serving: weights tensor-parallel over "model", replicated over data; the
batch over "data".  Training: FSDP — the non-TP weight dim is also split
over the data axes; optimizer moments take the param spec.

Rules are *logical*: a rule names the spec of the trailing (weight) dims,
and leading dims replicate.  A :class:`~repro_torch.core.psi.QuantizedTensor`
leaf (codes or bit-planes + scale) derives its spec from the same rule and
gets a QuantizedTensor *of specs* back.  The rule tables and every spec
function are the JAX package's, as pure logic over a mesh's axis names and
sizes: a ``torch.distributed.device_mesh.DeviceMesh``, an :class:`AxisMesh`
(no process group needed), or any object with ``axis_names`` and a
``shape`` mapping.  The port keeps one dict per layer where the JAX package
stacks layers, so a port leaf's spec is the JAX leaf's without the leading
replicated layer dim.

Specs are :class:`P`, a tuple normalized as JAX's ``PartitionSpec`` is (an
entry of one axis is that axis' name, an empty one None).

The JAX package's ``to_shardings`` and ``constrain_block_cache`` have no
counterpart here: PyTorch has no SPMD partitioner to hand shardings to.
Instead :func:`local_shard` cuts each leaf to the contiguous chunk the spec
gives this rank's mesh coordinates (GSPMD's layout, the one
:func:`slot_shard_map` and :func:`block_shard_map` promise), the executor
places params, cache and step inputs that way, and each rank computes on
its own rows and heads, so a masked cache write lands in the local shard
by construction.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.psi import QuantizedTensor
from repro_torch.models.kvcache import KVCache

DP_AXES = ("pod", "data")        # outer batch axes when present

# Models narrower than this gain nothing from 16-way tensor parallelism —
# per-shard GEMMs degenerate and every layer pays two all-reduces.  Below
# the threshold the "model" axis is repurposed as extra data parallelism
# and weights replicate (whisper-base: 70 MB).
TP_MIN_D_MODEL = 1024


class P(tuple):
    """A partition spec: one entry per dim, each None (replicated), an
    axis name, or a tuple of axis names (the dim split over their
    product).  Normalized like JAX's ``PartitionSpec``: a one-axis tuple is
    that axis' name and an empty tuple None."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class AxisMesh:
    """A mesh as axis names and sizes only: what the spec functions read,
    with no process group behind it (the counterpart of JAX's
    ``AbstractMesh``)."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()) or [1]))

    def __repr__(self):
        return f"AxisMesh({tuple(self.shape.values())}, {self.axis_names})"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                             # a DeviceMesh
        return dict(zip(names, (int(s) for s in tuple(mesh.shape))))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def tp_enabled(cfg) -> bool:
    return cfg.d_model >= TP_MIN_D_MODEL


def _dp(mesh, cfg=None) -> Tuple:
    """Data-parallel axes present in this mesh (flattened for batch dim).
    When TP is disabled for this arch, "model" joins the batch axes."""
    names = tuple(mesh_axes(mesh))
    axes = tuple(a for a in DP_AXES if a in names)
    if cfg is not None and not tp_enabled(cfg) and "model" in names:
        axes = axes + ("model",)
    return axes


def _divisible(n: int, mesh, axes) -> bool:
    if not axes:
        return False
    shape = mesh_axes(mesh)
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= shape[a]
    return n % size == 0


def _pick_batch_axes(B: int, mesh, dp):
    """Largest prefix of the data-parallel axes that divides the batch/slot
    dim ``B`` (falls back to any single axis, then replication).  One shared
    decision for batch inputs, decode-slot tensors, and the KV cache, so they
    stay co-sharded."""
    if _divisible(B, mesh, dp):
        return dp
    for k in range(len(dp) - 1, 0, -1):
        if _divisible(B, mesh, dp[:k]):
            return dp[:k]
    shape = mesh_axes(mesh)
    return next((a for a in dp if B % shape[a] == 0), None)


def batch_axes(cfg, mesh, B: int) -> Tuple[str, ...]:
    """The axes the slot/batch dim ``B`` of serving tensors splits over,
    as a tuple (empty: replicated)."""
    bax = _pick_batch_axes(B, mesh, _dp(mesh, cfg))
    if bax is None:
        return ()
    return bax if isinstance(bax, tuple) else (bax,)


def batch_shard_count(cfg, mesh, B: int) -> int:
    """How many ways the slot/batch dim of serving tensors splits on this
    mesh — the number of per-shard slot pools the scheduler partitions over
    (1 on a single-device mesh: the no-op path)."""
    shape = mesh_axes(mesh)
    return int(np.prod([shape[a] for a in batch_axes(cfg, mesh, B)]))


def slot_shard_map(cfg, mesh, n_slots: int) -> np.ndarray:
    """slot -> data-shard index under GSPMD's contiguous-chunk layout for a
    ``(n_slots, ...)`` leaf sharded over the data axes (shard i holds slots
    [i*n/d, (i+1)*n/d)).  The mesh-aware SlotAllocator uses this to admit
    into per-shard free slots."""
    d = batch_shard_count(cfg, mesh, n_slots)
    return (np.arange(n_slots) * d) // n_slots


def block_shard_map(cfg, mesh, n_total: int,
                    n_usable: int = None) -> np.ndarray:
    """block id -> data-shard index for a paged pool whose leading dim is
    ``n_total`` blocks (``n_blocks`` usable + per-slot scratch — the WHOLE
    dim is what is chunked over the data axes, so the map is computed
    against it).  Returns the map truncated to the ``n_usable`` allocatable
    ids the scheduler's BlockAllocator partitions over."""
    d = batch_shard_count(cfg, mesh, n_total)
    full = (np.arange(n_total) * d) // n_total
    return full[:n_usable if n_usable is not None else n_total]


# ---------------------------------------------------------------------------
# Logical rules: (path regex) -> trailing-dims spec.  "model" is TP and
# "fsdp" a placeholder for the data axes in training mode / None in serving.
# ---------------------------------------------------------------------------
_RULES = (
    # embeddings: vocab over model (model-parallel logits); d replicated
    (r"(^|/)embed$",        ("model", None)),
    (r"(^|/)lm_head$",      (None, "model")),
    # attention
    (r"(^|/)wq$",           ("fsdp", "model")),
    (r"(^|/)wk$",           ("fsdp", "model")),
    (r"(^|/)wv$",           ("fsdp", "model")),
    (r"(^|/)wo$",           ("model", "fsdp")),
    # dense mlp
    (r"(^|/)w_gate$",       ("fsdp", "model")),   # moe experts override below
    (r"(^|/)w_up$",         ("fsdp", "model")),
    (r"(^|/)w_down$",       ("model", "fsdp")),
    # rg-lru
    (r"(^|/)w_in_rec$",     ("fsdp", "model")),
    (r"(^|/)w_in_gate$",    ("fsdp", "model")),
    (r"(^|/)rglru_wa$",     ("fsdp", "model")),
    (r"(^|/)rglru_wx$",     ("fsdp", "model")),
    (r"(^|/)rglru_(ba|bx|lambda)$", ("model",)),
    (r"(^|/)w_out$",        ("model", "fsdp")),
    # mamba
    (r"(^|/)in_proj$",      ("fsdp", "model")),
    (r"(^|/)x_proj$",       ("model", "fsdp")),
    (r"(^|/)dt_proj_w$",    ("fsdp", "model")),
    (r"(^|/)dt_proj_b$",    ("model",)),
    (r"(^|/)out_proj$",     ("model", "fsdp")),
    (r"(^|/)a_log$",        ("model", None)),
    (r"(^|/)d_skip$",       ("model",)),
    (r"(^|/)conv1d_w$",     (None, "model")),
    (r"(^|/)conv1d_b$",     ("model",)),
    # moe router
    (r"(^|/)router$",       ("fsdp", None)),
)

_MOE_EP = {  # experts divide the model axis: expert parallelism
    r"(^|/)w_gate$": ("model", "fsdp", None),
    r"(^|/)w_up$":   ("model", "fsdp", None),
    r"(^|/)w_down$": ("model", None, "fsdp"),
}
_MOE_TP = {  # tensor parallelism inside each expert
    r"(^|/)w_gate$": (None, "fsdp", "model"),
    r"(^|/)w_up$":   (None, "fsdp", "model"),
    r"(^|/)w_down$": (None, "model", "fsdp"),
}


def _is_qt(x) -> bool:
    return isinstance(x, QuantizedTensor)


def map_tree(fn, tree, *rest, path: Tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict / list tree (a
    QuantizedTensor is one leaf); ``rest`` are structure-equal trees."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [map_tree(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _logical_spec(path: str, cfg, mesh) -> Optional[Tuple]:
    if cfg.n_experts and re.search(r"moe/", path):
        table = (_MOE_EP if _divisible(cfg.n_experts, mesh, "model")
                 else _MOE_TP)
        for pat, spec in table.items():
            if re.search(pat, path):
                return spec
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return None                       # norms, misc small params -> replicate


def _materialize(spec_tail, leaf_shape, mesh, mode: str,
                 use_tp: bool = True) -> P:
    """Map a logical trailing spec onto a concrete leaf shape; leading dims
    (layer stacks) replicate.  'fsdp' resolves to the data axes in train
    mode, None otherwise.  Axes that don't divide the dim are dropped."""
    shape = mesh_axes(mesh)
    fsdp = (tuple(a for a in DP_AXES if a in shape) if mode == "train"
            else None)
    tail = []
    for dim, ax in zip(leaf_shape[-len(spec_tail):], spec_tail):
        if ax == "model" and not use_tp:
            ax = None
        if ax == "fsdp":
            ax = fsdp
        if ax is None:
            tail.append(None)
            continue
        if not _divisible(dim, mesh, ax):
            # fall back: try a single axis out of a tuple, else replicate
            if isinstance(ax, tuple):
                ax = next((a for a in ax if dim % shape[a] == 0), None)
                tail.append(ax)
            else:
                tail.append(None)
            continue
        tail.append(ax)
    lead = [None] * (len(leaf_shape) - len(spec_tail))
    return P(*(lead + tail))


def _spec_for_qt(leaf: QuantizedTensor, spec_tail, mesh, mode: str,
                 use_tp: bool = True) -> QuantizedTensor:
    """QuantizedTensor leaf: unpacked codes keep the weight spec; packed
    planes prepend a replicated bit-plane dim; scale shards only its
    non-singleton dims.  Returns a QuantizedTensor *of specs* (same format
    metadata), structure-equal to the leaf."""
    data_tail = ((None,) + tuple(spec_tail)) if leaf.packed else spec_tail
    data = _materialize(data_tail, tuple(leaf.data.shape), mesh, mode,
                        use_tp)
    sc = tuple(leaf.scale.shape)
    sc_tail = [ax if sc[-len(spec_tail) + i] > 1 else None
               for i, ax in enumerate(spec_tail)]
    scale = _materialize(tuple(sc_tail), sc, mesh, mode, use_tp)
    return QuantizedTensor(data, scale, leaf.fmt, leaf.packed)


def leaf_spec(path: str, leaf, cfg, mesh, mode: str = "serve"):
    """The spec of one param leaf at ``path`` ("layers/0/attn/wq")."""
    use_tp = tp_enabled(cfg)
    spec_tail = _logical_spec(path, cfg, mesh) if use_tp else None
    if _is_qt(leaf):
        if spec_tail is None:
            return QuantizedTensor(P(), P(), leaf.fmt, leaf.packed)
        return _spec_for_qt(leaf, spec_tail, mesh, mode, use_tp)
    if spec_tail is None or leaf.dim() < len(spec_tail):
        return P()
    return _materialize(spec_tail, tuple(leaf.shape), mesh, mode, use_tp)


def param_specs(params, cfg, mesh, mode: str = "serve"):
    """Spec tree matching ``params`` (plain or PSI-quantized).  A model
    narrower than ``TP_MIN_D_MODEL`` replicates everything: the mesh axes
    all become batch parallelism."""
    return map_tree(lambda path, leaf: leaf_spec(_path_str(path), leaf, cfg,
                                                 mesh, mode), params)


def batch_specs(cfg, mesh, batch_tree, seq_shard: bool = False):
    """Input batch: batch dim over the data axes (replicated if indivisible,
    e.g. long_500k's batch=1).  When TP is off for this arch, "model" joins
    the batch axes; if the batch still can't use it, the token sequence dim
    is sharded over "model" instead (sequence parallelism)."""
    dp = _dp(mesh, cfg)
    shape = mesh_axes(mesh)
    free_model = (not tp_enabled(cfg)) and "model" in shape

    def one(path, leaf):
        name = _path_str(path)
        if leaf.dim() == 0:
            return P()
        B = leaf.shape[0]
        bax = _pick_batch_axes(B, mesh, dp)
        spec = [bax] + [None] * (leaf.dim() - 1)
        used = set(bax if isinstance(bax, tuple) else (bax,) if bax else ())
        if name == "tokens" and leaf.dim() >= 2:
            S = leaf.shape[1]
            if free_model and "model" not in used and S % shape["model"] == 0:
                spec[1] = "model"           # sequence parallelism
            elif seq_shard and bax is None and _divisible(S, mesh, "data"):
                spec[1] = "data"
        return P(*spec)

    return map_tree(one, batch_tree)


def _kv_layout(cfg, mesh, B, C, Hkv):
    """(batch_ax, seq_ax, head_ax) for KV cache tensors — one decision
    shared by k, v, and k_pos so masks stay co-sharded with values."""
    shape = mesh_axes(mesh)
    bax = _pick_batch_axes(B, mesh, _dp(mesh, cfg))
    used = set(bax if isinstance(bax, tuple) else (bax,) if bax else ())
    use_tp = tp_enabled(cfg)
    head_ax = "model" if (use_tp and Hkv % shape["model"] == 0) else None
    seq_ax = None
    if head_ax is None:
        # heads unshardable (MQA/GQA < TP degree): shard the KV ring dim
        # over whichever axis is free — "model" first, then "data"
        cand = ("model", "data") if "model" in shape else ("data",)
        for a in cand:
            if a not in used and C % shape[a] == 0:
                seq_ax = a
                break
    return bax, seq_ax, head_ax


def _serve_leaf_spec(cfg, mesh, name: str, shape, paged=False) -> P:
    """Spec for one layer's cache leaf (batch/slot dim on axis 0).
    Leaf shapes (dense layout):
      attn k/v:   (B, C, Hkv, hd)   k/v_scale: (B, C, Hkv, 1)
      k_pos:      (B, C)
      mamba ssm:  (B, di, N)   conv: (B, cw-1, di)
      rglru h:    (B, dr)      conv: (B, cw-1, dr)
      enc_out:    (B, F, d)
    Paged layout (``paged=True``): pool leaves (N_total, bs, Hkv, hd) /
    scale (N_total, bs, Hkv, 1) — the BLOCK dim over the data axes (the
    allocator follows ``block_shard_map``), heads over "model" when
    divisible, the in-block position dim replicated.
    """
    axes = mesh_axes(mesh)
    use_tp = tp_enabled(cfg)
    B = shape[0]
    spec = [None] * len(shape)
    spec[0] = _pick_batch_axes(B, mesh, _dp(mesh, cfg))
    if paged:
        if (len(shape) == 4 and use_tp
                and shape[2] % axes.get("model", 1) == 0):
            spec[2] = "model"
        return P(*spec)
    if name.endswith("enc_out"):
        return P(*spec)
    if re.search(r"(^|/)k$|(^|/)v$|k_scale$|v_scale$", name) and len(shape) == 4:
        spec[0], spec[1], spec[2] = _kv_layout(cfg, mesh, B, shape[1],
                                               max(cfg.n_kv_heads, 1))
        if shape[2] % axes.get("model", 1) != 0 and spec[2]:
            spec[2] = None
    elif re.search(r"k_pos", name) and len(shape) == 2:
        # same layout decision as k/v (real kv-head count matters)
        spec[0], spec[1], _ = _kv_layout(cfg, mesh, B, shape[1],
                                         max(cfg.n_kv_heads, 1))
    elif re.search(r"ssm$", name) and len(shape) == 3:
        if use_tp and _divisible(shape[1], mesh, "model"):
            spec[1] = "model"
    elif re.search(r"conv$", name) and len(shape) == 3:
        if use_tp and _divisible(shape[2], mesh, "model"):
            spec[2] = "model"
    elif re.search(r"(^|/)h$", name) and len(shape) == 2:
        if use_tp and _divisible(shape[1], mesh, "model"):
            spec[1] = "model"
    return P(*spec)


def cache_specs(cfg, mesh, cache_tree, seq_shard: bool = False):
    """Decode cache: batch/slot (or paged block-pool) dim over the data
    axes; KV seq (ring) dim over a free axis when the heads cannot split;
    mamba/rg-lru channel state over "model"; KV heads over "model" only
    when divisible.  A :class:`KVCache` gives a KVCache *of specs* back (its
    ``kv`` one spec dict a layer); a bare list of layer dicts gives the
    dense rules' specs."""
    if isinstance(cache_tree, KVCache):
        kv = _kv_tree_specs(cfg, mesh, cache_tree.kv, cache_tree.paged)
        enc = (None if cache_tree.enc_out is None else _serve_leaf_spec(
            cfg, mesh, "enc_out", tuple(cache_tree.enc_out.shape)))
        return KVCache(kv, cache_tree.layout, cache_tree.block_size,
                       cache_tree.n_blocks, enc_out=enc)
    return _kv_tree_specs(cfg, mesh, cache_tree, paged=False)


def _kv_tree_specs(cfg, mesh, kv_tree, paged: bool):
    def one(path, leaf):
        if leaf.dim() == 0:
            return P()
        return _serve_leaf_spec(cfg, mesh, _path_str(path),
                                tuple(leaf.shape), paged)

    return map_tree(one, kv_tree)


def block_cache_specs(cfg, mesh, block_tree, paged: bool = False):
    """Specs for one layer's cache dict (the rules of
    :func:`cache_specs`, leaf by leaf)."""
    return _kv_tree_specs(cfg, mesh, block_tree, paged)


def serve_batch_specs(cfg, mesh, batch_tree):
    """Decode-step inputs (token (B, 1), pos (B, 1) / positions (B, 3, 1),
    active (B,)): slot dim over the data axes, everything else replicated —
    co-sharded with the slot dim of the decode cache."""
    def one(path, leaf):
        if leaf.dim() == 0:
            return P()
        bax = _pick_batch_axes(leaf.shape[0], mesh, _dp(mesh, cfg))
        return P(bax, *([None] * (leaf.dim() - 1)))

    return map_tree(one, batch_tree)


def decode_carry_specs(cfg, mesh, carry_tree):
    """Specs for the multi-step decode carry (token / pos / active /
    remaining).  The carry chains rounds on the device, so its layout MUST
    equal the decode-step inputs' leaf for leaf: the rule is exactly
    :func:`serve_batch_specs`, named so the invariant is an API."""
    return serve_batch_specs(cfg, mesh, carry_tree)


# ---------------------------------------------------------------------------
# Placement: a rank's chunk of a leaf.
# ---------------------------------------------------------------------------
def mesh_coordinate(mesh) -> Optional[Dict[str, int]]:
    """This rank's coordinate on ``mesh`` by axis name (None when the
    rank is not in the mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    return dict(zip(mesh_axes(mesh), (int(c) for c in coord)))


def mesh_coords(mesh) -> Dict[int, Dict[str, int]]:
    """Global rank -> its coordinate on ``mesh`` (axis name -> index), for
    every rank of the mesh."""
    grid = np.asarray(mesh.mesh.tolist())
    names = tuple(mesh_axes(mesh))
    return {int(grid[idx]): dict(zip(names, (int(i) for i in idx)))
            for idx in np.ndindex(grid.shape)}


def shard_index(mesh, axes, coord: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of the chunk a rank at ``coord`` holds of a dim split
    over ``axes`` (None, one name or a tuple of names): the row-major index
    of its coordinates over those axes, as GSPMD lays a dim out."""
    if axes is None:
        return 0, 1
    shape = mesh_axes(mesh)
    idx, n = 0, 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        idx = idx * shape[a] + coord[a]
        n *= shape[a]
    return idx, n


def local_shard(tensor, spec, mesh, coord: Optional[Dict[str, int]] = None):
    """The contiguous chunk of ``tensor`` that ``spec`` gives the rank at
    ``coord`` (default this rank's coordinate on ``mesh``): dim i is cut
    into as many equal chunks as its axes' sizes multiply to, and the
    rank keeps chunk :func:`shard_index`.  A QuantizedTensor takes a
    QuantizedTensor of specs and cuts its data and scale.  The chunk is
    contiguous (the kernels read it so): a copy only where a split dim is
    not the leading one."""
    if coord is None:
        coord = mesh_coordinate(mesh)
        if coord is None:
            raise ValueError("this rank is not in the mesh")
    if _is_qt(tensor):
        return QuantizedTensor(local_shard(tensor.data, spec.data, mesh,
                                           coord),
                               local_shard(tensor.scale, spec.scale, mesh,
                                           coord),
                               tensor.fmt, tensor.packed)
    out = tensor
    for dim, axes in enumerate(spec):
        i, n = shard_index(mesh, axes, coord)
        if n == 1:
            continue
        size = tensor.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split {n} ways ({spec})")
        c = size // n
        out = out.narrow(dim, i * c, c)
    return out.contiguous()


# ---------------------------------------------------------------------------
# Serving placement: the layout a rank computes on.
# ---------------------------------------------------------------------------
def placement_spec(path: str, leaf, cfg, mesh):
    """:func:`leaf_spec` in serve mode, except where the port's execution
    needs another cut of the same bytes.  A packed expert block's planes (E, bits, K/8,
    N) get the replicated bit-plane dim just before its (K, N):
    ``_spec_for_qt`` (the JAX package's rule) puts it in front of every
    dim, which for a stacked leaf shifts the expert spec onto the planes
    (GSPMD computes any layout; the port's experts and kernels read the
    experts' own dims)."""
    spec = leaf_spec(path, leaf, cfg, mesh)
    if not (_is_qt(leaf) and leaf.packed and leaf.data.dim() > 3
            and tp_enabled(cfg)):
        return spec
    tail = _logical_spec(path, cfg, mesh)
    if tail is None:
        return spec
    tail = tuple(tail)
    data = _materialize(tail[:-2] + (None,) + tail[-2:],
                        tuple(leaf.data.shape), mesh, "serve")
    return QuantizedTensor(data, spec.scale, leaf.fmt, leaf.packed)


def _is_in_proj(path: str) -> bool:
    return re.search(r"(^|/)in_proj$", path) is not None


def _halves_shard(t, spec, mesh, coord):
    """The SSM ``in_proj`` reslice: the last dim is two halves (x, z) of
    ``d_inner`` channels each, and the rank whose chunk of that dim would
    be ``i`` of ``n`` takes channels [i di/n, (i+1) di/n) of both halves
    (the block splits its output in half; a contiguous chunk would give
    one rank all of x and another all of z).  Other dims cut as
    :func:`local_shard` cuts them."""
    i, n = shard_index(mesh, spec[-1], coord)
    t = local_shard(t, P(*tuple(spec)[:-1], None), mesh, coord)
    if n == 1:
        return t
    h = t.shape[-1] // 2
    if t.shape[-1] % 2 or h % n:
        raise ValueError(f"in_proj's {t.shape[-1]} columns do not split as "
                         f"two halves {n} ways")
    c = h // n
    return torch.cat([t[..., i * c:(i + 1) * c],
                      t[..., h + i * c:h + (i + 1) * c]], dim=-1)


def _own(t):
    """``t`` in storage of its own: a chunk that is a view of the whole
    leaf would keep the whole leaf alive."""
    if t.device.type == "meta":
        return t
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def place_leaf(path: str, leaf, spec, mesh, coord, mode: str = "serve"):
    """This rank's chunk of one leaf under its :func:`placement_spec`: the
    :func:`local_shard` cut, but for a serving SSM's ``in_proj``, which is
    resliced by channel (:func:`_halves_shard`).  The chunk holds no
    reference to the whole leaf."""
    cut = (_halves_shard if mode == "serve" and _is_in_proj(path)
           else local_shard)
    if _is_qt(leaf):
        return QuantizedTensor(_own(cut(leaf.data, spec.data, mesh, coord)),
                               _own(cut(leaf.scale, spec.scale, mesh, coord)),
                               leaf.fmt, leaf.packed)
    return _own(cut(leaf, spec, mesh, coord))


class LeafPlacer:
    """A rank's share of a param tree, one leaf at a time: ``place(path,
    leaf)`` gives the chunk :func:`place_leaf` cuts at ``coord`` (default
    this rank's) on ``mesh`` in ``mode`` ("serve" or "train").  A model's
    rank-local init hands it each leaf as it is drawn."""

    def __init__(self, cfg, mesh, coord=None, mode: str = "serve"):
        if mode not in ("serve", "train"):
            raise ValueError(f"unknown mode {mode!r}")
        if coord is None:
            coord = mesh_coordinate(mesh)
            if coord is None:
                raise ValueError("this rank is not in the mesh")
        self.cfg, self.mesh, self.coord, self.mode = cfg, mesh, coord, mode

    def spec(self, path: str, leaf):
        if self.mode == "train":
            return leaf_spec(path, leaf, self.cfg, self.mesh, "train")
        return placement_spec(path, leaf, self.cfg, self.mesh)

    def place(self, path: str, leaf):
        if not isinstance(leaf, (torch.Tensor, QuantizedTensor)):
            return leaf
        return place_leaf(path, leaf, self.spec(path, leaf), self.mesh,
                          self.coord, self.mode)

    def specs(self, tree):
        """The spec tree of a global tree (meta tensors do)."""
        return map_tree(lambda path, leaf: self.spec(_path_str(path), leaf),
                        tree)

    def place_tree(self, tree):
        return map_tree(lambda path, leaf: self.place(_path_str(path), leaf),
                        tree)


def local_shard_tree(tree, specs, mesh, coord=None):
    """:func:`local_shard` over structure-equal trees of leaves and
    specs."""
    if coord is None:
        coord = mesh_coordinate(mesh)
    return map_tree(lambda path, leaf, spec: local_shard(leaf, spec, mesh,
                                                         coord),
                    tree, specs)
