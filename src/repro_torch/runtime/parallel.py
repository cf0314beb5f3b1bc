"""This rank's share of a serving mesh: which slots, pool blocks and heads
it holds, the collectives that join the ranks, and the tensor-parallel
weight leaves.

The port serves SPMD: every rank runs the same ``Server`` loop over the
same trace and takes the same host decisions; each computes only the rows
of its own slot shard (data parallelism) and, with tensor parallelism, only
its own heads and FFN channels.  The collectives:

* a (B,) token all-gather after every decode step, round, prefill and
  speculative pass (``gather``), through the mesh's group, so every rank's
  scheduler sees every slot's token (a rank with no rows still takes
  part);
* a broadcast of rank 0's clock at every loop iteration when the mesh has
  more than one rank (``agree_time``), so arrivals are admitted at the same
  iteration everywhere;
* inside the model, with TP: an all-reduce after each row-parallel
  projection (``wo``, ``w_down``; a mamba layer's ``x_proj`` and
  ``out_proj``) and after the vocab-parallel embedding, and an all-gather
  of the vocab-parallel logits and of a K/V projection whose columns cut
  a head (MQA); in an MoE layer an all-gather of the experts' outputs
  (expert parallelism) or an all-reduce of their partial sums (tensor
  parallelism inside each expert): see :class:`ExpertShard`.

Sharded training (``runtime/fsdp.py``) adds reduce-scatters and the
pipeline (``runtime/pipeline_par.py``) sends and receives.  Every
collective issued adds one to its count (``collective_counts``); a
CUDA-graph replay adds the counts its capture recorded, as the kernels'
launch counts do.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import sharding as shr

_COUNTS = {"all_gather": 0, "all_reduce": 0, "broadcast": 0,
           "reduce_scatter": 0, "send": 0, "recv": 0}


def collective_counts() -> dict:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def add_collectives(counts: dict) -> None:
    for k, n in counts.items():
        _COUNTS[k] += n


def _dist():
    import torch.distributed as dist
    return dist


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` of the group, in group-rank order."""
    dist = _dist()
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather(out, t, group=group)
    _COUNTS["all_gather"] += 1
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place."""
    _dist().all_reduce(t, group=group)
    _COUNTS["all_reduce"] += 1
    return t


def reduce_scatter(out: torch.Tensor, chunks: list, group) -> torch.Tensor:
    """``out`` = the sum over the group's ranks of their ``chunks[i]``,
    ``i`` this rank's place in the group (``chunks`` in group-rank
    order)."""
    _dist().reduce_scatter(out, [c.contiguous() for c in chunks],
                           group=group)
    _COUNTS["reduce_scatter"] += 1
    return out


class TPLinear:
    """A tensor-parallel weight leaf: this rank's shard ``w`` of a (K, N)
    matrix and how its product joins the other ranks' over the model
    group.  ``linear`` dispatches on ``tp_linear``.

    * "column": N split; the local columns are the output (no collective);
    * "gather": N split; the columns are all-gathered into the whole N
      (vocab-parallel logits, a K/V projection that cuts a head);
    * "row": K split; the partial sums are all-reduced (the order of the
      sum changes, so results match the single process to a tolerance)."""

    def __init__(self, w, kind: str, group):
        if kind not in ("column", "gather", "row"):
            raise ValueError(f"unknown TP kind {kind!r}")
        self.w, self.kind, self.group = w, kind, group

    def tp_linear(self, x, quant_mode="none"):
        from repro_torch.quant import linear
        y = linear(self.w, x, quant_mode)
        if self.kind == "row":
            return all_reduce_(y, self.group)
        if self.kind == "gather":
            return torch.cat(all_gather(y, self.group), dim=-1)
        return y


class TPEmbed:
    """A vocab-parallel embedding table: this rank holds rows [v0, v0 +
    V/m); an id outside them gives a zero row, and the rows are summed over
    the model group (one non-zero term each: exact)."""

    def __init__(self, table, v0: int, group):
        self.table, self.v0, self.group = table, int(v0), group

    def tp_embed(self, ids, dtype):
        from repro_torch.quant import embed
        n = self.table.shape[0]
        ids = ids.long()
        mine = (ids >= self.v0) & (ids < self.v0 + n)
        rows = embed(self.table, torch.where(mine, ids - self.v0,
                                             torch.zeros_like(ids)), dtype)
        rows = rows.masked_fill(~mine[..., None], 0)
        return all_reduce_(rows, self.group)


class ExpertShard:
    """How this rank's expert blocks join the model group's (an MoE layer's
    params carry it under "shard"; ``moe.moe_ffn`` reads it).

    * "ep" (the experts divide the model axis): this rank holds experts
      [rank E/m, (rank+1) E/m) whole, runs their rows of the dispatch
      buffer only, and the outputs of all experts are all-gathered in the
      activation dtype, so the combine sums them in the single process's
      order;
    * "tp" (they do not): every expert's d_ff columns are split (w_gate and
      w_up by column, w_down by row); each rank runs every expert's rows
      on its columns and the partial down-projections are all-reduced in
      f32 before the cast."""

    def __init__(self, kind: str, group, rank: int, size: int):
        if kind not in ("ep", "tp"):
            raise ValueError(f"unknown expert sharding {kind!r}")
        self.kind, self.group = kind, group
        self.rank, self.size = int(rank), int(size)

    def local(self, xe: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the (E, T, d) dispatch buffer."""
        if self.kind == "tp":
            return xe
        n = xe.shape[0] // self.size
        return xe[self.rank * n:(self.rank + 1) * n]

    def join(self, ye: torch.Tensor, dtype) -> torch.Tensor:
        """Every expert's whole output (E, T, d) in ``dtype`` from this
        rank's f32 ``ye``."""
        if self.kind == "ep":
            return torch.cat(all_gather(ye.to(dtype), self.group), dim=0)
        return all_reduce_(ye, self.group).to(dtype)


@dataclasses.dataclass(frozen=True)
class ShardConfig(ModelConfig):
    """A rank's share of a config whose SSM channels split over "model":
    ``d_inner`` is the rank's channel count (the state, the conv and the
    projections follow it); every other field is the global config's."""
    local_d_inner: int = 0

    @property
    def d_inner(self) -> int:
        return self.local_d_inner or self.ssm_expand * self.d_model


def tp_local_config(cfg, m: int):
    """The config of one rank's share of ``cfg`` tensor-parallel over a
    model axis of ``m``: its query heads, KV heads and FFN channels (the
    head width pinned); for MoE the heads only (the experts and the
    routing stay global: ``ExpertShard`` holds the split); for the SSM
    its ``d_inner`` channels (:class:`ShardConfig`)."""
    if m == 1:
        return cfg
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "tensor-parallel execution of the hybrid family is not ported "
            "yet (ROADMAP queue 1, item 5: its attention is MQA on the "
            "dense SWA ring, whose sequence dim then splits over \"model\", "
            "and its RG-LRU channels go with it); serve it on a mesh with a "
            "model axis of 1")
    if cfg.family not in ("dense", "vlm", "moe", "ssm"):
        raise NotImplementedError(
            f"tensor-parallel execution of the {cfg.family!r} family is not "
            f"ported (ROADMAP queue 1, item 4: its one config is narrower "
            f"than TP_MIN_D_MODEL, so it serves data-parallel); serve it on "
            f"a mesh with a model axis of 1")
    bad = [f"vocab_size={cfg.vocab_size}"] if cfg.vocab_size % m else []
    if cfg.family == "ssm":
        if cfg.d_inner % m:
            bad.append(f"d_inner={cfg.d_inner}")
        if bad:
            raise NotImplementedError(
                f"tensor parallelism over model={m} needs "
                f"{', '.join(bad)} to split {m} ways")
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(ModelConfig)}
        return ShardConfig(**fields, local_d_inner=cfg.d_inner // m)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % m:
        bad.append(f"n_heads={hq}")
    if hkv % m and hkv != 1:
        bad.append(f"n_kv_heads={hkv} (neither a multiple of the model axis "
                   f"nor 1)")
    if cfg.family == "moe":
        if cfg.n_experts % m and cfg.d_ff % m:
            bad.append(f"n_experts={cfg.n_experts} or d_ff={cfg.d_ff}")
    elif cfg.d_ff % m:
        bad.append(f"d_ff={cfg.d_ff}")
    if bad:
        raise NotImplementedError(
            f"tensor parallelism over model={m} needs "
            f"{', '.join(bad)} to split {m} ways")
    return dataclasses.replace(
        cfg, n_heads=hq // m, n_kv_heads=hkv // m if hkv % m == 0 else 1,
        d_ff=cfg.d_ff if cfg.family == "moe" else cfg.d_ff // m,
        head_dim=cfg.resolved_head_dim)


class MeshShare:
    """This rank's share of a serving mesh for an executor of ``max_batch``
    slots (and, paged, ``n_blocks`` usable pool blocks).

    Slots split over :func:`sharding.batch_axes` in contiguous chunks
    (``slot_shards``); the rank holds chunk ``shard``: rows [row0, row0 +
    local_batch).  A paged pool's ``n_blocks + max_batch`` blocks split the
    same way (``block_shards``), and the rank holds blocks [block0, block0
    + chunk) and ``local_batch`` scratch blocks of its own after them (the
    pool's global scratch ids are never allocated); the allocator keeps a
    slot's blocks on its shard, so a rank's rows read and write only its
    own blocks.  Ranks that differ only on axes the slots do not use hold
    the same rows (tensor parallelism, or replicas)."""

    def __init__(self, cfg, mesh, max_batch: int, n_blocks=None):
        self.mesh = mesh
        self.axes = shr.mesh_axes(mesh)
        self.size = int(np.prod(list(self.axes.values())))
        self.coord = shr.mesh_coordinate(mesh)
        if self.coord is None:
            raise ValueError("this rank is not in the mesh (a hot spare)")
        B = max_batch
        self.bax = shr.batch_axes(cfg, mesh, B)
        self.n_slot_shards = shr.batch_shard_count(cfg, mesh, B)
        self.slot_shards = shr.slot_shard_map(cfg, mesh, B)
        dp_extent = int(np.prod([self.axes[a] for a in shr.DP_AXES
                                 if a in self.axes] or [1]))
        if self.n_slot_shards < dp_extent:
            raise ValueError(
                f"max_batch={B} does not divide the mesh's {dp_extent}-way "
                f"data parallelism; decode slots would shard only "
                f"{self.n_slot_shards}-way (rest of the data axis idles and "
                f"the cache replicates across it).  Pick max_batch a "
                f"multiple of the data-axis extent.")
        self.shard, _ = shr.shard_index(mesh, self.bax or None, self.coord)
        self.local_batch = B // self.n_slot_shards
        self.row0 = self.shard * self.local_batch
        self.n_block_shards, self.block_shards = 1, None
        self.block0, self.local_blocks = 0, n_blocks
        if n_blocks is not None:
            n_total = n_blocks + B
            self.n_block_shards = shr.batch_shard_count(cfg, mesh, n_total)
            self.block_shards = shr.block_shard_map(cfg, mesh, n_total,
                                                    n_blocks)
            if (self.n_block_shards != self.n_slot_shards
                    or shr.batch_axes(cfg, mesh, n_total) != self.bax):
                raise ValueError(
                    f"the paged pool's {n_total} blocks (n_blocks + "
                    f"max_batch) split {self.n_block_shards} ways but the "
                    f"slots {self.n_slot_shards} ways: a slot's blocks must "
                    f"live on its shard; pick n_blocks so that n_blocks + "
                    f"max_batch splits over the mesh like max_batch")
            if self.n_block_shards > 1:
                self.local_blocks = n_total // self.n_block_shards
                self.block0 = self.shard * self.local_blocks
        # the ranks of the mesh in row-major order; the position of the
        # first rank of each slot shard picks its rows out of a gather
        grid = mesh.mesh.reshape(-1).tolist()
        self.ranks = [int(r) for r in grid]
        shape = tuple(self.axes.values())
        first = {}
        for p in range(len(self.ranks)):
            c = dict(zip(self.axes, np.unravel_index(p, shape)))
            first.setdefault(shr.shard_index(mesh, self.bax or None, c)[0],
                             p)
        self.rep = [first[i] for i in range(self.n_slot_shards)]
        # the groups over all the mesh's ranks, which every rank of the
        # process group made with the mesh: a group made by only some
        # ranks would desynchronize torch's group bookkeeping
        if not hasattr(mesh, "flat_group"):
            raise ValueError("build the mesh with launch.mesh.make_mesh")
        self.group = mesh.flat_group
        # rank 0's clock travels on the host (gloo); None on one rank
        self.host_group = mesh.host_group
        m = self.axes.get("model", 1)
        self.tp = shr.tp_enabled(cfg) and m > 1
        self.tp_size = m if self.tp else 1
        self.tp_rank = self.coord.get("model", 0) if self.tp else 0
        self.tp_group = mesh.get_group("model") if self.tp else None

    # ------------------------------------------------------------- rows
    def owns(self, slot: int) -> bool:
        return int(self.slot_shards[int(slot)]) == self.shard

    def local_rows(self, a: np.ndarray) -> np.ndarray:
        return a[self.row0:self.row0 + self.local_batch]

    def local_block_ids(self, ids) -> np.ndarray:
        """Global block ids -> this rank's pool ids (-1 stays -1)."""
        ids = np.asarray(ids)
        loc = np.where(ids >= 0, ids - self.block0, -1).astype(np.int32)
        if ((ids >= 0) & ((loc < 0) | (loc >= self.local_blocks))).any():
            raise ValueError(f"block ids {ids.tolist()} are not all on "
                             f"shard {self.shard}")
        return loc

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every slot shard's rows of ``t`` (this rank's along ``dim``),
        concatenated in slot order."""
        parts = all_gather(t, self.group)
        return torch.cat([parts[p] for p in self.rep], dim=dim)

    def agree_time(self, t: float) -> float:
        """Rank 0's ``t`` on every rank of the mesh."""
        if self.host_group is None:
            return t
        buf = torch.tensor([t], dtype=torch.float64)
        _dist().broadcast(buf, src=self.ranks[0], group=self.host_group)
        _COUNTS["broadcast"] += 1
        return float(buf[0])

    # ---------------------------------------------------- tensor parallel
    def local_cfg(self, cfg):
        """The config of this rank's share of the model
        (:func:`tp_local_config` over the model axis)."""
        return tp_local_config(cfg, self.tp_size) if self.tp else cfg

    def wrap_tp(self, cfg, params, specs):
        """The local param tree with its TP leaves wrapped: column-parallel
        wq / w_gate / w_up (and wk / wv when the KV heads split), row-
        parallel wo / w_down, a vocab-parallel embed, gathered logits
        (lm_head, a tied head) and, for MQA, a gathered K/V projection."""
        if not self.tp:
            return params
        m, g = self.tp_size, self.tp_group
        kv_split = cfg.n_kv_heads % m == 0

        def split_dim(spec):
            data = spec.data if isinstance(spec, shr.QuantizedTensor) \
                else spec
            # the weight's (K, N) are the last two dims of codes and
            # planes alike
            k, n = data[-2], data[-1]
            return "K" if k == "model" else "N" if n == "model" else None

        def one(path, leaf, spec):
            name = str(path[-1])
            if "moe" in path:
                # the expert blocks are local as they stand (their
                # ExpertShard below joins them); the router replicates
                return leaf
            if name == "embed":
                if split_dim(spec) != "K":          # (V, d): rows split
                    raise NotImplementedError("the embed table must split "
                                              "over model")
                return TPEmbed(leaf, self.tp_rank * leaf.shape[0], g)
            want = {"wq": "N", "w_gate": "N", "w_up": "N", "wo": "K",
                    "w_down": "K", "lm_head": "N", "wk": "N", "wv": "N",
                    # mamba: in_proj column-parallel over its resliced
                    # channels, x_proj and out_proj row-parallel, dt_proj
                    # column-parallel (two all-reduces a layer)
                    "in_proj": "N", "x_proj": "K", "dt_proj_w": "N",
                    "out_proj": "K"}
            if name not in want:
                return leaf
            got = split_dim(spec)
            if name in ("wk", "wv") and not kv_split:
                # MQA: the one KV head's columns are cut (or replicated):
                # every rank needs the whole head
                return TPLinear(leaf, "gather", g) if got == "N" else leaf
            if got != want[name]:
                raise NotImplementedError(
                    f"{'/'.join(map(str, path))}: spec {spec} does not "
                    f"split the {want[name]} dim over model")
            kind = {"K": "row", "N": "column"}[got]
            if name == "lm_head":
                kind = "gather"
            return TPLinear(leaf, kind, g)

        out = shr.map_tree(one, {k: v for k, v in params.items()
                                 if k != "tied_head"}, specs)
        if cfg.tie_embeddings:
            # the logits of the local rows of the table, gathered: the
            # (D, V/m) head ``Model.serving_params`` built from them
            if "tied_head" not in params:
                raise NotImplementedError("a tied float table under tensor "
                                          "parallelism: quantize it first")
            out["tied_head"] = TPLinear(params["tied_head"], "gather", g)
        if cfg.family == "moe":
            kind = "ep" if cfg.n_experts % m == 0 else "tp"
            for layer in out["layers"]:
                layer["moe"] = dict(layer["moe"], shard=ExpertShard(
                    kind, g, self.tp_rank, m))
        return out
