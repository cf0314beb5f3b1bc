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
  projection (``wo``, ``w_down``) and after the vocab-parallel embedding,
  and an all-gather of the vocab-parallel logits and of a K/V projection
  whose columns cut a head (MQA).

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
        """The config of this rank's share of the model: its query heads,
        KV heads and FFN channels (the head width pinned)."""
        if not self.tp:
            return cfg
        m = self.tp_size
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"tensor-parallel execution of the {cfg.family!r} family is "
                f"not ported yet (ROADMAP queue 1, item 4: TP/EP for MoE, "
                f"hybrid, SSM and encoder-decoder); serve it on a mesh with "
                f"a model axis of 1")
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        bad = [f"{n}={v}" for n, v in (("n_heads", hq), ("d_ff", cfg.d_ff),
                                       ("vocab_size", cfg.vocab_size))
               if v % m]
        if hkv % m and hkv != 1:
            bad.append(f"n_kv_heads={hkv} (neither a multiple of the model "
                       f"axis nor 1)")
        if bad:
            raise NotImplementedError(
                f"tensor parallelism over model={m} needs "
                f"{', '.join(bad)} to split {m} ways")
        return dataclasses.replace(
            cfg, n_heads=hq // m, n_kv_heads=hkv // m if hkv % m == 0 else 1,
            d_ff=cfg.d_ff // m, head_dim=cfg.resolved_head_dim)

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
            if name == "embed":
                if split_dim(spec) != "K":          # (V, d): rows split
                    raise NotImplementedError("the embed table must split "
                                              "over model")
                return TPEmbed(leaf, self.tp_rank * leaf.shape[0], g)
            want = {"wq": "N", "w_gate": "N", "w_up": "N", "wo": "K",
                    "w_down": "K", "lm_head": "N", "wk": "N", "wv": "N"}
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
        return out
