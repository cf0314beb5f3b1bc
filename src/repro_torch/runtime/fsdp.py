"""Sharded training on a ``torch.distributed`` mesh: the port's stand-in
for GSPMD's training partition, as :mod:`runtime.parallel` is for serving.

The JAX package compiles one train step with params, optimizer moments
and batch placed on ``param_specs(mode="train")`` / ``batch_specs`` and
lets GSPMD insert the collectives (``launch/dryrun.py``'s ``build_step``).
PyTorch has no partitioner, so this module does what that partition
does, FSDP-style:

* **Placement.** Every rank holds the chunk ``sharding.local_shard`` cuts
  of each param leaf (and of ``m`` and ``v``, which take the param's
  spec) and of the batch (``batch_specs``: rows over the data axes).
* **Gather on use.** :class:`GatherOnUse` all-gathers a leaf over the mesh
  axes its spec splits and writes each chunk where ``local_shard`` cut it
  (``shard_index`` order: the exact inverse); the model's plain ``loss``
  runs on whole leaves.  Its backward sums the gradient back to the
  rank's chunk: a reduce-scatter over those axes, then an all-reduce over
  the axes the chunk is replicated on (the ranks there saw other rows).
* **Gradient scale.** Each rank's ``Model.loss`` is the mean over its own
  rows.  Dividing it by the mesh size makes the summed gradient that of
  the global mean: a group of ranks that hold the same rows (tensor
  parallelism, or an axis ``_pick_batch_axes`` leaves unsplit) counts
  them once per member, and the mesh size holds that factor.
* **Clip norm.** One all-reduce of per-rank partial sums of squares; each
  element is counted once (a replicated chunk by the rank whose
  coordinates on the axes it is replicated over are all 0).
* **MoE.** Dispatch is per row (C from S), so a rank's rows route as
  they do in one process; only the load-balancing loss is global: the
  router's sums are all-reduced over the ranks whose rows differ
  (:class:`BatchSum`, handed to each MoE layer of the gathered params).
* **Ordering.** Every rank issues the same collectives in the same order:
  the gathers in tree order before the forward, the reductions in the
  autograd engine's order over an identical graph, then the norm and the
  loss.  A one-rank group's collectives are copies, so on a (1, 1) mesh
  the step is the single-process step bit for bit.

The mesh must come from ``launch.mesh.make_mesh`` (it makes the groups
over every set of axes, which every rank joins).  Collectives add to
``runtime.parallel.collective_counts()``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.psi import QuantizedTensor
from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.runtime import parallel
from repro_torch.runtime import sharding as shr

def _split_axes(spec, mesh) -> tuple:
    """The mesh axes a spec names, in the mesh's axis order."""
    named = set()
    for ax in spec:
        if ax is not None:
            named.update(ax if isinstance(ax, tuple) else (ax,))
    return tuple(a for a in shr.mesh_axes(mesh) if a in named)


def _group(mesh, axes):
    """The group of the ranks that share this rank's coordinates on every
    axis but ``axes`` (a non-empty tuple in mesh order)."""
    if len(axes) == len(shr.mesh_axes(mesh)):
        return mesh.flat_group
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh.axis_groups[axes]


def _members(group, coords) -> list:
    """The coordinates of a group's ranks, in group-rank order."""
    import torch.distributed as dist
    return [coords[r] for r in dist.get_process_group_ranks(group)]


def gather(t: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """The whole leaf from every rank's chunk ``t`` (no autograd): an
    all-gather over the axes ``spec`` splits, each chunk written where
    ``local_shard`` cut it.  A leaf ``spec`` does not split is ``t``."""
    axes = _split_axes(spec, mesh)
    if not axes:
        return t
    coords = coords or shr.mesh_coords(mesh)
    group = _group(mesh, axes)
    members = _members(group, coords)
    parts = parallel.all_gather(t, group)
    out = t.new_empty([t.shape[d] * shr.shard_index(mesh, ax, members[0])[1]
                       for d, ax in enumerate(spec)])
    for part, c in zip(parts, members):
        view = out
        for d, ax in enumerate(spec):
            i, n = shr.shard_index(mesh, ax, c)
            if n > 1:
                view = view.narrow(d, i * t.shape[d], t.shape[d])
        view.copy_(part)
    return out


def scatter_sum(g: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """This rank's chunk of the sum over every rank of ``g`` (each rank's
    gradient of a whole leaf): a reduce-scatter over the axes ``spec``
    splits, then an all-reduce over the others (the ranks that hold the
    same chunk)."""
    coords = coords or shr.mesh_coords(mesh)
    axes = _split_axes(spec, mesh)
    rest = tuple(a for a in shr.mesh_axes(mesh) if a not in axes)
    if axes:
        group = _group(mesh, axes)
        chunks = [shr.local_shard(g, spec, mesh, c)
                  for c in _members(group, coords)]
        out = torch.empty_like(chunks[0])
        parallel.reduce_scatter(out, chunks, group)
    else:
        out = g.contiguous().clone()
    if rest:
        parallel.all_reduce_(out, _group(mesh, rest))
    return out


class AllReduceSum(torch.autograd.Function):
    """``apply(t, group)``: the sum of ``t`` over the group; backward the
    sum of the incoming gradients over the group (every rank's output
    depends on every rank's ``t``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return parallel.all_reduce_(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return parallel.all_reduce_(g.contiguous().clone(), ctx.group), None


class BatchSum:
    """An MoE router's sums over the rows of every rank that holds rows of
    its own (the ranks of ``group``, ``n`` row shards): ``self(t,
    rows)`` -> (the sum of ``t`` over the group, under autograd; the
    global row count ``rows * n``).  The load-balancing loss ``w E sum(me
    ce)`` is a product of two means over the global batch, so each mean is
    taken over every rank's rows before the product (a mean of per-shard
    losses differs).  With the step's 1 / mesh-size scaling, the gradient
    that reaches each chunk is that of the global loss: every rank's aux
    is the same global value, and the backward all-reduce hands each rank
    the gradient of all of them."""

    def __init__(self, group, n: int):
        self.group, self.n = group, int(n)

    def __call__(self, t, rows: int):
        return AllReduceSum.apply(t, self.group), rows * self.n


class GatherOnUse(torch.autograd.Function):
    """``apply(chunk, spec, mesh, coords)``: the whole leaf
    (:func:`gather`); backward: :func:`scatter_sum` of its gradient."""

    @staticmethod
    def forward(ctx, chunk, spec, mesh, coords):
        ctx.spec, ctx.mesh, ctx.coords = spec, mesh, coords
        full = gather(chunk, spec, mesh, coords)
        return full.view_as(full) if full is chunk else full

    @staticmethod
    def backward(ctx, g):
        return scatter_sum(g, ctx.spec, ctx.mesh, ctx.coords), None, None, \
            None


def gather_tree(tree, specs, mesh):
    """The global tree of a structure-equal tree of chunks and specs (a
    QuantizedTensor's data and scale each gathered): collective, every
    rank of the mesh calls it.  For checkpoints and tests."""
    coords = shr.mesh_coords(mesh)

    def one(path, leaf, spec):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(gather(leaf.data, spec.data, mesh, coords),
                                   gather(leaf.scale, spec.scale, mesh,
                                          coords), leaf.fmt, leaf.packed)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return gather(leaf, spec, mesh, coords)

    return shr.map_tree(one, tree, specs)


class TrainShare:
    """This rank's share of a training mesh for the params of ``cfg``:
    the train-mode spec of every leaf of ``params`` (global shapes; meta
    tensors do), and the placement, gathers and reductions of the
    sharded step (:func:`launch.train.make_sharded_train_step`)."""

    def __init__(self, cfg, mesh, params):
        self.cfg, self.mesh = cfg, mesh
        self.coord = shr.mesh_coordinate(mesh)
        if self.coord is None:
            raise ValueError("this rank is not in the mesh (a hot spare)")
        if not hasattr(mesh, "flat_group"):
            raise ValueError("build the mesh with launch.mesh.make_mesh")
        self.axes = shr.mesh_axes(mesh)
        self.size = int(np.prod(list(self.axes.values())))
        self.coords = shr.mesh_coords(mesh)
        self.specs = shr.param_specs(params, cfg, mesh, mode="train")
        self._spec_leaves = tree_leaves(self.specs)
        self.row_axes = None            # set by local_batch

    # -------------------------------------------------------- placement
    def place(self, tree):
        """This rank's chunks of a tree shaped like the params (the params
        themselves, ``m``, ``v``)."""
        return shr.local_shard_tree(tree, self.specs, self.mesh, self.coord)

    def local_batch(self, batch):
        """This rank's rows of a global batch (``batch_specs``); a spec
        that splits a dim past the rows (sequence parallelism) is refused:
        the loss shifts its targets across the sequence."""
        specs = shr.batch_specs(self.cfg, self.mesh, batch)
        for name, spec in specs.items():
            if any(ax is not None for ax in tuple(spec)[1:]):
                raise NotImplementedError(
                    f"batch {name!r} spec {spec} splits the sequence: the "
                    f"sharded step takes rows over the data axes only")
        self.row_axes = _split_axes(shr.P(specs["tokens"][0]), self.mesh)
        return shr.local_shard_tree(batch, specs, self.mesh, self.coord)

    def batch_sum(self):
        """The :class:`BatchSum` over the ranks whose rows differ (the
        axes :meth:`local_batch` split the rows over), or None when every
        rank holds every row."""
        if self.row_axes is None:
            raise ValueError("cut the batch with local_batch first: the "
                             "MoE router's sums follow its row split")
        n = int(np.prod([self.axes[a] for a in self.row_axes] or [1]))
        if n == 1:
            return None
        return BatchSum(_group(self.mesh, self.row_axes), n)

    # ------------------------------------------------------ collectives
    def gather_params(self, local):
        """The whole params, each leaf gathered through
        :class:`GatherOnUse` (gradients flow back to ``local``)."""
        it = iter([GatherOnUse.apply(t, s, self.mesh, self.coords)
                   for t, s in zip(tree_leaves(local), self._spec_leaves)])
        return tree_map(lambda _: next(it), local)

    def gather_tree(self, tree):
        """The global tree of chunks shaped like the params (no autograd)."""
        return gather_tree(tree, self.specs, self.mesh)

    def _owns(self, spec) -> bool:
        axes = _split_axes(spec, self.mesh)
        return all(self.coord[a] == 0 for a in self.axes if a not in axes)

    def global_norm(self, grads) -> torch.Tensor:
        """The global gradient norm from the chunks: each rank's sum of
        squares over the chunks it owns (in tree order, f32, as
        ``adamw.global_norm`` sums), one all-reduce, the square root."""
        total = 0
        leaves = tree_leaves(grads)
        for g, spec in zip(leaves, self._spec_leaves):
            if self._owns(spec):
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        if not isinstance(total, torch.Tensor):
            total = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
        buf = total.reshape(1)
        parallel.all_reduce_(buf, self.mesh.flat_group)
        return torch.sqrt(buf[0])

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The global mean of a per-rank mean over its rows: the sum over
        the mesh of ``t / size``."""
        buf = (t.detach().to(torch.float32) / self.size).reshape(1)
        parallel.all_reduce_(buf, self.mesh.flat_group)
        return buf[0]
