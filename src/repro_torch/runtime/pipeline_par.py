"""GPipe pipeline parallelism over a "stage" axis of a ``torch.distributed``
mesh.

The layers split into S contiguous stages: stage s holds layers [s L/S,
(s + 1) L/S) of the layer-stacked params (``P(stage_axis, None, ...)``,
cut by ``sharding.local_shard``: no replication).  The schedule has M +
S - 1 ticks.  At tick t stage s runs microbatch t - s when it is one of
the M (stage 0 takes it from the input, the others from the activation
stage s - 1 sent at tick t - 1), sends the result on to stage s + 1, and
the last stage keeps microbatch t - (S - 1): S - 1 warm-up and S - 1
cool-down ticks, the GPipe efficiency M / (M + S - 1).  Each tick's sends
and receives are posted together (``isend`` / ``irecv``) and then waited
on, so no pairing can deadlock.  A stage outside its window idles (the
bubble) where the JAX package's SPMD program computes on zeros that no
tick emits; the results are the same.  Every rank returns every
microbatch's output: the last stage broadcasts them over the stage axis
(the JAX package sums the zero-filled emissions with ``psum``).

With one stage it is the plain layer loop and issues no collective (NCCL
gives a card one rank, so one card can only run S = 1, and a rank does
not send to itself).  Sends, receives and broadcasts add to
``runtime.parallel.collective_counts()``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.runtime import parallel
from repro_torch.runtime import sharding as shr


def _run_stage(layer_fn, p_stage, x):
    for j in range(tree_leaves(p_stage)[0].shape[0]):
        x = layer_fn(tree_map(lambda a: a[j], p_stage), x)
    return x


def pipeline_apply(layer_fn, params_stacked, x_microbatches, mesh,
                   stage_axis: str = "stage"):
    """``y = layer_fn(p_layer, x)`` through every layer, pipelined over the
    ``stage_axis`` of ``mesh`` (a ``launch.mesh.make_mesh`` mesh, or any
    mesh with ``stage_axis`` of size 1).

    params_stacked: a tree (nested dicts / lists) of tensors with leading
      dim L = S x layers per stage, the whole stack on every rank (each
      keeps its stage's layers);
    x_microbatches: (M, mb, ...) on every rank; ``layer_fn`` keeps the
      shape of a microbatch.
    Returns the (M, mb, ...) outputs on every rank."""
    S = int(shr.mesh_axes(mesh)[stage_axis])
    M = x_microbatches.shape[0]
    L = tree_leaves(params_stacked)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not split over {S} stages")
    if S == 1:
        return torch.stack([_run_stage(layer_fn, params_stacked, x)
                            for x in x_microbatches])
    import torch.distributed as dist
    coord = shr.mesh_coordinate(mesh)
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    s = coord[stage_axis]
    group = mesh.get_group(stage_axis)
    coords = shr.mesh_coords(mesh)
    ranks = sorted(dist.get_process_group_ranks(group),   # by stage index
                   key=lambda r: coords[r][stage_axis])
    p_stage = tree_map(
        lambda a: shr.local_shard(a, shr.P(stage_axis), mesh, coord),
        params_stacked)
    ys = torch.zeros_like(x_microbatches)
    buf = torch.empty_like(x_microbatches[0])
    for t in range(M + S - 1):
        i = t - s
        reqs = []
        if 0 <= i < M:
            h = _run_stage(layer_fn, p_stage,
                           x_microbatches[i] if s == 0 else buf)
            if h.shape != buf.shape:
                raise ValueError(f"layer_fn changed a microbatch's shape "
                                 f"{tuple(buf.shape)} -> {tuple(h.shape)}")
            if s == S - 1:
                ys[i] = h
            else:
                reqs.append(dist.isend(h.contiguous(), ranks[s + 1]))
                parallel.add_collectives({"send": 1})
        if s > 0 and 0 <= i + 1 < M:          # stage s - 1 sends at tick t
            buf = torch.empty_like(buf)
            reqs.append(dist.irecv(buf, ranks[s - 1]))
            parallel.add_collectives({"recv": 1})
        for r in reqs:
            r.wait()
    dist.broadcast(ys, src=ranks[S - 1], group=group)
    parallel.add_collectives({"broadcast": 1})
    return ys


def pipeline_bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
