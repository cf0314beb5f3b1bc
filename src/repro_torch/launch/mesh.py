"""Serving and training meshes over ``torch.distributed``.

The port runs SPMD: one process a rank, each on its own card (NCCL) or on
the CPU (gloo), joined by a process group that the caller initialises
(``torchrun``, or ``torch.distributed.init_process_group`` with a store).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the group's
ranks; importing this module touches no distributed state.

``make_production_mesh`` is a FUNCTION: (16, 16) = 256 cards a pod, data x
model; multi-pod adds the leading "pod" axis (2 pods = 512 cards).
"""
from __future__ import annotations

import itertools

import numpy as np


def _device_type() -> str:
    import torch
    import torch.distributed as dist
    backend = str(dist.get_backend()).lower()
    return "cuda" if ("nccl" in backend and torch.cuda.is_available()) \
        else "cpu"


def make_mesh(shape, axes, ranks=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` (default
    the first prod(shape) ranks of the initialised process group), laid out
    row-major, carrying ``flat_group`` (all its ranks) and ``host_group``
    (the same ranks over gloo).  Every rank of the group calls it, in the
    same order; a rank outside ``ranks`` gets a mesh whose
    ``get_coordinate()`` is None."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or init_process_group)")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) < n:
        raise ValueError(f"mesh {shape} needs {n} ranks, have {len(ranks)}")
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(shape)
    mesh = DeviceMesh(_device_type(), grid, mesh_dim_names=tuple(axes))
    # the groups the serving executor gathers tokens and agrees on the
    # clock through, over all the mesh's ranks (gloo for the host scalar),
    # made here where every rank of the process group takes part
    mesh.flat_group = dist.new_group(ranks[:n])
    mesh.host_group = None                # one rank: nothing to agree on
    if n > 1:
        mesh.host_group = (mesh.flat_group
                           if str(dist.get_backend()).lower() == "gloo"
                           else dist.new_group(ranks[:n], backend="gloo"))
    # the groups over two or more axes but not all of them (a 3-axis mesh's
    # ("pod", "data") and the like), which sharded training gathers and
    # reduces over: each rank keeps the group of ranks that share its
    # coordinates on the other axes (one axis: ``get_group``; all of them:
    # ``flat_group``)
    mesh.axis_groups = {}
    names = tuple(axes)
    for k in range(2, len(names)):
        for sub in itertools.combinations(range(len(names)), k):
            rest = [d for d in range(len(names)) if d not in sub]
            lines = grid.permute(*rest, *sub).reshape(
                -1, int(np.prod([shape[d] for d in sub])))
            for line in lines.tolist():
                g = dist.new_group(line)
                if dist.get_rank() in line:
                    mesh.axis_groups[tuple(names[d] for d in sub)] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
