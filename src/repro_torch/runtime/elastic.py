"""Elastic scaling and failure handling, with ranks in place of devices.

The recovery contract: checkpoints hold global layouts; on a failure the
job restarts on the surviving ranks, :func:`plan_remesh` picks the
largest valid mesh for the new count, and every leaf is cut anew for the
new mesh (``sharding.local_shard``: the load path itself).

``plan_remesh`` shrinks the data axis first, which keeps the TP degree,
so per-card weight shards keep their shapes across restarts with the same
model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_remesh(n_available: int, model_parallel: int,
                pods: Optional[int] = None) -> MeshPlan:
    """Largest (data, model) mesh with the given TP degree that fits the
    surviving rank count; excess ranks become hot spares."""
    if n_available < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_available} devices")
    data = n_available // model_parallel
    if pods and pods > 1 and data % pods == 0:
        shape = (pods, data // pods, model_parallel)
        names = ("pod", "data", "model")
    else:
        shape = (data, model_parallel)
        names = ("data", "model")
    used = int(np.prod(shape))
    return MeshPlan(shape, names, n_available - used)


def make_mesh_from_plan(plan: MeshPlan, ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of the plan over the first ``plan.n_devices`` of
    ``ranks`` (default the process group's ranks in order).  Every rank of
    the group calls it; the ranks the plan drops get a mesh without a
    coordinate (hot spares)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if ranks is None:
        ranks = range(dist.get_world_size())
    return make_mesh(plan.shape, plan.axis_names,
                     list(ranks)[:plan.n_devices])


def survivors_after_failure(ranks: Sequence[int], failed_ids) -> list:
    """The ranks of ``ranks`` not in ``failed_ids``, in order."""
    failed = set(int(f) for f in failed_ids)
    return [r for r in ranks if int(r) not in failed]
