"""Fault-tolerant checkpointing in the JAX package's on-disk format, so a
checkpoint written by either package restores in the other.

* **Atomic**: write to ``<dir>/tmp.<step>``, fsync, then ``os.rename`` to
  ``<dir>/step_<step:010d>``: a crash mid-save never corrupts the latest
  checkpoint.
* **Async**: ``save(..., blocking=False)`` copies every leaf to host
  memory first (CPU tensors too: training updates them in place) and
  writes on a background thread; ``wait()`` joins it, and every save
  waits for the one before.
* **Keep-k** rotation, plus "keep every Nth" permanent snapshots.
* **Resumable data state**: ``extra`` (the step and the data stream's
  state dict) rides in the manifest.

Format: ``manifest.json`` ({"step", "extra", "arrays": {name: {"dtype",
"shape", "offset", "nbytes"}}}) plus ``arrays.bin``, the raw bytes of
every array back to back.  Names are tree paths: dict keys, ``#i`` list
items, ``@emptylist`` / ``@tuple`` markers, and a
:class:`~repro_torch.core.psi.QuantizedTensor` as ``@psi`` (int32 [bits,
packed, n_psi, max_exp]), ``data`` and ``scale``.  numpy has no bf16: a
bf16 leaf is stored as its raw 2 bytes under the dtype name
``"bfloat16"`` (the name the JAX package writes through ml_dtypes).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.psi import QuantizedTensor, make_format

_BF16 = "bfloat16"


def _host(x):
    """A leaf as a host numpy array and its dtype name (a bf16 tensor as
    its uint16 bits under "bfloat16"); tensors are copied."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(x)
    return a, str(a.dtype)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, QuantizedTensor):
        out[prefix + "@psi"] = _host(np.asarray(
            [tree.fmt.bits, int(tree.packed), tree.fmt.n_psi,
             tree.fmt.max_exp], np.int32))
        out[prefix + "data"] = _host(tree.data)
        out[prefix + "scale"] = _host(tree.scale)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
        if len(tree) == 0:
            out[prefix + "@emptylist"] = _host(np.zeros((0,), np.int8))
        if isinstance(tree, tuple):
            out[prefix + "@tuple"] = _host(np.zeros((0,), np.int8))
    else:
        out[prefix.rstrip("/")] = _host(tree)
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = set(node)
        if "@psi" in keys:
            meta = [int(v) for v in node["@psi"]]
            if len(meta) != 4:
                raise ValueError(
                    f"corrupt '@psi' record (expected [bits, packed, n_psi, "
                    f"max_exp], got {meta})")
            bits, packed, n_psi, max_exp = meta
            return QuantizedTensor(
                node["data"], node["scale"],
                make_format(bits, n_psi=n_psi, max_exp=max_exp),
                bool(packed))
        is_tuple = "@tuple" in keys
        keys.discard("@tuple")
        if "@emptylist" in keys and len(keys) == 1:
            return () if is_tuple else []
        if keys and all(k.startswith("#") for k in keys):
            seq = [rebuild(node[f"#{i}"]) for i in range(len(keys))]
            return tuple(seq) if is_tuple else seq
        return {k: rebuild(v) for k, v in node.items() if k != "@tuple"}

    return rebuild(root)


def _from_bytes(data: bytes, meta: Dict) -> torch.Tensor:
    shape = meta["shape"]
    count = int(np.prod(shape)) if shape else 1
    if meta["dtype"] == _BF16:
        a = np.frombuffer(data, dtype=np.int16, count=count,
                          offset=meta["offset"]).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(data, dtype=np.dtype(meta["dtype"]), count=count,
                      offset=meta["offset"]).reshape(shape)
    return torch.from_numpy(a.copy())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, keep_every: int = 0):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict, extra: Optional[Dict] = None,
             blocking: bool = True, shardings=None) -> None:
        """Write ``tree`` (tensors, QuantizedTensors, numpy arrays or
        scalars in nested dicts / lists / tuples) and the JSON-able
        ``extra`` as step ``step``; with ``blocking=False`` the leaves are
        copied to the host here and written on a background thread.

        ``shardings`` = (spec tree, mesh): ``tree`` holds this rank's
        chunks.  Every rank of the mesh calls ``save``; the chunks are
        gathered into the global tree and the mesh's first rank writes it
        (the format is the single process's); blocking, every rank
        returns once the checkpoint is on disk."""
        mesh = None
        if shardings is not None:
            from repro_torch.runtime import fsdp, sharding
            specs, mesh = shardings
            tree = fsdp.gather_tree(tree, specs, mesh)
            if any(sharding.mesh_coordinate(mesh).values()):
                if blocking:
                    _barrier(mesh)
                return
        flat = _flatten(tree)
        self.wait()
        if blocking:
            self._write(step, flat, extra or {})
            if mesh is not None:
                _barrier(mesh)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}),
                daemon=True)
            self._thread.start()

    def _write(self, step: int, flat, extra: Dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        with open(os.path.join(tmp, "arrays.bin"), "wb") as f:
            for name, (arr, dtype) in flat.items():
                buf = np.ascontiguousarray(arr)
                manifest["arrays"][name] = {
                    "dtype": dtype, "shape": list(buf.shape),
                    "offset": f.tell(), "nbytes": buf.nbytes}
                f.write(buf.tobytes())
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        protect = {s for s in steps
                   if self.keep_every and s % self.keep_every == 0}
        victims = [s for s in steps[:-self.keep] if s not in protect]
        for s in victims:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        pat = re.compile(r"step_(\d+)$")
        out = []
        for name in os.listdir(self.dir):
            m = pat.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None,
                shardings=None):
        """Returns (tree, extra): the latest step (or ``step``), every
        array a tensor (bf16 where the dtype name says so) on ``device``,
        the host when None; ``@psi`` records come back as
        QuantizedTensors.  ``shardings`` = (spec tree structure-equal to
        the checkpoint's, mesh): each leaf is cut to this rank's chunk
        (``sharding.local_shard``) before it moves to ``device``, onto
        whatever mesh the job runs now (the elastic restart path)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(d, "arrays.bin"), "rb") as f:
            data = f.read()
        tree = _unflatten({name: _from_bytes(data, meta)
                           for name, meta in manifest["arrays"].items()})
        if shardings is not None:
            from repro_torch.runtime import sharding
            specs, mesh = shardings
            tree = sharding.local_shard_tree(tree, specs, mesh)
        if device is not None:
            tree = _to_device(tree, device)
        return tree, manifest["extra"]


def _to_device(tree, device):
    """Every tensor (and QuantizedTensor) of a nested tree on ``device``."""
    if isinstance(tree, (torch.Tensor, QuantizedTensor)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _barrier(mesh) -> None:
    import torch.distributed as dist
    dist.barrier(group=mesh.flat_group)
