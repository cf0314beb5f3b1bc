"""Dry run of every (architecture x input shape x mesh) cell: where each
tensor of the cell's step lives on the production mesh, how many bytes a
device holds, and the analytic roofline terms.  The twin of the JAX
package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell's step on 512 placeholder
devices and reads the compiled artifact.  PyTorch has no compiler to ask,
so this report places the step's inputs instead (``build_step``'s
counterpart, :func:`place_cell`): params on ``param_specs`` (serving
specs at the serving quant; training specs, FSDP over the data axes, in
float), AdamW's ``m`` and ``v`` on the param specs (train cells), the
decode cache on ``cache_specs`` (the dense layout the JAX package pins
for these cells) and the batch on ``batch_specs``, each leaf cut as
``sharding.local_shard`` cuts it.  Per device it reports those resident
bytes by kind, their total (``local_shard`` splits every dim evenly, so
every rank holds the same bytes and the largest total over the ranks is
this one) and whether it fits the H100's 80 GB.  Beside them: the terms
of ``perf.roofline_model`` (H100 constants), ``model_flops`` and the
useful-FLOPs ratio.

Not reported, having no counterpart without a compiler: ``lower_s``,
``compile_s``, ``hlo_*_once``, ``collective_breakdown`` and
``memory_analysis``.  Activations and temporaries are not counted either,
so the resident bytes are a floor of a device's memory.  The JAX
package's activation overrides (``act_batch_axes``, ``act_seq_axis``,
``moe_expert_axis``) steer only GSPMD's activation constraints and have
no twin here.

Device: every tensor is a ``meta`` tensor and the mesh an ``AxisMesh``
(axis names and sizes, no process group), so nothing is allocated and no
device is touched.  This is the one entry point of the port that needs no
card and does not default to CUDA.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out cells.json
  ... --multi-pod            # (2, 16, 16) pod mesh instead of (16, 16)
  ... --quant psi8|psi5|none # serving weight format (default psi8)
  ... --kv-quant int8        # int8 decode cache
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.core import quantizer as qz
from repro_torch.core.psi import QuantizedTensor
from repro_torch.models import build_model
from repro_torch.perf.roofline_model import analytic_cell, roofline_terms
from repro_torch.runtime import sharding as shr

META = torch.device("meta")
HBM_BYTES = 80e9                 # one H100's HBM
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def production_mesh(multi_pod: bool = False) -> shr.AxisMesh:
    """(16, 16) data x model, or (2, 16, 16) with the "pod" axis."""
    if multi_pod:
        return shr.AxisMesh((2, 16, 16), ("pod", "data", "model"))
    return shr.AxisMesh((16, 16), ("data", "model"))


# --------------------------------------------------------------------------
# Abstract inputs (meta tensors; no allocation).
# --------------------------------------------------------------------------
def abstract_params(model, quant: str, dtype=None):
    """The params as meta tensors, float leaves in ``dtype`` (default the
    config's, as the JAX package's dry run casts them); with ``quant``
    psiN every quantizable leaf quantized, packed where sub-byte (codes or
    bit-planes and their f32 scales)."""
    cfg = model.cfg
    dt = dtype or _DTYPES[cfg.dtype]
    params = {"layers": [{} for _ in range(cfg.n_layers)]}
    if cfg.family == "encdec":
        params["encoder"] = [{} for _ in range(cfg.n_enc_layers)]
    for path, shape, _ in model.param_specs():
        node = params
        keys = path.split("/")
        for k in keys[:-1]:
            node = node[int(k)] if isinstance(node, list) else \
                node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, dtype=dt, device=META)
    if quant not in ("", "none"):
        _, bits = qz.parse_quant_mode(quant)
        params = qz.quantize_param_tree(params, bits, pack=True)
    return params


def input_specs(cfg, shape):
    """Meta stand-ins for every model input of a cell of ``cfg`` (its
    kv_quant included) at ``shape`` (a ``ShapeConfig``): the batch (train
    / prefill), or {"batch", "cache"} for a decode step against a
    ``seq_len``-deep dense cache."""
    B, S = shape.global_batch, shape.seq_len
    act = _DTYPES[cfg.dtype]
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device=META)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.empty(
                (B, cfg.vision_patches, cfg.d_model), dtype=act, device=META)
            batch["positions"] = torch.empty((B, 3, S), dtype=torch.int32,
                                             device=META)
        if cfg.family == "encdec":
            batch["frames"] = torch.empty((B, cfg.enc_frames, cfg.d_model),
                                          dtype=act, device=META)
        return batch
    batch = {"token": torch.empty((B, 1), dtype=torch.int32, device=META)}
    key = "positions" if cfg.rope == "mrope" else "pos"
    batch[key] = torch.empty((B, 3, 1) if key == "positions" else (B, 1),
                             dtype=torch.int32, device=META)
    # the steady dense state (every slot at the full context depth), where
    # paging saves nothing: the layout the JAX package's dry run pins
    cache = build_model(cfg).init_cache(B, S, device=META, layout="dense")
    return {"batch": batch, "cache": cache}


# --------------------------------------------------------------------------
# Placement: each input with its spec.
# --------------------------------------------------------------------------
def place_cell(cfg, shape, mesh, param_dtype=None) -> dict:
    """{kind: (tree, spec tree)} of a cell's step inputs on ``mesh``:
    "params", and "m" / "v" (train), "cache" (decode), "batch".  ``cfg``
    carries the cell's serving quant and kv_quant (:func:`cell_config`);
    train cells hold float params (``param_dtype``, default the config's)
    on the training specs."""
    train = shape.kind == "train"
    model = build_model(cfg)
    params = abstract_params(model, "none" if train else cfg.quant_mode,
                             param_dtype)
    pspecs = shr.param_specs(params, cfg, mesh,
                             mode="train" if train else "serve")
    kinds = {"params": (params, pspecs)}
    if train:
        f32 = qz.tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                device=META), params)
        kinds["m"] = (f32, pspecs)
        kinds["v"] = (f32, pspecs)
    spec = input_specs(cfg, shape)
    if shape.kind == "decode":
        cache = spec["cache"]
        cspecs = shr.cache_specs(cfg, mesh, cache)
        kinds["cache"] = ([cache.kv, cache.enc_out],
                          [cspecs.kv, cspecs.enc_out])
        spec = spec["batch"]
    kinds["batch"] = (spec, shr.batch_specs(cfg, mesh, spec))
    return kinds


def _ways(mesh, axes) -> int:
    shape = shr.mesh_axes(mesh)
    if axes is None:
        return 1
    return int(np.prod([shape[a] for a in (axes if isinstance(axes, tuple)
                                           else (axes,))]))


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """The bytes of the chunk ``local_shard`` cuts of ``t`` on any rank."""
    n = t.element_size()
    for d, size in enumerate(t.shape):
        ways = _ways(mesh, spec[d]) if d < len(spec) else 1
        if size % ways:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{ways} ways ({spec})")
        n *= size // ways
    return n


def resident_bytes(kinds: dict, mesh) -> dict:
    """{kind: bytes one device holds} of :func:`place_cell`'s placement
    ("opt" = m + v)."""
    out = {}

    def add(kind, leaf, spec):
        if isinstance(leaf, QuantizedTensor):
            out[kind] = (out.get(kind, 0) + shard_bytes(leaf.data, spec.data,
                                                        mesh)
                         + shard_bytes(leaf.scale, spec.scale, mesh))
        elif isinstance(leaf, torch.Tensor):
            out[kind] = out.get(kind, 0) + shard_bytes(leaf, spec, mesh)

    for kind, (tree, specs) in kinds.items():
        name = "opt" if kind in ("m", "v") else kind
        out.setdefault(name, 0)
        shr.map_tree(lambda path, leaf, spec: add(name, leaf, spec), tree,
                     specs)
    return out


# --------------------------------------------------------------------------
# The report.
# --------------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """Standard useful-FLOPs yardstick: 6*N*D train, 2*N*D inference
    (N = active non-embedding params, D = tokens processed)."""
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def cell_config(arch: str, shape, quant: str, kv_quant: str = ""):
    """The config a cell runs: float for training, the serving quant
    otherwise, ``kv_quant`` on decode cells."""
    overrides = {"quant_mode": quant if shape.kind != "train" else "none"}
    if kv_quant and shape.kind == "decode":
        overrides["kv_quant"] = kv_quant
    return get_config(arch, **overrides)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str = "psi8", kv_quant: str = "", verbose: bool = True):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = production_mesh(multi_pod)
    chips = mesh.size
    t0 = time.perf_counter()
    kinds = place_cell(cell_config(arch, shape, quant, kv_quant), shape,
                       mesh)
    resident = resident_bytes(kinds, mesh)
    t_place = time.perf_counter() - t0
    an_quant = quant if shape.kind != "train" else "none"
    cell = analytic_cell(arch, shape_name, quant=an_quant, chips=chips,
                         mesh_model=mesh.shape.get("model", 1),
                         kv_quant=kv_quant)
    mf = model_flops(cfg, shape)
    mem_dev = sum(resident.values())
    result = {
        "arch": arch, "shape": shape_name, "quant": quant,
        "kv_quant": kv_quant,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "place_s": round(t_place, 3),
        **roofline_terms(cell, chips=chips),
        "flops_per_dev": cell.flops / chips,
        "hbm_bytes_per_dev": cell.hbm_bytes / chips,
        "coll_bytes_per_dev_analytic": cell.coll_bytes_per_dev,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(cell.flops, 1.0),
        "resident_bytes_per_dev": resident,
        "memory_per_device_bytes": mem_dev,
        "fits_hbm_80g": bool(mem_dev < HBM_BYTES),
    }
    if verbose:
        print(json.dumps(result, indent=1, default=float))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", default="psi8",
                    choices=list(qz.serving_mode_choices()))
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        try:
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                    quant=args.quant,
                                    kv_quant=args.kv_quant))
        except Exception as e:  # a failing cell is a bug: surface loudly
            results.append({"arch": arch, "shape": shape,
                            "error": f"{type(e).__name__}: {e}"})
            print(f"FAIL {arch} x {shape}: {e}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    fails = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(fails)}/{len(results)} cells passed")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
