"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(with the ``csrc/*.cuh`` headers it includes), one ``nvcc`` process per
source, all started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <name>.so csrc/<name>.cu

The libraries land in ``repro_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of every source and of the flags, so an
edited kernel rebuilds and an unchanged one loads from disk.  Nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("psi_matmul", "psi_rows", "paged_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (CUDA_HOME or "
                       "/usr/local/cuda)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, in parallel; raise
    with the compiler's output if any fails.  Returns the build directory
    (each ``<name>.log`` there holds ptxas' register/shared-memory report)."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"{n}.so").is_file()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for n in todo:
        tmp = out / f"{n}.so.tmp{os.getpid()}"
        cmd = [cc, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        (out / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out / f"{n}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel source {name!r}")
        lib = ctypes.CDLL(str(build_all() / f"{name}.so"))
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    split plans size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
