"""The port stands alone: no file of ``repro_torch`` (or ``chip_smoke.py``,
or an example twin ``examples/*_torch.py``) imports JAX or the JAX
package, and every module imports with JAX blocked.  And the port is
whole: every public name of the JAX package has a twin of the same name
in ``repro_torch``, or stands in ``NO_TWIN`` with the reason it has
none."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# `\brepro\b` does not match `repro_torch` (`_` is a word character)
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)\b", re.M)


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _example_twins():
    return sorted((ROOT / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_imports_neither_jax_nor_repro(path):
    assert not IMPORT_RE.findall(path.read_text()), path


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_does_not_import_msgpack(path):
    """The checkpoint format is raw arrays plus JSON: no port module needs
    msgpack (the card's machine has none)."""
    assert not re.search(r"^\s*(?:import|from)\s+msgpack\b",
                         path.read_text(), re.M), path


@pytest.mark.parametrize("path", _example_twins(), ids=lambda p: p.name)
def test_example_twin_imports_neither_jax_nor_repro(path):
    text = path.read_text()
    assert not IMPORT_RE.findall(text), path
    assert "repro_torch" in text


def test_example_twins_import_with_jax_blocked():
    names = [p.stem for p in _example_twins()]
    assert names == ["alexnet_tma_torch", "quickstart_torch",
                     "serve_quantized_torch", "train_lenet_qat_torch"]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        f"for n in {names!r}:\n"
        "    assert callable(importlib.import_module(n).main)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_nothing_of_jax():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not IMPORT_RE.findall(text)
    assert "repro_torch" in text


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.launch.serve' in names, names\n"
        "print(len(names))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


# The public names of the JAX package that have no twin of the same name
# in the port, each with its reason.
NO_TWIN = {
    # the Pallas kernels: their CUDA twins are named for their route
    "psi_matmul_int8": "kernel 1, psi_matmul_codes_cuda (kernels/ops.py)",
    "psi_matmul_codes": "kernel 1, psi_matmul_codes_cuda",
    "psi_matmul_packed": "kernel 2, psi_matmul_packed_cuda",
    "paged_attention_pallas": "kernel 3, paged_attention_cuda",
    "paged_attention_gather": "XLA's gather route; paged_attention_ref is "
                              "the port's plain version",
    "paged_attn_route": "an environment-variable route; the port routes "
                        "by device only",
    "pick_bm": "the TPU's sublane tile floor",
    "padded_macs": "the TPU tiles' padded work; the port's count belongs "
                   "to its benchmark",
    # JAX functional idiom
    "QuantizedTensor.tree_flatten": "pytree registration",
    "QuantizedTensor.tree_unflatten": "pytree registration",
    "KVCache.tree_flatten": "pytree registration",
    "KVCache.tree_unflatten": "pytree registration",
    "KVCache.replace": "functional update; the port's cache is updated "
                       "in place",
    "init_attention": "functional init; Model.init draws every leaf",
    "init_block": "functional init; Model.init",
    "init_decoder_stack": "functional init; Model.init",
    "init_encoder_stack": "functional init; Model.init",
    "init_mamba": "functional init; Model.init",
    "init_mlp": "functional init; Model.init",
    "init_moe": "functional init; Model.init",
    "init_norm": "functional init; Model.init",
    "init_rglru": "functional init; Model.init",
    "init_stack_cache": "the stacked cache; Model.init_cache",
    "init_paged_stack_cache": "the stacked cache; Model.init_cache",
    # GSPMD and the compiler
    "single_device_mesh": "GSPMD only",
    "to_shardings": "GSPMD only",
    "constrain_block_cache": "GSPMD only",
    "FSDP_AXIS": "GSPMD only",
    "abstract_tree": "a compiler artefact of the dry run",
    "build_step": "a compiler artefact of the dry run",
    "collective_bytes_per_device": "a compiler artefact of the dry run",
    "Executor.decode_cache_size": "jit cache sizes; Executor.graph_counts",
    "Executor.decode_multi_cache_size": "jit cache sizes; graph_counts",
    "Executor.multi_cache_sizes": "jit cache sizes; graph_counts",
    "Executor.prefill_cache_sizes": "jit cache sizes; graph_counts",
    "Server.decode_cache_size": "jit cache size; stats decode_compiles",
    # renamed for the card
    "ICI_BW": "the TPU's link; LINK_BW",
    "WEIGHT_BYTES": "_weight_bytes",
}


def _public_names(root):
    """Top-level public functions, classes and assigned names of every
    module under ``root``, and the public methods of its classes as
    ``Class.method``."""
    out = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                out.add(node.name)
                if isinstance(node, ast.ClassDef):
                    out |= {f"{node.name}.{m.name}" for m in node.body
                            if isinstance(m, ast.FunctionDef)}
            elif isinstance(node, ast.Assign):
                out |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def test_every_public_name_of_the_jax_package_has_a_twin():
    port = _public_names(PORT)
    missing = {n for n in _public_names(ROOT / "src" / "repro")
               if n not in port and n.split(".")[-1] not in
               {p.split(".")[-1] for p in port}}
    assert missing == set(NO_TWIN), (sorted(missing - set(NO_TWIN)),
                                     sorted(set(NO_TWIN) - missing))
