"""What the harness loads and refuses: no JAX, no JAX package, no run
without a card, nothing without the program beside it."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import bench_toy

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "functools", "hashlib",
                              "typing", "torch"}


def test_a_run_leaves_no_forbidden_module(tmp_path):
    root = bench_toy.make_root(tmp_path)
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}]\n"
        "import bench_toy\n"
        "from pathlib import Path\n"
        "from benchlib import cell\n"
        f"res, _ = bench_toy.run_toy(Path({str(root)!r}), seconds=0.5)\n"
        "print(cell.forbidden_modules(), res['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=dict(
                             os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from benchlib import cell
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in cell.forbidden_modules()


def _run(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "phi3-psi8.rag",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
