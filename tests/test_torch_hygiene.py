"""The port stands alone: no file of ``repro_torch`` (or ``chip_smoke.py``)
imports JAX or the JAX package, and every module imports with JAX
blocked."""
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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_imports_neither_jax_nor_repro(path):
    assert not IMPORT_RE.findall(path.read_text()), path


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
