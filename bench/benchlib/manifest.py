"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one ``workloads`` entry) names a configuration, whose file is the
``file`` of its ``configs`` entry, and a traffic mix, read from
``bench/traffic/<traffic>.json`` under the checkout.  A per-layer metric
``<name>`` is read by ``bench/metrics/<name>.py``.  A metric that lists ``workloads`` belongs to
those cells only; one that lists none belongs to every cell.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List


class Manifest:
    """The parsed manifest of the checkout at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    @staticmethod
    def _of_cell(metrics: List[Dict], cell: str) -> List[Dict]:
        return [m for m in metrics
                if "workloads" not in m or cell in m["workloads"]]

    def end_to_end(self, cell: str) -> List[Dict]:
        return self._of_cell(self.data["end_to_end"], cell)

    def per_layer(self, cell: str) -> List[Dict]:
        return self._of_cell(self.data["per_layer"], cell)

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
