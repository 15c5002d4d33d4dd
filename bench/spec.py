"""Finding a cell's parts by name: the benchmark is driven by data.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric.  Their parts live in files of their own, found by those
names, so a later cell, configuration, mix or metric is new files and new
entries, never an edit:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``mixes/<traffic>.json``, read by the generator it names,
  ``generators/<generator>.py`` (``traffic.py``);
* a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the number
  or ``None`` where the run has nothing for it to read;
* a cell's limits for the numbers its output check compares:
  ``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import traffic as traffic_mod

BENCH = Path(__file__).resolve().parent


class Spec:
    """``BENCHMARK.json`` and the files it names, relative to ``root``."""

    def __init__(self, root: Path | None = None, bench: Path | None = None):
        self.root = Path(root) if root is not None else BENCH.parent
        self.bench = Path(bench) if bench is not None else BENCH
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return json.loads((self.bench / "mixes" / f"{traffic}.json").read_text())

    def traffic(self, config: dict, mix: dict, seed):
        """The requests of ``mix`` over ``config`` for one seed."""
        return traffic_mod.make(config, mix, seed, self.bench)

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The cell's metrics: its end-to-end ones untraced, its per-layer
        ones traced."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """``read(run)`` of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
