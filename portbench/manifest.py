"""Finds a cell's configuration, traffic mix and metric readers by name.

The manifest is `BENCHMARK.json` at the checkout's root.  A cell names a
configuration (its `file` in the manifest), a traffic mix
(`traffic/<name>.json`) and, through the metrics, readers
(`metrics/<name>.py`, each with `read(view) -> float | None`).  A new
cell, configuration, mix or metric is a new file and a new entry:
nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Manifest:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root = root
        self.bench_dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               name + ".json")) as f:
            return json.load(f)

    def metrics(self, cell_name: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics that `cell_name`
        reports: those without `workloads`, and those that list it."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell_name in m["workloads"]]

    def reader(self, metric: str):
        """`read(view)` of metrics/<metric>.py."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace("-", "_").replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
