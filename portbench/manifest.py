"""Finds every part of a cell by name: its configuration, its traffic
mix, and the code each of them names.

The manifest is `BENCHMARK.json` at the checkout's root.  A cell names a
configuration (its `file` in the manifest) and a traffic mix
(`traffic/<name>.json`).  The code is a file a name, under the bench dir:
- `inputs/<kind>.py`, `items(mix, seed) -> list[Item]`: the mix's
  `inputs`;
- `entries/<call>.py`, `entry(config) -> run(items) -> outputs`: the
  mix's `call`;
- `reference/formats/<format>.py`, `judge(out, item) -> str | None` and
  `zlib9_size(item) -> int`: the configuration's `format`;
- `reference/encoders/<name>.py`, `encode(item) -> bytes`: the
  `encoder` of a configuration's control;
- `metrics/<name>.py`, `read(view) -> float | None`: each metric.
A new cell, configuration, mix, input kind, entry, format, control or
metric is a new file and a new entry: nothing here changes for it.
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

    def module(self, subdir: str, name: str):
        """The module of `<bench_dir>/<subdir>/<name>.py`, loaded anew."""
        path = os.path.join(self.bench_dir, subdir, name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {subdir} {name!r}: {path} is missing")
        tag = f"portbench_{subdir}_{name}"
        spec = importlib.util.spec_from_file_location(
            "".join(c if c.isalnum() else "_" for c in tag), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """`read(view)` of metrics/<metric>.py."""
        return self.module("metrics", metric).read
