"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose entry
gives its file, and a traffic mix, ``rtbench/traffic/<mix>.json``.  A
per-layer metric is read by ``rtbench/metrics/<metric>.py``'s
``read(record)``, and a cell's output limits are
``rtbench/limits/<cell>.json``.  A later cell, mix, metric or
configuration is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "rtbench")

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return _json(os.path.join(self.root,
                                  self._named("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return _json(os.path.join(self.dir, "limits", f"{workload}.json"))

    def _applies(self, entry: dict, workload: str) -> bool:
        return "workloads" not in entry or workload in entry["workloads"]

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if self._applies(m, workload)]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.data["per_layer"]
                if self._applies(m, workload)]

    def reader(self, metric: str):
        """The ``read(record)`` of ``rtbench/metrics/<metric>.py``."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"rtbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
