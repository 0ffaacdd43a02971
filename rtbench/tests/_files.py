"""The benchmark's data files by name, also those that no cell of
``BENCHMARK.json`` names yet (configurations and mixes kept for cells a
later change adds)."""
import json
import os

from rtbench.spec import ROOT

BENCH = os.path.join(ROOT, "rtbench")
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic"))
               if f.endswith(".json"))


def config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def mix(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)
