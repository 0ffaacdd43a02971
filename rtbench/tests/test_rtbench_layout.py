"""BENCHMARK.json and the files it names: found by name, extended by new
files and entries alone, and free of JAX and, in the reference, of the
program."""
import ast
import json
import os
import re
import shutil

import pytest

from rtbench import deployment, traffic
from rtbench.spec import ROOT, Spec

BENCH = os.path.join(ROOT, "rtbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    spec = Spec()
    names = {m["name"] for m in spec.data["end_to_end"]}
    for cell in spec.data["workloads"]:
        w = cell["name"]
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        mix = spec.traffic(cell["traffic"])
        assert mix["spectral_chunks"] >= 1
        limits = spec.limits(w)
        gaps = {k for k in limits if k.endswith("_gap")}
        assert {"rlu_gap", "rld_gap"} <= gaps
        assert gaps == {"rlu_gap", "rld_gap", "rsu_gap", "rsd_gap"} or \
            "sw" not in cfg["bands"]
        for k in gaps:
            assert limits[k]["lower"] < limits[k]["limit"] \
                < limits[k]["upper"]
        e2e = {m["name"] for m in spec.end_to_end(w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = spec.per_layer(w)
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e and m["moves"] in names
            assert spec.reader(m["name"])({}) is None


def test_benchmark_json_keeps_to_its_limits():
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in data[key]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in data["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in data["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
    for path in data["paths"]:
        for dirpath, _, files in os.walk(os.path.join(ROOT, path)):
            if "__pycache__" in dirpath:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A mix, a metric, a cell's limits and their entries, added in a
    copy of the benchmark without editing any file there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    (root / "rtbench" / "traffic" / "seg4.json").write_text(json.dumps({
        "why": "4 sites a call", "columns_per_call": 4,
        "sites": "contiguous", "experiments": "cycle", "zenith": "site",
        "spectral_chunks": 1, "distinct_calls": 5, "checked_columns": 1}))
    (root / "rtbench" / "metrics" / "calls_read.py").write_text(
        "def read(record):\n    return record.get('calls')\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    first = data["workloads"][0]
    shutil.copy(root / "rtbench" / "limits" / f"{first['name']}.json",
                root / "rtbench" / "limits" / "rfmip_irf.seg4.json")
    data["workloads"].append({"name": "rfmip_irf.seg4",
                              "config": first["config"], "traffic": "seg4",
                              "chips": 1, "why": "test"})
    data["per_layer"].append({
        "name": "calls_read", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "driver and step cache",
        "moves": "columns_per_s", "workloads": ["rfmip_irf.seg4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    spec = Spec(str(root))
    cell = spec.workload("rfmip_irf.seg4")
    assert spec.limits("rfmip_irf.seg4")
    assert "calls_read" in {m["name"] for m in spec.per_layer(cell["name"])}
    assert spec.reader("calls_read")({"calls": 7}) == 7
    dep = deployment.build(spec.config(cell["config"]), 3, smoke=True)
    calls = traffic.calls(spec.traffic("seg4"), dep, 3)
    assert len(calls) == 5 and all(c.size == 4 for c in calls)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def _modules(where):
    for dirpath, _, files in os.walk(where):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_modules(BENCH)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_a_reference_free_of_the_program(path):
    reference = os.path.join(BENCH, "reference")
    for name, level in _imports(path):
        top = name.split(".")[0]
        if level == 0:
            assert top not in ("jax", "jaxlib", "flax", "grtcode_tpu"), name
        if path.startswith(reference):
            assert level <= 1 and top != "grtcode_tpu_torch", name
