"""BENCHMARK.json and the files it names: found by name, extended by new
files and entries alone, and free of JAX and, in the reference, of the
program."""
import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rtbench import deployment, program, traffic
from rtbench.reference import rt
from rtbench.spec import ROOT, Spec

from ._files import config

BENCH = os.path.join(ROOT, "rtbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    spec = Spec()
    names = {m["name"] for m in spec.data["end_to_end"]}
    for cell in spec.data["workloads"]:
        w = cell["name"]
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert deployment.layout(cfg) and rt.sw_solver(cfg)
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


def test_the_readers_of_the_programs_tracing():
    read = {m: Spec().reader(m) for m in (
        "driver_host_ms_per_call", "step_replays_pct",
        "line_prep_ms_per_call", "absorbers_ms_per_call",
        "lw_solver_ms_per_call")}
    layers = {"grtcode::line_prep": 177.0, "grtcode::absorbers": 15.1,
              "grtcode::lw_solver": 64.9, "grtcode::step": 1416.5}
    record = {"calls": 4, "layer_ms": layers, "layer_untimed": 0,
              "host_spans": {"grtcode::run": 2.0, "grtcode::inputs": 1.1,
                             "grtcode::step_replay": 0.8,
                             "grtcode::step_eager": 0.1},
              "step_stats": {"eager": 1, "captures": 1, "replays": 6,
                             "dropped": 0}}
    assert read["driver_host_ms_per_call"](record) == pytest.approx(275.0)
    assert read["step_replays_pct"](record) == pytest.approx(75.0)
    for name, layer in (("line_prep", 177.0), ("absorbers", 15.1),
                        ("lw_solver", 64.9)):
        assert read[f"{name}_ms_per_call"](record) == layer
        assert read[f"{name}_ms_per_call"](
            dict(record, layer_untimed=1)) is None
    assert read["step_replays_pct"](dict(record, step_stats={
        "eager": 0, "captures": 0, "replays": 0, "dropped": 0})) is None
    assert read["driver_host_ms_per_call"](
        dict(record, host_spans={})) is None


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


ONE_COLUMN_LAYOUT = """
import numpy as np

from ..deployment import Layout, rng


def build(cfg, seed, cut):
    L = cfg["levels"]
    g = rng(seed, 3)
    p_lev = np.linspace(0.01, 1013.25, L)[None]
    t_lev = (np.linspace(200.0, 290.0, L) + g.uniform(-2.0, 2.0, L))[None, None]
    full = np.ones((1, 1, L))
    base = cfg["present_day_ppmv"]
    ppmv = {int(k): v * full for k, v in base.items() if k.isdigit()}
    ppmv[1] = np.maximum(3.0, 1e4 * (p_lev / 1013.25) ** 3)[None]
    ppmv[3] = 0.05 * full
    gas = {p: {int(k[4:]): v * full for k, v in base.items()
               if k.startswith(p + "_")} for p in ("cfc", "cia")}
    return Layout(sites=1, experiments=1, profiles=dict(
        p_lev=p_lev, t_lev=t_lev, t_surf=t_lev[..., -1] + 1.0, ppmv=ppmv,
        cfc_ppmv=gas["cfc"], cia_ppmv=gas["cia"], mu_site=np.array([0.5]),
        tsi=np.array([1361.0]),
        emissivity_grid=np.array([[100.0, 600.0, 1200.0, 2500.0]]),
        emissivity=np.array([[0.90, 0.99, 0.93, 0.80]]),
        albedo_grid=np.array([[1.0, 2.0]]), albedo=np.array([[0.1, 0.1]])))
"""


def _copy(tmp_path):
    """A checkout of the benchmark alone, and its BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root, json.loads((root / "BENCHMARK.json").read_text())


def _add_config(root, data, name, **keys):
    """A configuration, ``rfmip_irf_lw`` or ``rfmip_irf`` (where
    ``keys`` name a shortwave solver) with ``keys`` changed, as a new
    file and a new entry."""
    cfg = json.loads((root / "rtbench" / "configs" / (
        "rfmip_irf.json" if "sw_solver" in keys else "rfmip_irf_lw.json"))
        .read_text())
    cfg.update(name=name, smoke={"line_shrink": 256, "grid_coarsen": 8,
                                 "sites": 2, "experiments": 1}, **keys)
    (root / "rtbench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    data["configs"].append({"name": name, "source": "test",
                            "file": f"rtbench/configs/{name}.json",
                            "reduced": [], "why": "test"})
    return cfg


def _add_cell(root, data, name, config, mix):
    first = data["workloads"][0]["name"]
    shutil.copy(root / "rtbench" / "limits" / f"{first}.json",
                root / "rtbench" / "limits" / f"{name}.json")
    data["workloads"].append({"name": name, "config": config,
                              "traffic": mix, "chips": 1, "why": "test"})


def _run(root, cell, trace=0):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload", cell, "--seed",
         "2147483801", "--seconds", "0.1", "--trace", str(trace),
         "--smoke"], cwd=root, capture_output=True, text=True, env=env,
        timeout=600)


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A mix, a metric, a cell's limits, a column layout with a surface
    spectrum of its own and a configuration that names it, and their
    entries, added in a copy of the benchmark without editing any file
    there: the copy finds each by name, and a traced smoke run of the new
    cell is correct."""
    root, data = _copy(tmp_path)
    (root / "rtbench" / "traffic" / "seg4.json").write_text(json.dumps({
        "why": "4 sites a call", "columns_per_call": 4,
        "sites": "contiguous", "experiments": "cycle", "zenith": "site",
        "spectral_chunks": 1, "distinct_calls": 5, "checked_columns": 1}))
    (root / "rtbench" / "traffic" / "one.json").write_text(json.dumps({
        "why": "one column a call", "columns_per_call": 1,
        "sites": "in_order", "experiments": "cycle", "zenith": "site",
        "spectral_chunks": 1, "distinct_calls": 1, "checked_columns": 1}))
    (root / "rtbench" / "metrics" / "calls_read.py").write_text(
        "def read(record):\n    return record.get('calls')\n")
    (root / "rtbench" / "metrics" / "lw_layer_read.py").write_text(
        "def read(record):\n"
        "    return (record.get('layer_ms') or {}).get('grtcode::lw_solver')"
        "\n")
    (root / "rtbench" / "layouts" / "one_column.py").write_text(
        ONE_COLUMN_LAYOUT)
    first = data["workloads"][0]
    _add_cell(root, data, "rfmip_irf.seg4", first["config"], "seg4")
    _add_config(root, data, "one_column_lw", layout="one_column")
    _add_cell(root, data, "one_column_lw.one", "one_column_lw", "one")
    for name, cell in (("calls_read", "rfmip_irf.seg4"),
                       ("lw_layer_read", "one_column_lw.one")):
        data["per_layer"].append({
            "name": name, "unit": "calls", "better": "higher",
            "source": "program_counter", "layer": "driver and step cache",
            "moves": "columns_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    spec = Spec(str(root))
    cell = spec.workload("rfmip_irf.seg4")
    assert spec.limits("rfmip_irf.seg4")
    assert "calls_read" in {m["name"] for m in spec.per_layer(cell["name"])}
    assert spec.reader("calls_read")({"calls": 7}) == 7
    assert spec.reader("lw_layer_read")(
        {"layer_ms": {"grtcode::lw_solver": 2.5}}) == 2.5
    dep = deployment.build(spec.config(cell["config"]), 3, smoke=True)
    calls = traffic.calls(spec.traffic("seg4"), dep, 3)
    assert len(calls) == 5 and all(c.size == 4 for c in calls)

    proc = _run(root, "one_column_lw.one", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-3000:]
    assert set(result["check"]) == {"rlu_gap", "rld_gap"}
    printed = {line.split()[1]: json.loads(line.split(None, 2)[2])
               for line in proc.stderr.splitlines()
               if line.startswith("rtbench: ") and line.split()[1] in (
                   "layer_ms", "layer_untimed", "step_stats")}
    assert printed["step_stats"]["eager"] == result["attempted"] >= 1
    assert printed["layer_untimed"] == 0 and printed["layer_ms"] == {}


def test_a_layout_spectrum_reaches_both_sides():
    """The program's Atmosphere takes each column's surface grid and
    values as the layout gives them; the reference puts them on its band
    grid linearly, holding the first value below the grid and the
    second-to-last past it, as the reference C does."""
    dep = deployment.build(config("rfmip_irf"), 9, smoke=True)
    cols = dep.columns([0, 0], [0, 1], [0.5, 0.5])
    atm = program.atmosphere(cols)
    assert np.array_equal(atm.emissivity_grid, [1.0, 2.0])
    assert np.array_equal(atm.albedo, cols["albedo"])
    with pytest.raises(ValueError, match="surface grids"):
        program.atmosphere(dict(cols, albedo_grid=np.array(
            [[1.0, 2.0], [1.0, 3.0]])))
    w = np.array([50.0, 100.0, 350.0, 600.0, 2500.0, 3000.0])
    got = rt.surface([100.0, 600.0, 1200.0, 2500.0],
                     [0.90, 0.99, 0.93, 0.80], w)
    assert np.allclose(got, [0.90, 0.90, 0.945, 0.99, 0.80, 0.93],
                       rtol=0, atol=1e-15)


def test_driver_options_come_from_the_configuration():
    cfg = dict(config("rfmip_irf"), sw_solver="disort", disort_streams=4,
               smoke={"line_shrink": 256, "grid_coarsen": 8, "sites": 2,
                      "experiments": 1})
    driver = program.build_driver(deployment.build(cfg, 5, smoke=True),
                                  "cpu")
    assert (driver.sw_solver, driver.disort_streams) == ("disort", 4)
    lw = deployment.build(config("rfmip_irf_lw"), 5, smoke=True)
    driver = program.build_driver(lw, "cpu")
    assert (driver.sw_solver, driver.disort_streams) == ("two_stream", 16)
    with pytest.raises(ValueError, match="cloud state"):
        program.build_driver(dataclasses.replace(
            lw, config=dict(lw.config, sky="all")), "cpu")


FIXTURE_SOLVER = """
import torch


def fluxes(tau, omega, g, mu, albedo, tsi, solar, *, config):
    shape = (tau.shape[0] + 1, tau.shape[1])
    return (torch.full(shape, 2.0, dtype=tau.dtype),
            torch.full(shape, float(config["disort_streams"]),
                       dtype=tau.dtype))
"""

FLUXES_OF_THE_COPY = """
import json
from rtbench import deployment
from rtbench.reference import rt
cfg = json.load(open("rtbench/configs/rfmip_irf_disort4.json"))
dep = deployment.build(cfg, 5, smoke=True)
out = rt.column_fluxes(dep, dep.column(0, 0, 0.7))
sw = dep.bands["sw"]
print(json.dumps({"rsu": out["rsu"].tolist(), "rsd": out["rsd"].tolist(),
                  "width": (sw.n - 1) * sw.dw}))
"""


def test_the_shortwave_reference_is_found_by_name(tmp_path):
    """A configuration naming ``sw_solver: "disort"`` stops before the
    warm-up, with no result, while the reference has no
    ``sw_disort.py``; with a fixture ``sw_disort.py`` in the copy, that
    module is what ``column_fluxes`` calls, given the configuration."""
    root, data = _copy(tmp_path)
    _add_config(root, data, "rfmip_irf_disort4", sw_solver="disort",
                disort_streams=4)
    _add_cell(root, data, "rfmip_irf_disort4.expt100", "rfmip_irf_disort4",
              "expt100")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    proc = _run(root, "rfmip_irf_disort4.expt100")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "rtbench/reference/sw_disort.py" in proc.stderr
    assert "warm-up" not in proc.stderr and "deployment built" not in \
        proc.stderr

    (root / "rtbench" / "reference" / "sw_disort.py").write_text(
        FIXTURE_SOLVER)
    proc = subprocess.run([sys.executable, "-c", FLUXES_OF_THE_COPY],
                          cwd=root, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.allclose(out["rsu"], 2.0 * out["width"], rtol=1e-12)
    assert np.allclose(out["rsd"], 4.0 * out["width"], rtol=1e-12)


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
