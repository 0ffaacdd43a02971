"""The CIRC case 1 configuration with the 16-stream DISORT shortwave: its
layout is the public case as the program's CIRC app reads it, the
readers of DISORT's layers and doubling counter, and a traced smoke run
of its cell on the CPU that comes out correct."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from grtcode_tpu_torch.apps import circ
from rtbench import deployment
from rtbench.layouts import circ_case1
from rtbench.spec import ROOT, Spec

from ._files import config

CELL = "circ_case1_disort16.column"


def test_the_frozen_case_is_the_public_data():
    """Every array the layout reads is the program's copy of the case,
    bit for bit."""
    frozen = circ_case1.case()
    with np.load(circ.DATA) as d:
        for k, v in frozen.items():
            assert np.array_equal(v, d[k]) and v.dtype == d[k].dtype, k


def test_the_layout_is_the_case_as_the_circ_app_reads_it():
    cfg = config("circ_case1_disort16")
    lay = circ_case1.build(cfg, 5, None)
    other = circ_case1.build(cfg, 2147483901, None)
    assert (lay.sites, lay.experiments) == (1, 1)
    col = deployment.Deployment(cfg, {}, None, lay.profiles, 1, 1).column(
        0, 0, lay.profiles["mu_site"][0])
    atm = circ.case1_atmosphere()
    assert np.array_equal(col["p_lev"], atm.level_pressure[0])
    assert np.array_equal(col["t_lev"], atm.level_temperature[0])
    assert col["t_surf"] == atm.surface_temperature[0]
    for key in ("ppmv", "cfc_ppmv", "cia_ppmv"):
        want = getattr(atm, key)
        assert set(col[key]) == set(want), key
        for m, v in want.items():
            np.testing.assert_allclose(col[key][m], v[0], rtol=1e-15,
                                       err_msg=f"{key} {m}")
    assert col["mu"] == pytest.approx(atm.cos_zenith[0], rel=1e-15)
    assert col["mu"] == pytest.approx(0.6707, abs=1e-4)
    assert col["tsi"] == pytest.approx(atm.total_solar_irradiance[0],
                                       rel=1e-15)
    assert col["tsi"] == pytest.approx(1360.99, abs=0.01)
    assert np.array_equal(col["albedo_grid"], atm.albedo_grid)
    assert np.array_equal(col["albedo"], atm.albedo[0])
    assert col["albedo"].size == 49180
    assert np.array_equal(col["emissivity"], [1.0, 1.0])
    frozen = circ_case1.case()
    assert np.array_equal(lay.solar[0], frozen["wavenumber"])
    assert np.array_equal(lay.solar[1], frozen["toa_solar_function"])
    # No draw from the seed: every seed runs the same column.
    for k in ("p_lev", "t_lev", "mu_site", "albedo"):
        assert np.array_equal(lay.profiles[k], other.profiles[k])
    # A rehearsal's cut holds two copies, the second under a lower sun.
    cut = circ_case1.build(cfg, 5, {"sites": 6})
    assert cut.sites == 2 and np.array_equal(
        cut.profiles["mu_site"], col["mu"] * np.array([1.0, 0.5]))


def test_the_readers_of_disorts_tracing():
    read = {m: Spec().reader(m) for m in (
        "disort_ms_per_call", "disort_doubling_ms_per_call",
        "disort_doublings_needed_pct")}
    record = {"calls": 19, "layer_untimed": 0,
              "layer_ms": {"grtcode::disort": 2500.0,
                           "grtcode::disort_doubling": 1700.0,
                           "grtcode::disort_adding": 790.0},
              "step_stats": {"eager": 0, "captures": 0, "replays": 19,
                             "disort": {"needed": 178, "run": 500}}}
    assert read["disort_ms_per_call"](record) == 2500.0
    assert read["disort_doubling_ms_per_call"](record) == 1700.0
    assert read["disort_doublings_needed_pct"](record) == \
        pytest.approx(35.6)
    for name in ("disort_ms_per_call", "disort_doubling_ms_per_call"):
        assert read[name](dict(record, layer_untimed=1)) is None
    # A program without the layers or the counter: nothing, no error.
    parent = dict(record, layer_ms={"grtcode::disort": 2500.0},
                  step_stats={"eager": 0, "captures": 0, "replays": 19})
    assert read["disort_doubling_ms_per_call"](parent) is None
    assert read["disort_doublings_needed_pct"](parent) is None
    assert read["disort_doublings_needed_pct"](dict(
        record, step_stats={"disort": {"needed": 0, "run": 0}})) is None
    for r in read.values():
        assert r({}) is None


def test_a_traced_smoke_run_of_the_cell_is_correct():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload", CELL, "--seed",
         "2147483911", "--seconds", "0.1", "--trace", "1", "--smoke"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-3000:]
    assert set(result["check"]) == {"rlu_gap", "rld_gap", "rsu_gap",
                                    "rsd_gap"}
    assert "disort_doublings_needed_pct" in result["metrics"]
    printed = {line.split()[1]: json.loads(line.split(None, 2)[2])
               for line in proc.stderr.splitlines()
               if line.startswith("rtbench: ") and line.split()[1] in (
                   "host_spans", "step_stats")}
    counts = printed["step_stats"]["disort"]
    assert 0 < counts["needed"] < counts["run"]
    spans = printed["host_spans"]
    assert spans["grtcode::disort_doubling"] + spans[
        "grtcode::disort_adding"] <= spans["grtcode::disort"]
