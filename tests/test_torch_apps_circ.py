"""The port's CIRC app (``grtcode_tpu_torch.apps.circ``) against the JAX
package's, on the CPU.

* ``case1_atmosphere`` and ``load_case_file`` (the case file of
  tests/test_circ_case.py, with the ``-a`` albedo, a level window, aerosols
  and clouds) give Atmospheres byte-identical to JAX's;
* ``circ.main`` on the driver golden's input files
  (``tools/goldens/driver_inputs.write_inputs``: the .par, continua, CFC
  and CIA CSVs) at the CLI tests' coarse grids (LW 1-3,250 cm-1 at 4, SW
  1-50,000 at 10) matches JAX's ``main``: every tier's fluxes at 1e-4
  (worst relative, the golden's 1 % floor; 1.7e-5 found) and the printed
  table (the same rows, reference columns and values at 1e-4).

``-spectral-chunks 3`` is in tests/test_torch_apps_circ_streamed.py and the
case file with ``-o`` in tests/test_torch_apps_circ_case.py: each JAX
``main`` compiles for ~18 s, one per file keeps each under 40 s.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools.goldens import driver_inputs  # noqa: E402

from grtcode_tpu.apps import circ as jcirc  # noqa: E402
from grtcode_tpu_torch.apps import circ  # noqa: E402
from tests.test_circ_case import case_file  # noqa: E402,F401
from tests.test_torch_driver import TOLERANCE  # noqa: E402
from tests.test_torch_driver import _worst_rel as worst_rel  # noqa: E402

COARSE = ["-r-lw", "4.0", "-r-sw", "10.0"]   # tests/test_cli.py:21


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The driver golden's input files, and the argv that names them all."""
    d = str(tmp_path_factory.mktemp("circ_inputs"))
    driver_inputs.write_inputs(d)

    def path(name):
        return os.path.join(d, name)

    return [path("synthetic.par"), path("solar.csv"), "-h2o-ctm",
            path("h2o_ctm"), "-o3-ctm", path("o3_ctm.csv"), "-CFC-11",
            path("cfc11.csv"), "-CFC-12", path("cfc12.csv"), "-N2-N2",
            path("cia_n2n2.csv"), "-O2-N2", path("cia_o2n2.csv")] + COARSE


def assert_atmospheres_identical(got, want):
    """Every field of the JAX Atmosphere, byte for byte (dtype included)."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, dict):
            assert list(g) == list(w), f.name
            for k in w:
                assert g[k].dtype == w[k].dtype, (f.name, k)
                assert np.array_equal(g[k], w[k]), (f.name, k)
        elif w is None or isinstance(w, (bool, int, float)):
            assert type(g) is type(w) and g == w, f.name
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name


def assert_tiers_match(got, want):
    """Every tier's fluxes at TOLERANCE (worst relative, 1 % floor)."""
    assert sorted(got.tiers) == sorted(want.tiers)
    for tier, fluxes in want.tiers.items():
        assert sorted(got.tiers[tier]) == sorted(fluxes)
        for var, w in fluxes.items():
            g, w = got.tiers[tier][var].numpy(), np.asarray(w)
            assert g.shape == w.shape and np.isfinite(g).all()
            assert worst_rel(g, w) < TOLERANCE, (tier, var)


def table(out: str):
    """The printed table: its header line and, by variable, (value,
    reference columns)."""
    lines = out.splitlines()
    header = [ln for ln in lines if ln.startswith("Variable")]
    rows = {}
    for ln in lines:
        parts = ln.split()
        if parts and parts[0] in circ.CASE1_REFERENCE:
            rows[parts[0]] = (float(parts[1]), parts[2:])
    return header, rows


def assert_tables_match(got_out, want_out):
    got_header, got = table(got_out)
    want_header, want = table(want_out)
    assert got_header == want_header and len(got_header) == 1
    assert list(got) == list(want) == list(circ.CASE1_REFERENCE)
    for name, (value, refs) in want.items():
        assert got[name][1] == refs, name
        assert got[name][0] == pytest.approx(value, rel=TOLERANCE), name


@pytest.mark.parametrize("clean,clear", [(True, True), (False, False)])
def test_case1_atmosphere_identical(clean, clear):
    assert_atmospheres_identical(
        circ.case1_atmosphere(clean=clean, clear=clear),
        jcirc.case1_atmosphere(clean=clean, clear=clear))


@pytest.mark.parametrize("kw", [
    {}, dict(albedo=0.2), dict(z=2, Z=6), dict(clean=False, clear=False),
    dict(molecules=(1, 3), cfcs=(), cias=((7, 7),))],
    ids=["default", "albedo", "window", "aerosol_clouds", "subset"])
def test_load_case_file_identical(case_file, kw):  # noqa: F811
    assert_atmospheres_identical(circ.load_case_file(case_file, **kw),
                                 jcirc.load_case_file(case_file, **kw))


def test_case1_solar_flux_matches_jax():
    from grtcode_tpu.spectral import SpectralGrid as JGrid
    from grtcode_tpu_torch.spectral import SpectralGrid
    got = circ.case1_solar_flux(SpectralGrid(1.0, 50000.0, 10.0), "cpu")
    want = jcirc.case1_solar_flux(JGrid(1.0, 50000.0, 10.0))
    g, w = got.incident_flux.numpy(), np.asarray(want.incident_flux)
    assert g.shape == w.shape == (5001,)
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_main_matches_jax(inputs, capsys):
    got = circ.main(inputs + ["-o", ""], device="cpu")
    got_out = capsys.readouterr().out
    want = jcirc.main(inputs + ["-o", ""])
    want_out = capsys.readouterr().out
    assert list(got.tiers) == ["csaf"]
    assert_tiers_match(got, want)
    assert_tables_match(got_out, want_out)
    # The top receives the case's horizontal irradiance with either.
    assert float(got.variable("RSDTCSAF")[0]) == pytest.approx(912.79,
                                                               abs=1.0)
