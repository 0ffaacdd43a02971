"""The port's RFMIP-IRF app (``grtcode_tpu_torch.apps.rfmip``) against the
JAX package's, on the input file of tests/test_rfmip.py:

* ``load_atmosphere`` is byte-identical to JAX's for each experiment, with
  CFC options and their ``-eq`` aliases, site slices and CIA pairs;
* ``main -integrated -flux-at-level 3 -x 1 -X 3`` on the driver golden's
  line list and tables at the coarse grids writes a file with the same
  variables, dimensions and attributes as JAX's, values at 1e-4 of each
  variable's largest.

Spectral output is in tests/test_torch_apps_rfmip_spectral.py (one JAX
``main`` per file keeps each under 40 s).
"""
import pytest
import torch

from grtcode_tpu.apps import rfmip as jrfmip
from grtcode_tpu_torch.apps import rfmip
from tests.test_rfmip import input_file  # noqa: F401
from tests.test_torch_apps_circ import (assert_atmospheres_identical,  # noqa: F401
                                        inputs)
from tests.test_torch_apps_circ_case import assert_same_files


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(experiment=0), dict(experiment=2),
    dict(experiment=1, cfc_options=("CFC-11", "SF6", "CFC-12")),
    dict(experiment=0, cfc_options=("CFC-11-eq", "HFC-134a-eq")),
    dict(experiment=1, x=1, X=3), dict(experiment=2, x=4),
    dict(experiment=0, cia_pairs=("N2-N2", "O2-N2", "O2-O2")),
    dict(experiment=1, molecules=(1, 3))],
    ids=["e0", "e2", "cfc", "eq", "slice", "last_site", "cia", "molecules"])
def test_load_atmosphere_identical(input_file, kw):  # noqa: F811
    assert_atmospheres_identical(rfmip.load_atmosphere(input_file, **kw),
                                 jrfmip.load_atmosphere(input_file, **kw))


def test_integrated_main_matches_jax(inputs, input_file, tmp_path,  # noqa: F811
                                     capsys):
    argv = inputs[:2] + [input_file, "2"] + inputs[2:] + [
        "-integrated", "-flux-at-level", "3", "-x", "1", "-X", "3"]
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    rfmip.main(argv + ["-o", got], device="cpu")
    jrfmip.main(argv + ["-o", want])
    assert capsys.readouterr().out.splitlines() == [f"wrote {got}",
                                                    f"wrote {want}"]
    assert_same_files(got, want)
