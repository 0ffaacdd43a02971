"""The port's RFMIP-IRF app writing spectral fluxes (no ``-integrated``)
against the JAX package's: the input file of tests/test_rfmip.py, the
driver golden's line list and tables, LW 1-3,250 cm-1 at 4 and SW
2,000-20,000 at 10, the user level 5; the two files hold the same
variables, dimensions (the wavenumber axes included) and attributes,
values at 1e-4 of each variable's largest, SW spectra at the 5e-3 of
tests/test_torch_driver_batching.py (the float32 two-stream solve is
ill-conditioned at optically thin points in both packages; 7.5e-4 found,
rsdcsaf_level)."""
import h5py
import pytest
import torch

from grtcode_tpu.apps import rfmip as jrfmip
from grtcode_tpu_torch.apps import rfmip
from tests.test_rfmip import NSITE, input_file  # noqa: F401
from tests.test_torch_apps_circ import inputs  # noqa: F401
from tests.test_torch_apps_circ_case import assert_same_files
from tests.test_torch_driver_batching import SW_SPECTRUM_TOL


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_spectral_main_matches_jax(inputs, input_file, tmp_path):  # noqa: F811
    argv = inputs[:2] + [input_file, "1"] + inputs[2:] + [
        "-flux-at-level", "5", "-w-sw", "2000", "-W-sw", "20000"]
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    rfmip.main(argv + ["-o", got], device="cpu")
    jrfmip.main(argv + ["-o", want])
    with h5py.File(got, "r") as f:
        sw = [k for k in f if k.startswith("rs")]
    assert len(sw) == 6
    assert_same_files(got, want, tols=dict.fromkeys(sw, SW_SPECTRUM_TOL))
    with h5py.File(got, "r") as f:
        assert f["rsdtcsaf"].shape == (NSITE, 1801)
        assert f["rlucsaf_level"].shape == (NSITE, 814)
