"""The port's ERA5 app with ``-sw`` (the shortwave with the zenith derived
from tisr, which the reference binary leaves out) against the JAX
package's: the files of tests/test_era5.py, the driver golden's line list
and tables, LW at 4 and SW 1-50,000 cm-1 at 10, integrated; the two output
files hold the same variables, dimensions and attributes, values at 1e-4
of each variable's largest."""
import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import era5 as jera5
from grtcode_tpu_torch.apps import era5
from tests.test_era5 import era5_file, ghg_file  # noqa: F401
from tests.test_torch_apps_circ import inputs  # noqa: F401
from tests.test_torch_apps_circ_case import assert_same_files
from tests.test_torch_apps_era5 import era5_argv


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_sw_main_matches_jax(inputs, era5_file, ghg_file,  # noqa: F811
                             tmp_path):
    argv = era5_argv(inputs, era5_file, ghg_file, "-clear", "-sw",
                     "-integrated")
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    era5.main(argv + ["-o", got], device="cpu")
    jera5.main(argv + ["-o", want])
    assert_same_files(got, want)
    with h5py.File(got, "r") as f:
        rsdt = np.asarray(f["rsdtcsaf"])
        assert rsdt.max() > 100.0 and (rsdt >= 0).all()
