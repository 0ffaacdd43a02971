"""The port's RFMIP-IRF app with no h5py at all: in a subprocess where
``import h5py`` (and netCDF4) fails, the port writes the input file of
tests/test_rfmip.py with its own HDF5 writer
(``examples.write_rfmip_input`` at that test's 5 sites, 3 experiments and
10 layers) and runs ``apps.rfmip.main -integrated -flux-at-level 3 -x 1
-X 3`` on the CPU.  The JAX app (h5py) reads the same input; the two
output files hold the same variables, dimensions and attributes, values
at 1e-4 of each variable's largest (tests/test_torch_apps_rfmip.py's
bar).  The input the port writes is the one h5py writes for
tests/test_rfmip.py, value for value."""
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import rfmip as jrfmip
from grtcode_tpu_torch import examples
from tests.test_rfmip import NEXPT, NLAYER, NSITE, input_file  # noqa: F401
from tests.test_torch_apps_circ import inputs  # noqa: F401
from tests.test_torch_apps_circ_case import assert_same_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run with h5py and netCDF4 blocked: any import of either raises.
NO_H5PY = """
import json, sys
sys.modules["h5py"] = None
sys.modules["netCDF4"] = None
import torch
torch.set_num_threads(2)
args = json.loads(sys.argv[1])
"""


def run_without_h5py(body: str, args: dict):
    """Run ``body`` in a fresh interpreter with h5py blocked; it must not
    load JAX or the JAX package either."""
    code = NO_H5PY + body + (
        "\nassert sys.modules['h5py'] is None\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(k.split('.')[0] == 'grtcode_tpu' "
        "for k in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_port_writes_the_tests_input(input_file, tmp_path):  # noqa: F811
    path = str(tmp_path / "port_input.nc")
    examples.write_rfmip_input(path, NSITE, NEXPT, NLAYER)
    with h5py.File(path, "r") as a, h5py.File(input_file, "r") as b:
        assert sorted(a) == sorted(b)
        for name in b:
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name][()], b[name][()]), name
            assert dict(a[name].attrs) == dict(b[name].attrs), name
            assert all(type(v) is str for v in a[name].attrs.values())


def test_main_without_h5py_matches_jax(inputs, tmp_path):  # noqa: F811
    input_path = str(tmp_path / "rfmip.nc")
    argv = inputs[:2] + [input_path, "2"] + inputs[2:] + [
        "-integrated", "-flux-at-level", "3", "-x", "1", "-X", "3"]
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    stdout = run_without_h5py(
        "from grtcode_tpu_torch import examples\n"
        "from grtcode_tpu_torch.apps import rfmip\n"
        "examples.write_rfmip_input(args['input'], 5, 3, 10)\n"
        "rfmip.main(args['argv'], device='cpu')\n",
        {"input": input_path, "argv": argv + ["-o", got]})
    assert stdout.splitlines() == [f"wrote {got}"]
    jrfmip.main(argv + ["-o", want])
    assert_same_files(got, want)
