"""The port's CIRC app on a CIRC case file with ``-o`` against the JAX
package's: the case file of tests/test_circ_case.py (aerosols on, as the
app runs case files), the driver golden's input files, the coarse grids.
Both runs' CSAF and CS fluxes match at 1e-4 (worst relative, the golden's
1 % floor), and the two output files hold the same variables, dimensions
and attributes, with values at 1e-4 of each variable's largest.
"""
import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import circ as jcirc
from grtcode_tpu_torch.apps import circ
from tests.test_circ_case import NLEV, case_file  # noqa: F401
from tests.test_torch_apps_circ import assert_tiers_match, inputs  # noqa: F401
from tests.test_torch_driver import TOLERANCE

# HDF5 dimension-scale bookkeeping: object references into each file.
_REFERENCE_ATTRS = ("DIMENSION_LIST", "REFERENCE_LIST")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _attrs(obj):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in obj.attrs.items() if k not in _REFERENCE_ATTRS}


def assert_same_files(got_path, want_path, tol=TOLERANCE, tols=None):
    """The two netCDF files hold the same variables (shape, dtype,
    attributes, the dimensions each is attached to) and global attributes;
    values agree within ``tol`` (``tols[name]`` where given) of each
    variable's largest magnitude, and fill values (variables never
    written) are where the other file has them."""
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        assert sorted(g) == sorted(w)
        assert _attrs(g) == _attrs(w)
        for name in w:
            a, b = g[name], w[name]
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert _attrs(a) == _attrs(b), name
            assert [[s.name for s in d.values()] for d in a.dims] == \
                [[s.name for s in d.values()] for d in b.dims], name
            av, bv = np.asarray(a, np.float64), np.asarray(b, np.float64)
            scale = max(float(np.abs(bv).max()), 1e-30) if bv.size else 1.0
            bound = (tols or {}).get(name, tol) * scale
            assert np.abs(av - bv).max(initial=0.0) <= bound, name


def test_case_file_main_matches_jax(inputs, case_file, tmp_path):  # noqa: F811
    got_path, want_path = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    got = circ.main(inputs + [case_file, "-o", got_path], device="cpu")
    want = jcirc.main(inputs + [case_file, "-o", want_path])
    assert sorted(got.tiers) == ["cs", "csaf"]
    assert_tiers_match(got, want)
    assert_same_files(got_path, want_path)
    with h5py.File(got_path, "r") as f:
        assert sorted(f) == ["level", "rld", "rlu", "rsd", "rsu"]
        assert f["rsd"].shape == (NLEV,)
        assert f["rsd"].attrs["standard_name"] == \
            "downwelling_shortwave_flux_in_air"
