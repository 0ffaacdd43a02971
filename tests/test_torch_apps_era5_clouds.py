"""The port's ERA5 app with clouds (no ``-clear``: the AF tier, Pade
liquid and ice optics read from ``-liquid-path`` / ``-ice-path``) against
the JAX package's: the files of tests/test_era5.py, Pade files written by
h5py from ``synthetic_pade_table`` (16 bands over 1-50,000 cm-1), LW at 4
and SW at 10 with ``-sw``.  The condensate of that file is scaled by 0.01:
its eight levels make layers 1.3-33 km thick, and at full strength the
clouds reach optical depths in the thousands, where both packages' float32
longwave solve gives the same non-physical fluxes (NaN, or an OLR of
4,430 W m-2 at a scale of 0.05; ROADMAP queue 3).  The stochastic cloud
draws are jax.random's in
both (grtcode_tpu_torch.utils.prng); the JAX side runs with the exact
incomplete beta, as tests/test_torch_driver_tiers.py does.  The two files
hold the same variables, dimensions and attributes, values at 1e-4 of each
variable's largest."""
import shutil

import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import era5 as jera5
from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu_torch.apps import era5
from grtcode_tpu_torch.clouds.pade import synthetic_pade_table
from tests.test_era5 import era5_file, ghg_file  # noqa: F401
from tests.test_torch_apps_circ import inputs  # noqa: F401
from tests.test_torch_apps_circ_case import assert_same_files
from tests.test_torch_apps_era5 import era5_argv
from tests.test_torch_driver_tiers import exact_betainc


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def write_pade(path, table):
    """An RRTMGP-style Pade file of ``table`` ((coef, sizereg, band)
    coefficient layout)."""
    def host(t):
        return t.cpu().numpy().astype(np.float64)

    with h5py.File(path, "w") as f:
        f["Band_limits_lwr"], f["Band_limits_upr"] = host(table.band_lims)
        f["Effective_Radius_limits_lwr"], \
            f["Effective_Radius_limits_upr"] = host(table.sizereg_bounds)
        f["Effective_Radius_Ref"] = host(table.sizereg_ref)
        for name in ("ext_p", "ext_q", "ssa_p", "ssa_q", "asy_p", "asy_q"):
            f[f"Pade_{name}"] = host(getattr(table, name)).transpose(2, 1, 0)


def test_cloudy_main_matches_jax(inputs, era5_file, ghg_file,  # noqa: F811
                                 tmp_path, monkeypatch):
    clouds = str(tmp_path / "era5_clouds.nc")
    shutil.copy(era5_file, clouds)
    with h5py.File(clouds, "a") as f:
        for name in ("clwc", "ciwc"):
            f[name][...] = 0.01 * f[name][...]
    liquid, ice = str(tmp_path / "liquid.nc"), str(tmp_path / "ice.nc")
    write_pade(liquid, synthetic_pade_table(wn=50000.0, seed=0,
                                            device="cpu"))
    write_pade(ice, synthetic_pade_table(wn=50000.0, seed=1,
                                         device="cpu"))
    argv = era5_argv(inputs, clouds, ghg_file, "-sw", "-integrated",
                     "-flux-at-level", "2", "-liquid-path", liquid,
                     "-ice-path", ice)
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    era5.main(argv + ["-o", got], device="cpu")
    monkeypatch.setattr(jbeta, "betainc", exact_betainc)
    jera5.main(argv + ["-o", want])
    assert_same_files(got, want)
    with h5py.File(got, "r") as f:
        af, csaf = np.asarray(f["rlutaf"]), np.asarray(f["rlutcsaf"])
        assert np.isfinite(af).all() and not np.allclose(af, csaf)
        # Clouds dim the surface; nothing exceeds the incoming sunlight.
        rsds = np.asarray(f["rsdsaf"])
        assert (rsds <= np.asarray(f["rsdscsaf"]) + 1e-3).all()
        assert (rsds <= np.asarray(f["rsdtaf"]) + 1e-3).all()
