"""The port's ERA5 app (``grtcode_tpu_torch.apps.era5``) against the JAX
package's, on the ERA5 and GHG files of tests/test_era5.py:

* ``load_atmosphere`` (the (time, level, lat, lon) reorder, the unit
  conversions, the GHG year, the cloud fields, the zenith derived from
  tisr with its global mean) is byte-identical to JAX's;
* ``main -clear -integrated -flux-at-level 3`` (longwave only, as the
  reference binary runs) on the driver golden's line list and tables at
  the coarse LW grid writes a file with the same variables, dimensions
  and attributes as JAX's, values at 1e-4 of each variable's largest;
* two port runs on the longitude segments ``-x 0 -X 1`` and ``-x 2 -X 3``,
  merged by tools/combine_segments.py, equal the port's run on the whole
  domain (rtol 1e-6, as tests/test_era5.py holds JAX's).

``-sw`` is in tests/test_torch_apps_era5_sw.py and the cloudy run in
tests/test_torch_apps_era5_clouds.py (one JAX ``main`` per file keeps each
under 40 s).
"""
import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import era5 as jera5
from grtcode_tpu.gas_optics.molecules import CfcId
from grtcode_tpu_torch.apps import era5
from tests.test_era5 import X, era5_file, ghg_file  # noqa: F401
from tests.test_torch_apps_circ import (assert_atmospheres_identical,  # noqa: F401
                                        inputs)
from tests.test_torch_apps_circ_case import assert_same_files
from tools.combine_segments import combine


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def era5_argv(inputs, era5_file, ghg_file, *flags):  # noqa: F811
    """The app's argv: the golden's .par and continua, the coarse grids,
    the two netCDF inputs, year 1, ``flags``.  No CFC-eq or CIA tables:
    both packages' ``main`` registers their tables but gives the
    Atmosphere none of their abundances (it never passes ``cia_pairs``,
    and looks ``-CFC-12-eq`` up under another name than argparse stores
    it), so their gas optics raise KeyError (ROADMAP queue 3)."""
    opt = dict(zip(inputs[2:-4:2], inputs[3:-4:2]))
    return inputs[:2] + [era5_file, ghg_file, "-year", "1", "-h2o-ctm",
                         opt["-h2o-ctm"], "-o3-ctm", opt["-o3-ctm"]] + \
        inputs[-4:] + list(flags)


@pytest.mark.parametrize("kw", [
    dict(year=1), dict(year=3, ghg_start_year=1, cfc_eq=(CfcId.CFC12, CfcId.HFC134a),
         clear=False),
    dict(year=2, x=slice(1, 3), y=slice(0, 2), t=slice(1, 2)),
    dict(year=1, derive_zenith=True),
    dict(year=1, x=slice(1, 3), derive_zenith=True, clear=False),
    dict(year=4, molecules=(1,), ghg=(2,), cia_pairs=("N2-N2", "O2-O2"))],
    ids=["default", "clouds", "slab", "zenith", "slab_zenith", "gases"])
def test_load_atmosphere_identical(era5_file, ghg_file, kw):  # noqa: F811
    assert_atmospheres_identical(
        era5.load_atmosphere(era5_file, ghg_file, **kw),
        jera5.load_atmosphere(era5_file, ghg_file, **kw))


def test_clear_main_matches_jax(inputs, era5_file, ghg_file,  # noqa: F811
                                tmp_path):
    argv = era5_argv(inputs, era5_file, ghg_file, "-clear", "-integrated",
                     "-flux-at-level", "3")
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    era5.main(argv + ["-o", got], device="cpu")
    jera5.main(argv + ["-o", want])
    assert_same_files(got, want)


def test_segments_merge_to_the_whole_run(inputs, era5_file,  # noqa: F811
                                         ghg_file, tmp_path):
    argv = era5_argv(inputs, era5_file, ghg_file, "-clear", "-integrated",
                     "-flux-at-level", "3")
    whole = str(tmp_path / "whole.nc")
    era5.main(argv + ["-o", whole], device="cpu")
    segments = []
    for i, (x0, x1) in enumerate(((0, 1), (2, X - 1))):
        segments.append(str(tmp_path / f"seg{i}.nc"))
        era5.main(argv + ["-x", str(x0), "-X", str(x1), "-o", segments[-1]],
                  device="cpu")
    merged = str(tmp_path / "merged.nc")
    combine(segments, merged)
    with h5py.File(merged, "r") as m, h5py.File(whole, "r") as w:
        for name in ("rlutcsaf", "rldscsaf", "rluscsaf", "rlucsaf_level",
                     "p", "t_layer"):
            assert m[name].shape == w[name].shape, name
            np.testing.assert_allclose(np.asarray(m[name]),
                                       np.asarray(w[name]), rtol=1e-6,
                                       err_msg=name)
        assert np.asarray(w["rlutcsaf"]).max() > 0
