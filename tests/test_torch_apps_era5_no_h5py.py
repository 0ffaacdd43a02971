"""The port's cloudy ERA5 app and segment combiner with no h5py at all:
in a subprocess where ``import h5py`` (and netCDF4) fails, the port writes
the Pade liquid and ice tables with its own HDF5 writer
(``PadeCloudOptics.to_netcdf`` of ``synthetic_pade_table``, seeds 0 and
1, 16 bands over 1-50,000 cm-1) and runs ``apps.era5.main -sw
-integrated -flux-at-level 2 -liquid-path -ice-path`` on the CPU on the
cloudy file of tests/test_torch_apps_era5_clouds.py (tests/test_era5.py's
file with its condensate scaled by 0.01), then on the longitude segments
``-x 0 -X 1`` and ``-x 2 -X 3``, merged by the port's combiner.  The JAX
app (h5py) reads the same inputs and tables: the two whole-domain files
hold the same variables, dimensions and attributes, values at 1e-4 of
each variable's largest (the cloudy test's bar); the port's merged file
equals tools/combine_segments.py's on the same segments bit for bit.
The Pade tables read back equal in both packages."""
import shutil

import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import era5 as jera5
from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu.clouds import pade as jpade
from grtcode_tpu_torch.clouds import pade
from tests.test_era5 import X, era5_file, ghg_file  # noqa: F401
from tests.test_torch_apps_circ import inputs  # noqa: F401
from tests.test_torch_apps_circ_case import assert_same_files
from tests.test_torch_apps_era5 import era5_argv
from tests.test_torch_apps_rfmip_no_h5py import run_without_h5py
from tests.test_torch_combine_segments import assert_same_content
from tests.test_torch_driver_tiers import exact_betainc
from tools.combine_segments import combine as tool_combine


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_cloudy_main_and_combiner_without_h5py(inputs, era5_file,  # noqa: F811
                                               ghg_file, tmp_path,
                                               monkeypatch):
    clouds = str(tmp_path / "era5_clouds.nc")
    shutil.copy(era5_file, clouds)
    with h5py.File(clouds, "a") as f:
        for name in ("clwc", "ciwc"):
            f[name][...] = 0.01 * f[name][...]
    liquid, ice = str(tmp_path / "liquid.nc"), str(tmp_path / "ice.nc")
    argv = era5_argv(inputs, clouds, ghg_file, "-sw", "-integrated",
                     "-flux-at-level", "2", "-liquid-path", liquid,
                     "-ice-path", ice)
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    segs = [str(tmp_path / f"seg{i}.nc") for i in range(2)]
    merged = str(tmp_path / "merged.nc")
    stdout = run_without_h5py(
        "from grtcode_tpu_torch.apps import combine_segments, era5\n"
        "from grtcode_tpu_torch.clouds.pade import synthetic_pade_table\n"
        "for path, seed in ((args['liquid'], 0), (args['ice'], 1)):\n"
        "    synthetic_pade_table(wn=50000.0, seed=seed,\n"
        "                         device='cpu').to_netcdf(path)\n"
        "era5.main(args['argv'] + ['-o', args['got']], device='cpu')\n"
        "spans = ((0, 1), (2, args['X'] - 1))\n"
        "for seg, (x0, x1) in zip(args['segs'], spans):\n"
        "    era5.main(args['argv'] + ['-x', str(x0), '-X', str(x1),\n"
        "                              '-o', seg], device='cpu')\n"
        "combine_segments.main([args['merged']] + args['segs'])\n",
        {"liquid": liquid, "ice": ice, "argv": argv, "got": got,
         "segs": segs, "merged": merged, "X": X})
    assert stdout.splitlines() == [f"wrote {p}" for p in [got] + segs
                                   + [merged]]
    monkeypatch.setattr(jbeta, "betainc", exact_betainc)
    jera5.main(argv + ["-o", want])
    assert_same_files(got, want)
    with h5py.File(got, "r") as f:
        af, csaf = np.asarray(f["rlutaf"]), np.asarray(f["rlutcsaf"])
        assert np.isfinite(af).all() and not np.allclose(af, csaf)
    tool_merged = str(tmp_path / "tool_merged.nc")
    tool_combine(segs, tool_merged)
    assert_same_content(merged, tool_merged)
    with h5py.File(merged, "r") as m:
        assert m["rlutaf"].shape == (2, 3, X)
    for path, seed in ((liquid, 0), (ice, 1)):
        got_t = pade.PadeCloudOptics.from_netcdf(path, "cpu")
        want_t = jpade.PadeCloudOptics.from_netcdf(path)
        want_s = pade.synthetic_pade_table(wn=50000.0, seed=seed,
                                           device="cpu")
        for name in ("band_lims", "sizereg_bounds", "sizereg_ref", "ext_p",
                     "ext_q", "ssa_p", "ssa_q", "asy_p", "asy_q"):
            assert np.array_equal(getattr(got_t, name).numpy(),
                                  np.asarray(getattr(want_t, name))), name
            assert np.array_equal(getattr(got_t, name).numpy(),
                                  getattr(want_s, name).numpy()), name
