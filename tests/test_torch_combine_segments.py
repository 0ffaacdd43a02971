"""The port's ERA5 segment combiner (grtcode_tpu_torch/apps/
combine_segments.py, on the port's own netCDF IO) against
tools/combine_segments.py (h5py) on the same segment files, written by the
port's ncio.Writer as the ERA5 app writes them: two and three segments,
``--rebin``, a variable only defined in every segment (it stays
define-only, with no storage), one written in some segments only, the
error for a missing longitude; overlapping segments give the same file in
both (the later segment's values).  The two outputs hold the same
variables with the same shapes, dtypes, fill values and storage, values
bit for bit."""
import h5py
import numpy as np
import pytest

from grtcode_tpu_torch.apps import combine_segments as port
from grtcode_tpu_torch.utils.ncio import Writer
from tools import combine_segments as tool

NLON = 6


def write_segment(path, x0, x1, seed):
    """Longitudes [x0, x1] of a global field of NLON: a (time, level, lat,
    lon) profile, a (time, lat, lon) flux, a (time, lat, lon,
    lw_wavenumber) spectrum, a SW spectrum defined only, and a flux
    written in the segment that starts at 0 only."""
    rng = np.random.default_rng(seed)
    nx = x1 - x0 + 1
    with Writer(path) as w:
        w.create_dimension("time", 1)
        w.create_dimension("lat", 2, values=[-45.0, 45.0])
        w.create_dimension("lon", nx, values=np.arange(x0, x1 + 1) * 60.0)
        w.create_dimension("level", 3)
        w.create_dimension("lw_wavenumber", 7)
        w.create_dimension("sw_wavenumber", 5)
        w.create_variable("p", ("time", "level", "lat", "lon"),
                          rng.uniform(1, 1000, (1, 3, 2, nx)), units="mb")
        w.create_variable("rlut", ("time", "lat", "lon"),
                          rng.uniform(100, 300, (1, 2, nx)), units="W m-2")
        w.create_variable("lw_spectrum", ("time", "lat", "lon",
                                          "lw_wavenumber"),
                          rng.uniform(0, 1, (1, 2, nx, 7)), units="W m-2")
        w.create_variable("sw_spectrum", ("time", "lat", "lon",
                                          "sw_wavenumber"), None,
                          units="W m-2")
        w.create_variable("rsut", ("time", "lat", "lon"),
                          rng.uniform(0, 500, (1, 2, nx)) if x0 == 0
                          else None, units="W m-2")
        w.set_global(lon_start=x0, lon_stop=x1, lon_global_size=NLON)


def segments(tmp_path, spans):
    paths = []
    for i, (x0, x1) in enumerate(spans):
        paths.append(str(tmp_path / f"seg{i}.nc"))
        write_segment(paths[-1], x0, x1, seed=i)
    return paths


def assert_same_content(got, want):
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        assert sorted(g) == sorted(w)
        for name in w:
            a, b = g[name], w[name]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
            assert a.id.get_storage_size() == b.id.get_storage_size(), name
            assert a.fillvalue == b.fillvalue, name
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name


@pytest.mark.parametrize("spans,rebin", [
    (((0, 2), (3, 5)), None), (((0, 1), (2, 3), (4, 5)), None),
    (((0, 2), (3, 5)), 2), (((0, 0), (1, 5)), 3)],
    ids=["two", "three", "two_rebin2", "uneven_rebin3"])
def test_combine_matches_the_tool(tmp_path, spans, rebin):
    segs = segments(tmp_path, spans)
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "tool.nc")
    port.combine(segs, got, rebin=rebin)
    tool.combine(segs, want, rebin=rebin)
    assert_same_content(got, want)
    with h5py.File(got, "r") as f:
        assert sorted(f) == ["lw_spectrum", "p", "rlut", "rsut",
                             "sw_spectrum"]
        assert f["p"].shape == (1, 3, 2, NLON)
        assert f["lw_spectrum"].shape == (1, 2, NLON,
                                          7 // rebin if rebin else 7)
        # Only defined in every segment: still no storage.
        assert f["sw_spectrum"].shape == (1, 2, NLON, 5)
        assert f["sw_spectrum"].id.get_storage_size() == 0
        assert f["sw_spectrum"][0, 0, 0, 0] == Writer.FILL_VALUE
        # Written by the first segment only: its longitudes, fill after.
        rsut = np.asarray(f["rsut"])
        n0 = spans[0][1] + 1
        assert (rsut[..., n0:] == Writer.FILL_VALUE).all()
        assert (rsut[..., :n0] < 1e30).all()


def test_combine_main_matches_the_tool(tmp_path, capsys):
    segs = segments(tmp_path, ((0, 3), (4, 5)))
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "tool.nc")
    port.main(["--rebin", "2", got] + segs)
    assert capsys.readouterr().out.strip() == f"wrote {got}"
    tool.combine(segs, want, rebin=2)
    assert_same_content(got, want)


def test_missing_longitudes_raise_alike(tmp_path):
    segs = segments(tmp_path, ((0, 1), (3, 5)))
    errors = []
    for combine in (port.combine, tool.combine):
        with pytest.raises(ValueError) as err:
            combine(segs, str(tmp_path / "out.nc"))
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "missing lon indices: [2]"


def test_overlapping_segments_combine_alike(tmp_path):
    """Neither combiner checks for overlap: the later segment's values
    stand in both."""
    segs = segments(tmp_path, ((0, 3), (2, 5)))
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "tool.nc")
    port.combine(segs, got)
    tool.combine(segs, want)
    assert_same_content(got, want)
    with h5py.File(got, "r") as f, h5py.File(segs[1], "r") as s:
        assert np.array_equal(f["rlut"][..., 2:], s["rlut"][()])
