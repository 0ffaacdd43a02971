"""The port's netCDF-4 IO in numpy alone (grtcode_tpu_torch/utils/
hdf5.py and utils/ncio.py) against h5py and the JAX package's ncio.

The reader reads h5py-written fixture files (tests/data/torch_ncio/,
written by :func:`write_fixtures`, regenerated by a test) equal to h5py
and to the generator's values, bit for bit: every dataset, the hyperslabs
the apps read and every attribute.  Features it does not decode raise
``NotImplementedError`` naming the feature and the file.  The port's
``ncio.Writer`` writes files that h5py reads equal to the JAX ``Writer``'s
on the same calls (values, attributes and their types, dimension scales,
fill values, no storage for variables only defined).

The fixtures:

* ``defaults.h5``: h5py's defaults (superblock v0, symbol-table groups, v1
  object headers): numbers of several types, scalars, a subgroup, chunked
  gzip data with edge chunks and a two-level chunk B-tree, dimension
  scales, attributes of every kind h5py writes (variable-length strings,
  fixed-length bytes, numbers and arrays of them);
* ``v108.h5``: ``libver=("v108", "v108")`` with ``track_order=True``, the
  bounds netCDF-C writes with: 12 variables and more than 8 attributes on
  the root and on a variable (dense links and attributes), chunked deflate
  + shuffle + fletcher32 with edge chunks, a chunk never written, an
  unlimited dimension, big-endian variables, and netCDF's fixed-length
  NULLTERM ``NC_CHAR`` attributes;
* ``latest.h5``: ``libver="latest"`` (superblock v3, layout v4): the
  single-chunk (plain and filtered), implicit and fixed-array (plain,
  filtered and paged, with a page never written) chunk indexes, compact
  and contiguous storage;
* ``unallocated.h5``: variables defined and never written (contiguous and
  chunked), a zero-size variable.

``expected.npz`` holds every dataset's values as the generator meant them
(written data, the fill value where nothing was written), under
``"<file>/<dataset path>"``.  Regenerate the committed files with

    python -m tests.test_torch_ncio tests/data/torch_ncio
"""
import os
import sys

import h5py
import numpy as np
import pytest

from grtcode_tpu.utils import ncio as jncio
from grtcode_tpu_torch.utils import hdf5, ncio
from tests.test_torch_apps_circ_case import assert_same_files

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_ncio")

FILES = ("defaults.h5", "v108.h5", "latest.h5", "unallocated.h5")
UNITS_NC_CHAR = "1e-06"


def _nc_char(obj, name: str, text: str):
    """A netCDF-C ``NC_CHAR`` attribute: fixed-length ASCII, NULLTERM, no
    room for the terminator."""
    tid = h5py.h5t.C_S1.copy()
    tid.set_size(len(text))
    tid.set_strpad(h5py.h5t.STR_NULLTERM)
    aid = h5py.h5a.create(obj.id, name.encode(), tid,
                          h5py.h5s.create(h5py.h5s.SCALAR))
    aid.write(np.array(text.encode(), f"S{len(text)}"), mtype=tid)


def _low_level(f, name, data, layout, chunks=None):
    """A dataset of layout "compact" or "implicit" (chunked, allocated
    early, no filters), which h5py's high-level calls do not make."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    else:
        dcpl.set_chunk(chunks)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    space = h5py.h5s.create_simple(data.shape)
    dsid = h5py.h5d.create(f.id, name.encode(),
                           h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def write_fixtures(out_dir: str) -> dict:
    """Write the four files into ``out_dir``; returns (and saves as
    ``expected.npz``) the values of every dataset."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261017)
    exp = {}

    def put(fname, path, value):
        exp[f"{fname}/{path}"] = np.asarray(value)

    # -- h5py's defaults.
    with h5py.File(os.path.join(out_dir, "defaults.h5"), "w") as f:
        data = {
            "f32_2d": rng.standard_normal((5, 7)).astype(np.float32),
            "f64_3d": rng.standard_normal((3, 4, 5)),
            "i32": rng.integers(-1000, 1000, 10).astype(np.int32),
            "u8": rng.integers(0, 255, 6).astype(np.uint8),
            "i64_scalar": np.int64(-123456789012),
            "f64_scalar": np.float64(2.718281828459045),
        }
        for k, v in data.items():
            f.create_dataset(k, data=v)
            put("defaults.h5", k, v)
        v = rng.standard_normal((7, 9)).astype(np.float32)
        f.create_dataset("chunked_gzip", data=v, chunks=(3, 4),
                         compression="gzip")
        put("defaults.h5", "chunked_gzip", v)
        # 10 x 9 = 90 chunks: more than one node of 64 (K = 32).
        v = rng.standard_normal((40, 33))
        f.create_dataset("chunked_many", data=v, chunks=(4, 4))
        put("defaults.h5", "chunked_many", v)
        g = f.create_group("grp")
        v = np.arange(4, dtype=np.float32) * 0.5
        g.create_dataset("inner", data=v)
        g.attrs["comment"] = "in a group"
        put("defaults.h5", "grp/inner", v)
        for name, n in (("x", 5), ("y", 7)):
            f.create_dataset(name, data=np.arange(n, dtype=np.float64))
            f[name].make_scale(name)
            put("defaults.h5", name, np.arange(n, dtype=np.float64))
        f["f32_2d"].dims[0].attach_scale(f["x"])
        f["f32_2d"].dims[1].attach_scale(f["y"])
        f["f32_2d"].attrs["units"] = "W m-2"
        f["f32_2d"].attrs["level"] = 3
        f.attrs["title"] = "fixture: h5py defaults"
        f.attrs["version"] = 7
        f.attrs["scale"] = 0.25
        f.attrs["arr"] = np.array([1.5, -2.0, 3.25])
        f.attrs["int_arr"] = np.array([1, -2, 3], np.int16)
        f.attrs["fixed"] = np.bytes_(b"fixed bytes")
        f.attrs["fixed_arr"] = np.array([b"ab", b"cde"])
        f.attrs["vlen_arr"] = ["one", "two", "three"]
        f.attrs["unicode"] = "W m⁻²"

    # -- HDF5 1.8 bounds with creation order (netCDF-C's layout).
    with h5py.File(os.path.join(out_dir, "v108.h5"), "w",
                   libver=("v108", "v108"), track_order=True) as f:
        for i in range(12):
            v = rng.standard_normal((6, 5)).astype(np.float32)
            f.create_dataset(f"var{i:02d}", data=v, track_order=True)
            put("v108.h5", f"var{i:02d}", v)
        ds = f["var00"]
        for i in range(12):
            ds.attrs[f"attr{i:02d}"] = i * 1.5 if i % 2 else f"text {i}"
        _nc_char(f["var01"], "units", UNITS_NC_CHAR)
        f["var02"].attrs["units"] = UNITS_NC_CHAR
        for i in range(5):     # added one at a time: continuation blocks
            f["var03"].attrs[f"late{i}"] = np.arange(i + 1, dtype=np.int32)
        for i in range(10):
            f.attrs[f"global{i:02d}"] = np.int64(i) if i % 2 else \
                f"global text {i}"
        _nc_char(f, "_NCProperties", "version=2,netcdf=4.9.2")
        v = rng.standard_normal((4, 6)).astype(">f4")
        f.create_dataset("big_endian", data=v)
        put("v108.h5", "big_endian", v)
        v = rng.integers(-30000, 30000, 5).astype(">i2")
        f.create_dataset("big_endian_i2", data=v)
        put("v108.h5", "big_endian_i2", v)
        v = rng.standard_normal((13, 11)).astype(np.float32)
        f.create_dataset("filtered", data=v, chunks=(4, 5), shuffle=True,
                         compression="gzip", compression_opts=6,
                         fletcher32=True)
        put("v108.h5", "filtered", v)
        v = rng.standard_normal(9)
        f.create_dataset("filtered_f64", data=v, chunks=(4,), shuffle=True,
                         compression="gzip")
        put("v108.h5", "filtered_f64", v)
        ds = f.create_dataset("partial", shape=(8, 8), dtype=np.float32,
                              chunks=(4, 4), fillvalue=-1.0)
        v = np.full((8, 8), -1.0, np.float32)
        v[:4, :4] = rng.standard_normal((4, 4))
        ds[:4, :4] = v[:4, :4]
        put("v108.h5", "partial", v)
        v = rng.standard_normal((5, 3)).astype(np.float32)
        f.create_dataset("unlimited", data=v, maxshape=(None, 3),
                         chunks=(2, 3))
        put("v108.h5", "unlimited", v)

    # -- the latest format: layout v4 chunk indexes.
    with h5py.File(os.path.join(out_dir, "latest.h5"), "w",
                   libver="latest") as f:
        v = rng.standard_normal((6, 4)).astype(np.float32)
        f.create_dataset("single", data=v, chunks=(6, 4))
        put("latest.h5", "single", v)
        v = rng.standard_normal((5, 5))
        f.create_dataset("single_filtered", data=v, chunks=(5, 5),
                         compression="gzip")
        put("latest.h5", "single_filtered", v)
        v = rng.standard_normal((10, 12)).astype(np.float32)
        f.create_dataset("fixed", data=v, chunks=(3, 5))
        put("latest.h5", "fixed", v)
        f.create_dataset("fixed_filtered", data=v, chunks=(3, 5),
                         shuffle=True, compression="gzip", fletcher32=True)
        put("latest.h5", "fixed_filtered", v)
        # 3,000 chunks of one element: three pages of 1,024 entries, the
        # second never written.
        ds = f.create_dataset("fixed_paged", shape=(3000,), dtype=np.int32,
                              chunks=(1,), fillvalue=-5)
        v = np.full(3000, -5, np.int32)
        v[:1000] = np.arange(1000)
        v[2100:2200] = -np.arange(100)
        ds[:1000], ds[2100:2200] = v[:1000], v[2100:2200]
        put("latest.h5", "fixed_paged", v)
        v = rng.standard_normal((8, 6)).astype(np.float32)
        _low_level(f, "implicit", v, "implicit", (4, 3))
        put("latest.h5", "implicit", v)
        v = rng.integers(-99, 99, 10).astype(np.int16)
        _low_level(f, "compact", v, "compact")
        put("latest.h5", "compact", v)
        v = rng.standard_normal(7)
        f.create_dataset("contig", data=v)
        f["contig"].attrs["units"] = "K"
        f["fixed"].attrs["long_name"] = np.bytes_(b"a fixed array")
        f.attrs["title"] = "fixture: latest"
        f.attrs["count"] = np.int32(3)
        put("latest.h5", "contig", v)

    # -- storage never allocated.
    with h5py.File(os.path.join(out_dir, "unallocated.h5"), "w") as f:
        fill = np.float32(9.96921e36)
        f.create_dataset("never_written", shape=(4, 5), dtype=np.float32,
                         fillvalue=fill)
        put("unallocated.h5", "never_written", np.full((4, 5), fill))
        f.create_dataset("never_written_chunked", shape=(6,),
                         dtype=np.float64, chunks=(3,), fillvalue=-7.5)
        put("unallocated.h5", "never_written_chunked", np.full(6, -7.5))
        v = np.array([1.0, 2.0, 3.0], np.float32)
        f.create_dataset("written", data=v)
        put("unallocated.h5", "written", v)
        f.create_dataset("zero_size", shape=(0, 3), dtype=np.float32)
        f["never_written"].attrs["units"] = "W m-2"
        f["never_written"].attrs["_dims"] = np.array([b"lat", b"lon"])
        f.attrs["lon_start"] = 0
        put("unallocated.h5", "zero_size", np.zeros((0, 3), np.float32))

    np.savez(os.path.join(out_dir, "expected.npz"), **exp)
    return exp


def _datasets(g, prefix=""):
    """Every dataset path under an h5py group."""
    out = []
    for k in g:
        if isinstance(g[k], h5py.Group):
            out += _datasets(g[k], f"{prefix}{k}/")
        else:
            out.append(prefix + k)
    return out


def _same(got, want):
    """Equal bit for bit, with the same Python type and dtype."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype
        if want.dtype == object:
            assert got.shape == want.shape
            for a, b in zip(got.ravel(), want.ravel()):
                _same(a, b)
        else:
            assert got.shape == want.shape and got.tobytes() == want.tobytes()
    else:
        assert got == want


# DIMENSION_LIST / REFERENCE_LIST hold object references, which h5py gives
# as Reference objects; the reader decodes them far enough to skip them.
_REFERENCE_ATTRS = ("DIMENSION_LIST", "REFERENCE_LIST")


def test_committed_fixtures_hold_the_generators_values(tmp_path):
    fresh = write_fixtures(str(tmp_path))
    committed = np.load(os.path.join(DATA, "expected.npz"))
    assert sorted(committed.files) == sorted(fresh)
    for key, value in fresh.items():
        _same(committed[key], value)
        fname, _, path = key.partition("/")
        with h5py.File(os.path.join(DATA, fname), "r") as f:
            _same(np.asarray(f[path][()]), value)


@pytest.mark.parametrize("fname", FILES)
def test_reader_reads_every_dataset(fname):
    expected = np.load(os.path.join(DATA, "expected.npz"))
    path = os.path.join(DATA, fname)
    with h5py.File(path, "r") as h, hdf5.File(path) as r:
        names = _datasets(h)
        assert sorted(r.keys()) == sorted(h.keys())
        assert len(names) == sum(k.startswith(fname + "/")
                                 for k in expected.files)
        for name in names:
            got, want = r[name].read(), h[name][()]
            _same(np.asarray(got), np.asarray(want))
            _same(np.asarray(got), expected[f"{fname}/{name}"])
            assert r[name].shape == h[name].shape
            assert r[name].allocated == (h[name].id.get_storage_size() > 0)
            assert np.asarray(r[name].fillvalue).tobytes() == \
                np.asarray(h[name].fillvalue).tobytes(), name


def _selections(shape):
    """The hyperslabs the apps read (an index per leading axis, slices of
    sites / lat / lon / levels, the whole of trailing axes), with steps."""
    def idx(n):
        return sorted({0, min(1, n - 1), n - 1})

    sels = [()]
    if not shape or 0 in shape:
        return sels
    n0 = shape[0]
    for i in idx(n0):
        sels += [(i,), (i - n0,)]
    sels += [(slice(1, None),), (slice(None, None, 2),),
             (slice(min(2, n0 - 1), min(5, n0)),), (slice(n0, None),)]
    if len(shape) >= 2:
        n1 = shape[1]
        sels += [(i, slice(None)) for i in idx(n0)]
        sels += [(slice(None), j) for j in idx(n1)]
        sels += [(slice(1, 3), slice(1, None, 2)),
                 (slice(0, n0, 3), slice(n1 // 2, n1)),
                 (idx(n0)[-1], slice(0, 2))]
    if len(shape) >= 3:
        sels += [(0, slice(1, 3)), (slice(None), slice(None), 1),
                 (-1, slice(None), slice(0, 2)),
                 (slice(None), slice(1, None), slice(None, None, 3))]
    return sels


@pytest.mark.parametrize("fname", FILES)
def test_reader_reads_hyperslabs(fname):
    path = os.path.join(DATA, fname)
    n = 0
    with h5py.File(path, "r") as h, hdf5.File(path) as r:
        for name in _datasets(h):
            for sel in _selections(h[name].shape):
                _same(np.asarray(r[name].read(sel)), np.asarray(h[name][sel]))
                n += 1
    assert n > 40


@pytest.mark.parametrize("fname", FILES)
def test_reader_reads_every_attribute(fname):
    path = os.path.join(DATA, fname)
    with h5py.File(path, "r") as h, hdf5.File(path) as r:
        objects = [("/", h, r)] + [(n, h[n], r[n]) for n in _datasets(h)]
        if "grp" in h:
            objects.append(("grp", h["grp"], r["grp"]))
        seen = 0
        for name, ho, ro in objects:
            assert sorted(ro.attrs.keys()) == sorted(ho.attrs.keys()), name
            for k in ho.attrs:
                if k in _REFERENCE_ATTRS:
                    assert len(ro.attrs[k]) == len(ho.attrs[k])
                    continue
                _same(ro.attrs[k], ho.attrs[k])
                seen += 1
        assert seen >= 3


def test_fixtures_cover_the_format_features():
    """The fixtures reach the structures the reader decodes."""
    def btree_level(f, addr):
        return f._read(addr, 6)[5]

    with hdf5.File(os.path.join(DATA, "defaults.h5")) as f:
        assert f._root._msg(hdf5._SYMBOL_TABLE) is not None
        many = f["chunked_many"]
        assert many._index == "btree1" and \
            btree_level(f, many._addr) > 0            # two-level chunk tree
        assert len(list(many._chunks())) == 90
    with hdf5.File(os.path.join(DATA, "v108.h5")) as f:
        info = f._root._msg(hdf5._LINK_INFO)
        info.skip(2 + 8)                              # creation order kept
        assert info.addr() != hdf5.UNDEF              # dense links
        for obj in (f._root, f["var00"]):
            info = obj._msg(hdf5._ATTR_INFO)
            info.skip(2 + 2)
            assert info.addr() != hdf5.UNDEF          # dense attributes
        assert [f[n]._filters for n in ("filtered",)] == [
            [(2, [4]), (1, [6]), (3, [])]]
        assert not f["partial"].allocated or \
            len(list(f["partial"]._chunks())) == 1    # three never written
        assert f["big_endian"].dtype == np.dtype(">f4")
    with hdf5.File(os.path.join(DATA, "latest.h5")) as f:
        assert {n: f[n]._index for n in ("single", "single_filtered",
                                        "fixed", "fixed_filtered",
                                        "fixed_paged", "implicit")} == {
            "single": "single", "single_filtered": "single",
            "fixed": "fixed", "fixed_filtered": "fixed",
            "fixed_paged": "fixed", "implicit": "implicit"}
        assert f["single_filtered"]._single[0] is not None
        assert f["compact"]._kind == "compact"
        entries = f["fixed_paged"]._fixed_array()
        assert len(entries) == 3000
        assert all(a == hdf5.UNDEF for a, _, _ in entries[1024:2048])
    for fname in ("v108.h5", "latest.h5"):
        with open(os.path.join(DATA, fname), "rb") as fh:
            assert b"OCHK" in fh.read()               # continuation blocks


def test_reader_reads_only_the_intersecting_chunks(monkeypatch):
    decoded = []
    real = hdf5.Dataset._decode_chunk

    def counting(self, raw, mask):
        decoded.append(self.name)
        return real(self, raw, mask)

    monkeypatch.setattr(hdf5.Dataset, "_decode_chunk", counting)
    with hdf5.File(os.path.join(DATA, "defaults.h5")) as f:
        f["chunked_many"].read((slice(4, 8), slice(5, 7)))
        assert len(decoded) == 1
        f["chunked_many"].read((slice(3, 5), 0))
        assert len(decoded) == 3


def test_units_decode_to_str():
    """``float(nc.attr(var, "units"))``, as rfmip.py reads the GM scalars'
    units, whether netCDF-C stored them fixed-length or h5py
    variable-length."""
    with ncio.Dataset(os.path.join(DATA, "v108.h5")) as nc:
        for var in ("var01", "var02"):
            units = nc.attr(var, "units")
            assert type(units) is str and units == UNITS_NC_CHAR
            assert float(units) == 1e-6
        assert nc.attr("/", "_NCProperties") == "version=2,netcdf=4.9.2"


def _unsupported(path, feature):
    """A file with one feature the reader does not decode, as h5py writes
    it; returns the dataset name to read."""
    ext = str(path) + ".raw"
    with h5py.File(path, "w", libver="latest") as f:
        if feature == "extensible-array chunk index":
            f.create_dataset("x", data=np.ones(4), maxshape=(None,),
                             chunks=(2,))
        elif feature == "v2-B-tree chunk index":
            f.create_dataset("x", data=np.ones((2, 2)),
                             maxshape=(None, None), chunks=(1, 1))
        elif feature == "the lzf filter":
            f.create_dataset("x", data=np.ones(4), compression="lzf")
        elif feature == "external storage":
            f.create_dataset("x", shape=(4,), dtype="f8",
                             external=[(ext, 0, 32)])
        elif feature == "soft or external link":
            f.create_dataset("y", data=np.ones(2))
            f["x"] = h5py.SoftLink("/y")
        elif feature == "shared object header message":
            f["t"] = np.dtype("f4")
            f.create_dataset("x", shape=(2,), dtype=f["t"])
        elif feature == "datatype class 8":
            f.create_dataset("x", data=np.arange(3, dtype="i1"),
                             dtype=h5py.enum_dtype({"a": 0, "b": 1, "c": 2},
                                                   basetype="i1"))
        elif feature == "virtual dataset":
            f.create_dataset("y", data=np.ones(3))
            layout = h5py.VirtualLayout(shape=(3,), dtype="f8")
            layout[:] = h5py.VirtualSource(f["y"])
            f.create_virtual_dataset("x", layout)
    return "x"


@pytest.mark.parametrize("feature", [
    "extensible-array chunk index", "v2-B-tree chunk index",
    "the lzf filter", "external storage", "soft or external link",
    "shared object header message", "virtual dataset",
    "datatype class 8"])
def test_unsupported_features_raise(tmp_path, feature):
    path = str(tmp_path / "unsupported.h5")
    name = _unsupported(path, feature)
    with pytest.raises(NotImplementedError) as err, hdf5.File(path) as f:
        f[name].read()
    assert feature in str(err.value) and path in str(err.value)


def test_netcdf3_and_other_files_raise(tmp_path):
    cdf = tmp_path / "classic.nc"
    cdf.write_bytes(b"CDF\x01" + bytes(60))
    with pytest.raises(NotImplementedError, match="netCDF-3"):
        hdf5.File(str(cdf))
    junk = tmp_path / "junk.nc"
    junk.write_bytes(bytes(2048))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(str(junk))


def _write_with(writer, path):
    """The same ncio.Writer calls through either package: the dimension
    and variable kinds the apps write (coordinates with and without
    values, profiles, fluxes, spectra, a variable only defined, int and
    float attributes, global attributes), more than 8 of them."""
    rng = np.random.default_rng(3)
    with writer(path) as w:
        w.create_dimension("time", 2)
        w.create_dimension("lat", 3, values=[-30.0, 0.0, 30.0])
        w.create_dimension("lon", 4, values=np.arange(4) * 90.0)
        w.create_dimension("level", 5)
        w.create_dimension("lw_wavenumber", 6,
                           values=np.linspace(1.0, 1.5, 6))
        for i in range(12):
            w.create_variable(f"flux{i:02d}", ("time", "lat", "lon"),
                              rng.uniform(0, 400, (2, 3, 4)),
                              units="W m-2", standard_name=f"flux {i}")
        w.create_variable("p", ("time", "level", "lat", "lon"),
                          rng.uniform(1, 1000, (2, 5, 3, 4)), units="mb",
                          standard_name="air_pressure")
        w.create_variable("spectrum", ("time", "lat", "lon",
                                       "lw_wavenumber"),
                          rng.uniform(0, 1, (2, 3, 4, 6)), units="W m-2 cm")
        w.create_variable("undefined", ("time", "lat", "lon",
                                        "lw_wavenumber"), None,
                          units="W m-2", standard_name="never written",
                          level=-1)
        w.create_variable("user", ("time", "lat", "lon"),
                          rng.uniform(0, 1, (2, 3, 4)), units="W m-2",
                          level=3, weight=0.5)
        w.create_variable("plain", ("level",), np.arange(5.0))
        w.set_global(lon_start=0, lon_stop=3, lon_global_size=4,
                     title="written by ncio.Writer", scale=1.5)


def test_writer_matches_the_jax_writer(tmp_path):
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    _write_with(ncio.Writer, got)
    _write_with(jncio.Writer, want)
    assert_same_files(got, want, tol=0.0)
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        assert len(g) == 22
        for name in w:
            a, b = g[name], w[name]
            assert a.id.get_storage_size() == b.id.get_storage_size(), name
            assert a.fillvalue == b.fillvalue, name
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
            for k in b.attrs:
                if k not in _REFERENCE_ATTRS:
                    _same(a.attrs[k], b.attrs[k])
            assert a.is_scale == b.is_scale, name
        assert g["undefined"].id.get_storage_size() == 0
        assert g["undefined"][0, 0, 0, 0] == ncio.Writer.FILL_VALUE
        assert g["lat"].attrs["CLASS"] == b"DIMENSION_SCALE"
        assert g["lat"].attrs["NAME"] == b"lat"


def test_port_reader_reads_both_writers_alike(tmp_path):
    got, want = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    _write_with(ncio.Writer, got)
    _write_with(jncio.Writer, want)
    with hdf5.File(got) as a, hdf5.File(want) as b, \
            h5py.File(want, "r") as h:
        assert a.keys() == b.keys() == sorted(h)
        for name in b.keys():
            _same(a[name].read(), b[name].read())
            _same(b[name].read(), h[name][()])
            assert a[name].allocated == b[name].allocated == \
                (h[name].id.get_storage_size() > 0)
            for k in b[name].attrs:
                if k not in _REFERENCE_ATTRS:
                    _same(a[name].attrs[k], b[name].attrs[k])
        for k in b.attrs:
            _same(a.attrs[k], b.attrs[k])


def test_dataset_api_matches_jax(tmp_path):
    """ncio.Dataset's calls give what the JAX package's give (h5py)."""
    path = str(tmp_path / "jax.nc")
    _write_with(jncio.Writer, path)
    with ncio.Dataset(path) as got, jncio.Dataset(path) as want:
        for sel in ((), (1,), (0, slice(1, 3)), (1, slice(None), 2),
                    (slice(None), slice(0, 4, 2), slice(1, None))):
            _same(got.var("p", sel), want.var("p", sel))
        _same(got.var("undefined"), want.var("undefined"))
        for var, name in (("p", "units"), ("flux03", "standard_name"),
                          ("user", "level"), ("user", "weight"),
                          ("spectrum", "_dims"), ("plain", "_dims"),
                          ("/", "lon_global_size"), ("/", "title"),
                          ("lat", "NAME")):
            assert got.attr(var, name) == want.attr(var, name)
            assert type(got.attr(var, name)) is \
                type(want.attr(var, name))
        for dim in ("time", "lat", "lon", "level", "lw_wavenumber"):
            assert got.dim_size(dim) == want.dim_size(dim)
        assert got.has("p") and not got.has("q")
        assert got.shape("spectrum") == (2, 3, 4, 6)
        assert not got.allocated("undefined") and got.allocated("p")


def test_port_imports_no_h5py_anywhere():
    """No module of the port, and not chip_smoke.py, imports h5py or
    netCDF4, eagerly or inside a function."""
    import ast
    import pathlib

    root = pathlib.Path(DATA).parents[2]
    files = sorted((root / "grtcode_tpu_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    assert len(files) > 50
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for name in names:
                assert name.split(".")[0] not in ("h5py", "netCDF4"), \
                    f"{path} imports {name}"


if __name__ == "__main__":
    write_fixtures(sys.argv[1])
