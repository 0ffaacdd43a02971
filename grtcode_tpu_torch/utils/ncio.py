"""Minimal netCDF4 (HDF5-backed) IO over h5py (a copy of
grtcode_tpu/utils/ncio.py; h5py is imported only when a file is opened).

The reference links libnetcdf for its file IO (rfmip-irf.c, era5.c,
clouds/netcdf_utils.c); the netCDF4 python bindings are not needed:
netCDF4 files ARE HDF5 files, so h5py covers both reading benchmark
inputs and writing CF-style outputs (datasets as variables, HDF5
dimension scales as netCDF dimensions).  Classic netCDF3 files are not
supported — the RFMIP/ERA5/CIRC distributions are netCDF4.
"""
from __future__ import annotations

import numpy as np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.item().decode() if v.size == 1 else [x.decode() for x in v]
    return v


class Dataset:
    """Read-only view of a netCDF4/HDF5 file."""

    def __init__(self, path: str):
        import h5py
        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has(self, name: str) -> bool:
        return name in self._f

    def var(self, name: str, sel=()):
        """Read (a hyperslab of) a variable as float64; `sel` is a tuple of
        slices/indices applied in stored order."""
        ds = self._f[name]
        data = ds[sel] if sel != () else ds[()]
        return np.asarray(data, np.float64)

    def attr(self, var: str, name: str):
        return _decode(self._f[var].attrs[name])

    def dim_size(self, name: str) -> int:
        """Size of a named dimension (its coordinate/scale dataset)."""
        return int(self._f[name].shape[0])


class Writer:
    """CF-style netCDF4 output writer (HDF5 dimension scales).

    Mirrors the shape of the reference's create_flux_file callbacks
    (rfmip-irf.c:468-560, era5.c:760-960): named dimensions, float
    variables over those dimensions, units attributes, global attributes.
    """

    def __init__(self, path: str):
        import h5py
        self._f = h5py.File(path, "w")
        self._dims = {}

    def create_dimension(self, name: str, size: int, values=None):
        data = (np.arange(size, dtype=np.float64)
                if values is None else np.asarray(values, np.float64))
        ds = self._f.create_dataset(name, data=data)
        ds.make_scale(name)
        self._dims[name] = ds

    # netCDF NC_FILL_FLOAT: defined-but-unwritten variables read back as
    # this, exactly as the reference's files do — distinguishable from a
    # genuine zero flux.
    FILL_VALUE = np.float32(9.96921e36)

    def create_variable(self, name: str, dims: tuple, data=None,
                        units: str | None = None, **attrs):
        """Define a variable over named dimensions; ``data=None`` defines
        it without writing (the netCDF fill-value pattern era5.c relies on
        for variables its configuration never computes — HDF5 allocates
        lazily, so unwritten variables cost no file space and read back
        as NC_FILL_FLOAT)."""
        if data is None:
            shape = tuple(self._dims[d].shape[0] for d in dims)
            ds = self._f.create_dataset(name, shape=shape, dtype=np.float32,
                                        fillvalue=self.FILL_VALUE)
        else:
            ds = self._f.create_dataset(name,
                                        data=np.asarray(data, np.float32))
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._dims[d])
        # Dimension-name metadata (the netCDF header carries this
        # natively); tools/combine_segments.py uses it to locate the lon
        # axis per variable.
        ds.attrs["_dims"] = np.array([d.encode() for d in dims])
        if units is not None:
            ds.attrs["units"] = units
        for k, v in attrs.items():
            ds.attrs[k] = v

    def set_global(self, **attrs):
        for k, v in attrs.items():
            self._f.attrs[k] = v

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
