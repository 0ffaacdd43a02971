"""Minimal netCDF4 (HDF5-backed) IO (the API of
grtcode_tpu/utils/ncio.py) over the port's own HDF5 reader and writer,
:mod:`grtcode_tpu_torch.utils.hdf5`, in numpy and the standard library.

The reference links libnetcdf for its file IO (rfmip-irf.c, era5.c,
clouds/netcdf_utils.c).  netCDF4 files ARE HDF5 files: variables are
datasets and netCDF dimensions HDF5 dimension scales.  Classic netCDF3
files are not supported (the RFMIP/ERA5/CIRC distributions are netCDF4);
the reader raises ``NotImplementedError`` on them and on any HDF5 feature
it does not decode.
"""
from __future__ import annotations

import numpy as np

from . import hdf5


def _decode(v):
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.item().decode() if v.size == 1 else [x.decode() for x in v]
    return v


class Dataset:
    """Read-only view of a netCDF4/HDF5 file."""

    def __init__(self, path: str):
        self._f = hdf5.File(path)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has(self, name: str) -> bool:
        return name in self._f

    def names(self) -> list:
        """The root group's members, variables and dimensions."""
        return self._f.keys()

    def shape(self, name: str) -> tuple:
        return self._f[name].shape

    def allocated(self, name: str) -> bool:
        """Whether the variable's storage was ever written (a variable
        only defined has none and reads back as its fill value)."""
        return self._f[name].allocated

    def var(self, name: str, sel=(), dtype=np.float64):
        """Read (a hyperslab of) a variable as ``dtype`` (``None``: as
        stored); `sel` is a tuple of slices/indices applied in stored
        order."""
        data = self._f[name].read(sel)
        return data if dtype is None else np.asarray(data, dtype)

    def attr(self, var: str, name: str):
        """An attribute of variable ``var`` ("/" for a global one); strings
        come back as ``str`` whether stored fixed-length (netCDF-C) or
        variable-length (h5py)."""
        return _decode(self._f[var].attrs[name] if var != "/"
                       else self._f.attrs[name])

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
        self._f = hdf5.FileWriter(path)
        self._dims = {}

    def create_dimension(self, name: str, size: int, values=None):
        data = (np.arange(size, dtype=np.float64)
                if values is None else np.asarray(values, np.float64))
        ds = self._f.create_dataset(name, data)
        self._f.make_scale(ds, name)
        self._dims[name] = ds

    # netCDF NC_FILL_FLOAT: defined-but-unwritten variables read back as
    # this, exactly as the reference's files do — distinguishable from a
    # genuine zero flux.
    FILL_VALUE = np.float32(9.96921e36)

    def create_variable(self, name: str, dims: tuple, data=None,
                        units: str | None = None, **attrs):
        """Define a variable over named dimensions; ``data=None`` defines
        it without writing (the netCDF fill-value pattern era5.c relies on
        for variables its configuration never computes: no storage is
        allocated, so unwritten variables cost no file space and read back
        as NC_FILL_FLOAT)."""
        if data is None:
            shape = tuple(self._dims[d].shape[0] for d in dims)
            ds = self._f.create_dataset(name, shape=shape, dtype=np.float32,
                                        fillvalue=self.FILL_VALUE)
        else:
            ds = self._f.create_dataset(name, np.asarray(data, np.float32))
        for i, d in enumerate(dims):
            self._f.attach_scale(ds, self._dims[d], i)
        # Dimension-name metadata (the netCDF header carries this
        # natively); the segment combiners use it to locate the lon axis
        # per variable.
        ds.attrs["_dims"] = np.array([d.encode() for d in dims])
        if units is not None:
            ds.attrs["units"] = units
        for k, v in attrs.items():
            ds.attrs[k] = v

    def set_global(self, **attrs):
        self._f.attrs.update(attrs)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
