"""Merge per-segment ERA5 flux files along the lon dimension (port of
tools/combine_segments.py, on the port's own netCDF IO).

Each segment of an ERA5 run writes its lon slice with `lon_start/
lon_stop/lon_global_size` global attributes (era5.c:156-159); this tool
assembles the global domain, as the reference's post-hoc combiners do
(era5/test/combine-segments.py:8-36, extra-tools/grtcode-results-
combiner.c).

    python -m grtcode_tpu_torch.apps.combine_segments [--rebin N] \\
        out.nc seg1.nc seg2.nc ...

``--rebin N`` additionally coarsens any trailing spectral axis of 4-D+
variables by N (mean over bins, matching the reference combiner's
`coarsen(...).sum()/N`, GRTworkflow/combiner.py:40-60): N=10 turns 0.1
cm-1 spectrally-resolved output into 1 cm-1 bins.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..utils import hdf5
from ..utils.ncio import Dataset, Writer


def rebin_spectral(data: np.ndarray, factor: int) -> np.ndarray:
    """Mean over blocks of `factor` along the last axis, trimming the
    remainder (xarray coarsen boundary='trim' + sum()/factor)."""
    n = data.shape[-1] // factor * factor
    trimmed = data[..., :n]
    return trimmed.reshape(*trimmed.shape[:-1], n // factor, factor).mean(-1)


_DIM_NAMES = ("time", "lat", "lon", "level", "layer",
              "lw_wavenumber", "sw_wavenumber")


def _read_segment(path: str) -> dict:
    with Dataset(path) as nc:
        # Defined-but-unwritten variables (the era5 writer's fill-value
        # pattern; no storage) are NOT materialized: a production LW-only
        # spectral file defines ~50k-point SW variables that would densify
        # to hundreds of GB of fill.
        names = [k for k in nc.names() if k not in _DIM_NAMES]
        written = {k for k in names if nc.allocated(k)}
        # The writer stores each variable's dimension names in a "_dims"
        # attribute; the lon axis position varies (axis 2 for flux
        # variables, axis 3 for the (time, level, lat, lon) profiles).
        dims = {}
        for k in names:
            try:
                dims[k] = nc.attr(k, "_dims")
            except KeyError:
                dims[k] = None
            if isinstance(dims[k], str):
                dims[k] = [dims[k]]
        return {
            "lon_start": int(nc.attr("/", "lon_start")),
            "lon_stop": int(nc.attr("/", "lon_stop")),
            "lon_global_size": int(nc.attr("/", "lon_global_size")),
            "vars": {k: (nc.var(k, dtype=None) if k in written
                         else nc.shape(k))
                     for k in names},
            "written": written,
            "dims": dims,
        }


def combine(segment_paths, out_path, rebin: int | None = None):
    segs = [_read_segment(p) for p in segment_paths]
    nglobal = segs[0]["lon_global_size"]
    seen = np.zeros(nglobal, bool)
    fill = Writer.FILL_VALUE
    with hdf5.FileWriter(out_path) as out:
        for name in segs[0]["vars"]:
            dims = segs[0]["dims"][name]
            lon_axis = dims.index("lon") if dims is not None else 2
            if all(name not in s["written"] for s in segs):
                # Unwritten in every segment: re-emit define-only.
                shape = list(segs[0]["vars"][name])   # stored as shape
                shape[lon_axis] = nglobal
                out.create_dataset(name, shape=tuple(shape),
                                   dtype=np.float32, fillvalue=fill)
                continue
            sample = segs[0]["vars"][name]
            if not isinstance(sample, np.ndarray):
                sample = np.full(sample, fill, np.float32)
            shape = list(sample.shape)
            shape[lon_axis] = nglobal
            data = np.zeros(shape, sample.dtype)
            for s in segs:
                idx = [slice(None)] * data.ndim
                idx[lon_axis] = slice(s["lon_start"], s["lon_stop"] + 1)
                v = s["vars"][name]
                if not isinstance(v, np.ndarray):   # unwritten segment
                    v = np.full(v, fill, np.float32)
                data[tuple(idx)] = v
            spectral_last = (dims[-1].endswith("wavenumber")
                             if dims is not None else data.ndim > 4)
            if rebin and spectral_last:
                data = rebin_spectral(data, rebin)
            out.create_dataset(name, data)
        for s in segs:
            seen[s["lon_start"]:s["lon_stop"] + 1] = True
        if not seen.all():
            missing = np.where(~seen)[0]
            raise ValueError(f"missing lon indices: {missing.tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rebin", type=int, default=None)
    ap.add_argument("out")
    ap.add_argument("segments", nargs="+")
    a = ap.parse_args(argv)
    combine(a.segments, a.out, rebin=a.rebin)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
