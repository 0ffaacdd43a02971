"""Hu & Stamnes (1993) liquid cloud optics (port of
grtcode_tpu/clouds/hu_stamnes.py): per (radius bin, band) power-law fits

    extinction [1/km]       = wc * 1e-3 * (a1 r^b1 + c1)
    single-scatter albedo   = 1 - (a2 r^b2 + c2)
    asymmetry factor        = a3 r^b3 + c3

with the radius clamped to the table's valid range and its bin chosen by
an upper-bound search.  Tables come from the reference's netCDF files
(:meth:`HuStamnesLiquidOptics.from_netcdf`, through the port's
``utils.ncio``) or from arrays, on the device the caller names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_M_TO_KM = 1.0e-3


@dataclasses.dataclass
class HuStamnesLiquidOptics:
    """Coefficient tables on (num_radius_bins, num_bands), float32 tensors.

    ``radii`` holds the num_radius_bins + 1 bin edges; ``band_lims`` is
    (2, num_bands) wavenumber bounds [cm-1].
    """

    radii: np.ndarray
    band_lims: torch.Tensor
    a1: torch.Tensor
    b1: torch.Tensor
    c1: torch.Tensor
    a2: torch.Tensor
    b2: torch.Tensor
    c2: torch.Tensor
    a3: torch.Tensor
    b3: torch.Tensor
    c3: torch.Tensor
    min_radius: float = 2.5
    max_radius: float = 60.0

    @classmethod
    def from_arrays(cls, radii, band_lims, a, b, c, min_radius=None,
                    max_radius=None, *, device):
        """Build from (3, nbins, nbands) a/b/c stacks."""
        def f(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)
        a, b, c = f(a), f(b), f(c)
        radii = np.asarray(radii, np.float64)
        return cls(
            radii=radii, band_lims=f(band_lims),
            a1=a[0], b1=b[0], c1=c[0], a2=a[1], b2=b[1], c2=c[1],
            a3=a[2], b3=b[2], c3=c[2],
            min_radius=float(radii[0] if min_radius is None else min_radius),
            max_radius=float(radii[-1] if max_radius is None else max_radius))

    @classmethod
    def from_netcdf(cls, path: str, device):
        """Load a Hu & Stamnes coefficient file (construct_liquid_optics,
        liquid_cloud_optics.c:35-73): radius bin bounds from the dataset the
        ``bounds`` attribute names, the valid range from ``valid_range``,
        coefficients a1..c3 on (radius, band)."""
        from ..utils.ncio import Dataset

        with Dataset(path) as nc:
            bounds_var = nc.attr("radius", "bounds")
            valid = np.asarray(nc.attr("radius", "valid_range"), np.float64)
            rb = nc.var(bounds_var)                       # (nbins, 2)
            radii = np.concatenate([rb[:, 0], rb[-1:, 1]])
            nbins = rb.shape[0]
            band_lims = nc.var("band_bnds").reshape(-1, 2).T  # (2, nbands)
            nbands = band_lims.shape[1]

            def tab(name):
                return torch.as_tensor(nc.var(name).reshape(nbins, nbands),
                                       dtype=torch.float32, device=device)

            return cls(radii=radii,
                       band_lims=torch.as_tensor(band_lims,
                                                 dtype=torch.float32,
                                                 device=device),
                       a1=tab("a1"), b1=tab("b1"), c1=tab("c1"),
                       a2=tab("a2"), b2=tab("b2"), c2=tab("c2"),
                       a3=tab("a3"), b3=tab("b3"), c3=tab("c3"),
                       min_radius=float(valid[0]), max_radius=float(valid[1]))

    @property
    def num_bands(self) -> int:
        return self.a1.shape[1]

    def evaluate(self, water_concentration, equivalent_radius):
        """(extinction [1/km], single-scatter albedo, asymmetry), each
        (..., num_bands), of liquid water content (...,) [g m-3] at
        equivalent radii (...,) [microns]."""
        wc = torch.as_tensor(water_concentration,
                             dtype=torch.float32)[..., None]
        r = torch.clamp(torch.as_tensor(equivalent_radius,
                                        dtype=torch.float32),
                        self.min_radius, self.max_radius)
        # The last bin whose lower edge <= r.
        edges = torch.as_tensor(self.radii[1:-1], dtype=torch.float32,
                                device=r.device)
        i = torch.searchsorted(edges, r.contiguous(), right=True)
        r = r[..., None]

        def fit(a, b, c):
            return a[i] * r ** b[i] + c[i]

        ext = wc * _M_TO_KM * fit(self.a1, self.b1, self.c1)
        ssa = 1.0 - fit(self.a2, self.b2, self.c2)
        g = fit(self.a3, self.b3, self.c3)
        return ext, ssa, g
