"""Batched atmospheric state (port of grtcode_tpu/framework/atmosphere.py).

All fields carry a leading batch axis B; surface spectra are given on
their own grids and interpolated onto the solver grids by the driver.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np


def pressure_interp_layers_to_levels(layer_values, layer_pressure,
                                     level_pressure):
    """Linearly interpolate per-layer data to levels in pressure space
    (the end levels copy the nearest layer's value).

    Args: (..., nlayers) values, (..., nlayers) layer p, (..., nlevels)
    level p.  Returns (..., nlevels).
    """
    lv = np.asarray(layer_values, np.float64)
    lp = np.asarray(layer_pressure, np.float64)
    pp = np.asarray(level_pressure, np.float64)
    out = np.empty(lv.shape[:-1] + (pp.shape[-1],), np.float64)
    out[..., 0] = lv[..., 0]
    out[..., -1] = lv[..., -1]
    for i in range(1, pp.shape[-1] - 1):
        out[..., i] = lv[..., i - 1] + (lv[..., i] - lv[..., i - 1]) * (
            pp[..., i] - lp[..., i - 1]) / (lp[..., i] - lp[..., i - 1])
    return out


@dataclasses.dataclass
class Atmosphere:
    """Batched column states as numpy host arrays.

    Abundances are ppmv at LEVELS.
    """

    level_pressure: np.ndarray       # (B, nlevels) [mb]
    level_temperature: np.ndarray    # (B, nlevels) [K]
    surface_temperature: np.ndarray  # (B,) [K]
    ppmv: Mapping[int, np.ndarray]   # mol id -> (B, nlevels) [ppmv]

    layer_temperature: np.ndarray | None = None  # (B, nlayers) [K]
    cfc_ppmv: Mapping[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    cia_ppmv: Mapping[int, np.ndarray] = dataclasses.field(
        default_factory=dict)

    # Longwave surface: spectrum on its own grid.
    emissivity_grid: np.ndarray | None = None    # (ne,) [cm-1]
    emissivity: np.ndarray | None = None         # (B, ne)

    # Shortwave surface/beam.
    cos_zenith: np.ndarray | None = None         # (B,) cosine solar zenith
    total_solar_irradiance: np.ndarray | None = None  # (B,) [W m-2]
    albedo_grid: np.ndarray | None = None        # (na,) [cm-1]
    albedo: np.ndarray | None = None             # (B, na) direct == diffuse

    # Aerosols (the clear-sky CS tier): Angstrom-exponent optical depth
    # tau(lambda) = tau_1um * lambda_um^-alpha, grey ssa and asymmetry.
    aerosol_optical_depth_1um: np.ndarray | None = None  # (B, nlayers)
    aerosol_angstrom_exponent: np.ndarray | None = None  # (B,) or scalar
    aerosol_single_scatter_albedo: np.ndarray | None = None  # (B, nlayers)
    aerosol_asymmetry_factor: np.ndarray | None = None   # (B, nlayers)

    # Clouds (the all-sky AF tier).
    cloud_fraction: np.ndarray | None = None         # (B, nlayers)
    liquid_water_content: np.ndarray | None = None   # (B, nlayers) [g m-3]
    ice_water_content: np.ndarray | None = None      # (B, nlayers) [g m-3]
    layer_thickness: np.ndarray | None = None        # (B, nlayers) [m]

    clean: bool = True   # no aerosols
    clear: bool = True   # no clouds

    def __post_init__(self):
        self.level_pressure = np.atleast_2d(
            np.asarray(self.level_pressure, np.float64))
        self.level_temperature = np.atleast_2d(
            np.asarray(self.level_temperature, np.float64))
        self.surface_temperature = np.atleast_1d(
            np.asarray(self.surface_temperature, np.float64))
        if self.layer_temperature is None:
            t = self.level_temperature
            self.layer_temperature = 0.5 * (t[:, :-1] + t[:, 1:])

    @property
    def batch(self) -> int:
        return self.level_pressure.shape[0]

    # Fields without a leading batch axis (shared grids and flags).
    _UNBATCHED = ("emissivity_grid", "albedo_grid", "clean", "clear")

    def subset(self, idx) -> "Atmosphere":
        """A new Atmosphere of the columns ``idx`` selects (any numpy index
        along the batch axis).  Fields without the batch axis (a scalar
        Angstrom exponent, the spectra's grids) pass through unchanged."""
        idx = np.asarray(idx)

        def take(v):
            if v is None:
                return None
            if isinstance(v, Mapping):
                return {k: take(x) for k, x in v.items()}
            a = np.asarray(v)
            if a.ndim == 0 or a.shape[0] != self.batch:
                return v
            return a[idx]

        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v if f.name in self._UNBATCHED else take(v)
        return Atmosphere(**kw)

    @property
    def num_levels(self) -> int:
        return self.level_pressure.shape[1]

    @property
    def num_layers(self) -> int:
        return self.num_levels - 1
