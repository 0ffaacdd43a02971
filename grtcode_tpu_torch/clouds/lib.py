"""Cloud optics facade: subcolumn sampling -> band optics -> solver grid
(port of grtcode_tpu/clouds/lib.py).

As in the JAX package, one condensate sample per subcolumn is shared by
all bands, and the subcolumn of column j is drawn from the key
``fold_in(key, col_index[j])``, so a column's realization does not depend
on how the batch is split.
"""
from __future__ import annotations

import dataclasses

import torch

from ..optics import Optics
from ..spectral import SpectralGrid
from ..utils import prng
from ..utils.graphs import device_constant
from .pade import PadeCloudOptics
from .stochastic import overlap_parameter, sample_condensate

# Chou-Suarez-like step lookup, ascending thresholds [K] -> sizes [microns].
_TFREEZE = 273.16
_ICE_T_THRESH = (_TFREEZE - 55.0, _TFREEZE - 50.0, _TFREEZE - 45.0,
                 _TFREEZE - 40.0, _TFREEZE - 35.0, _TFREEZE - 30.0,
                 _TFREEZE - 25.0)
_ICE_SIZES = (20.2, 21.6, 39.9, 42.5, 63.9, 93.5, 80.8, 100.6)

# Overlap altitude proxy: z = 7.3 km * ln(100 * p_mb), L = 2 km.
_PA_PER_MB = 100.0
_PRESSURE_SCALE_HEIGHT_KM = 7.3
_OVERLAP_SCALE_LENGTH_KM = 2.0


def ice_particle_size(temperature):
    """Ice particle *size* [microns] from layer temperature; the effective
    radius is half of this."""
    t = torch.as_tensor(temperature, dtype=torch.float32)
    thresh = device_constant(_ICE_T_THRESH, t.device)
    sizes = device_constant(_ICE_SIZES, t.device)
    return sizes[torch.searchsorted(thresh, t.contiguous(), right=True)]


def band_to_grid(band_values, band_lims, w):
    """Per-band values (..., nbnd) on the grid points ``w`` (nw,): a point
    inside [lower_b, upper_b] takes band b's value, a point in no band 0.
    ``band_lims`` is (2, nbnd).  Returns (..., nw)."""
    lims = torch.as_tensor(band_lims, dtype=torch.float32, device=w.device)
    idx = torch.clamp(torch.searchsorted(lims[0], w, right=True) - 1,
                      0, lims.shape[1] - 1)
    valid = (w >= lims[0][idx]) & (w <= lims[1][idx])
    return torch.where(valid, band_values[..., idx], 0.0)


def overlap_from_pressure(layer_pressure_mb):
    """Overlap parameters from the driver's log-pressure altitude proxy."""
    z = _PRESSURE_SCALE_HEIGHT_KM * torch.log(
        _PA_PER_MB * torch.as_tensor(layer_pressure_mb, dtype=torch.float32))
    return overlap_parameter(z, _OVERLAP_SCALE_LENGTH_KM)


@dataclasses.dataclass
class CloudOpticsLib:
    """Liquid + ice band-optics tables bound to the solver workflow.

    ``liquid`` is any table with ``evaluate(wc, radius) -> (ext, ssa, g)``
    and ``band_lims``: a :class:`PadeCloudOptics` or a
    :class:`HuStamnesLiquidOptics`."""

    liquid: PadeCloudOptics
    ice: PadeCloudOptics
    liquid_radius: float = 10.0   # [microns]

    def column_optics(self, key, cloud_fraction, lwc, iwc, t_lay,
                      layer_pressure_mb, layer_thickness,
                      grids: tuple[SpectralGrid, ...]):
        """One subcolumn's liquid/ice optics on each requested grid.

        ``key`` is a (2,) :mod:`..utils.prng` key; per-layer args
        (nlayers,), moved to the key's device; returns a list of
        (liquid_optics, ice_optics) tuples, one per grid, with tau =
        extinction * thickness.  Thin wrapper over :meth:`column_optics_w`
        on each grid's wavenumbers, tagging each Optics with its grid.
        """
        dev = key.device

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        out = self.column_optics_w(
            key, f32(cloud_fraction), f32(lwc), f32(iwc), f32(t_lay),
            f32(layer_pressure_mb), f32(layer_thickness),
            [grid.wavenumbers(dev) for grid in grids])
        for grid, (liq, ice) in zip(grids, out):
            liq.grid = grid
            ice.grid = grid
        return out

    def column_optics_w(self, keys, cloud_fraction, lwc, iwc, t_lay,
                        layer_pressure_mb, layer_thickness, ws):
        """One subcolumn per key: its liquid and ice optics on each
        wavenumber tensor of ``ws``.  ``keys`` is (..., 2), the per-layer
        fields (..., nlayers); returns a list of (liquid, ice) Optics with
        (..., nlayers, nw) fields, tau = extinction * thickness.  The
        sample does not depend on w, so every spectral block of a band
        sees one cloud realization."""
        overlap = overlap_from_pressure(layer_pressure_mb)
        ql, qi = sample_condensate(keys, cloud_fraction, lwc, iwc, overlap)
        rice = ice_particle_size(t_lay) / 2.0
        rliq = torch.full_like(rice, self.liquid_radius)

        le, ls, lg = self.liquid.evaluate(ql, rliq)     # (..., nlay, nbnd)
        ie, is_, ig = self.ice.evaluate(qi, rice)

        thick = torch.as_tensor(layer_thickness,
                                dtype=torch.float32)[..., None]
        out = []
        for w in ws:
            liq = Optics(
                tau=band_to_grid(le, self.liquid.band_lims, w) * thick,
                omega=band_to_grid(ls, self.liquid.band_lims, w),
                g=band_to_grid(lg, self.liquid.band_lims, w))
            ice = Optics(
                tau=band_to_grid(ie, self.ice.band_lims, w) * thick,
                omega=band_to_grid(is_, self.ice.band_lims, w),
                g=band_to_grid(ig, self.ice.band_lims, w))
            out.append((liq, ice))
        return out

    def driver_callback(self):
        """The callback ``RadiationDriver.cloud_optics`` takes:
        ``(cloud_args, key, w_lw, w_sw) -> (liq_lw, ice_lw, liq_sw,
        ice_sw)`` with (B, nlayers, nw) fields (the SW pair None when
        ``w_sw`` is None).  Column j draws from ``fold_in(key,
        cloud_args["col_index"][j])`` (``arange(B)`` without it)."""
        def callback(cloud_args, key, w_lw, w_sw):
            cf = cloud_args["cloud_fraction"]
            col_index = cloud_args.get("col_index")
            if col_index is None:
                col_index = torch.arange(cf.shape[0], device=cf.device)
            keys = prng.fold_in(key, col_index)
            ws = (w_lw,) if w_sw is None else (w_lw, w_sw)
            res = self.column_optics_w(
                keys, cf, cloud_args["liquid_water_content"],
                cloud_args["ice_water_content"], cloud_args["t_lay"],
                cloud_args["layer_pressure"], cloud_args["layer_thickness"],
                ws)
            liq_lw, ice_lw = res[0]
            if w_sw is None:
                return liq_lw, ice_lw, None, None
            liq_sw, ice_sw = res[1]
            return liq_lw, ice_lw, liq_sw, ice_sw

        return callback
