"""CFC/HFC cross-sections and collision-induced absorption tables (port of
grtcode_tpu/gas_optics/xsec.py).

Cross-section CSVs (2 columns, linear, zero outside) are interpolated onto
the grid on the host; the optical-depth adds (kernels.c:585-630) are
elementwise device math, which
:meth:`grtcode_tpu_torch.gas_optics.gas_optics.GasOptics.optical_depth`
calls on its whole batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..spectral import SpectralGrid
from ..utils.interp import interpolate_to_grid_np
from .continua import _read_csv
from .molecules import CfcId, CFC_NAMES


@dataclasses.dataclass
class CrossSectionTable:
    """A species cross-section interpolated onto the spectral grid."""

    id: int
    name: str
    cross_section: torch.Tensor  # (n_w,) f32

    @classmethod
    def from_file(cls, xsec_id, path: str, grid: SpectralGrid, device,
                  name: str | None = None, scale: float = 1.0):
        """``scale`` is folded into the stored f32 table in f64: CIA cross
        sections (~1e-44 cm^5) and the pressure-squared column factor
        (~1e47) each sit outside the f32 range; only their product fits."""
        data = _read_csv(path, 2)
        y = interpolate_to_grid_np(grid, data[:, 0], data[:, 1])
        if name is None:
            name = CFC_NAMES.get(CfcId(xsec_id), str(xsec_id))
        return cls(id=int(xsec_id), name=name,
                   cross_section=torch.as_tensor(
                       np.asarray(y, np.float64) * scale,
                       dtype=torch.float32, device=device))


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def cfc_optical_depth(xsec: CrossSectionTable, n, x_levels, xs=None):
    """tau += 0.5 * n * (x_i + x_{i+1}) * sigma(w) (kernels.c:585-601).

    Args: air column density n (..., nlayers), level mole fraction x
    (..., nlevels); ``xs`` optionally overrides the cross-section with a
    spectral-block slice.  Returns (..., nlayers, n_w) on the table's
    device.
    """
    if xs is None:
        xs = xsec.cross_section
    n = _f32(n, xs.device)
    x = _f32(x_levels, xs.device)
    xavg = 0.5 * (x[..., :-1] + x[..., 1:])
    return (n * xavg)[..., None] * xs


def cia_optical_depth(xsec: CrossSectionTable, p_levels, tavg, x1_levels,
                      x2_levels, xs=None):
    """Collision-induced absorption (kernels.c:605-630):

    ``n2 = |c (p_i^2 - p_{i+1}^2)/T * 1/4 (x1_i + x1_{i+1})(x2_i + x2_{i+1})|``
    ``tau += n2 * sigma(w)``  with c the pressure-squared column factor
    [K atm-2 cm-5], pre-folded into the stored cross-section
    (``CrossSectionTable.from_file(scale=...)``): c ~ 7.9e46 overflows f32
    and real CIA sigma ~ 1e-44 is f32-subnormal, but c*sigma ~ 1e3 is exact.

    Args: level pressure [atm] (..., nlevels), layer temperature (...,
    nlayers), level mole fractions of both species; ``xs`` optionally
    overrides the cross-section with a spectral-block slice.  Returns
    (..., nlayers, n_w) on the table's device.
    """
    if xs is None:
        xs = xsec.cross_section
    p = _f32(p_levels, xs.device)
    t = _f32(tavg, xs.device)
    x1 = _f32(x1_levels, xs.device)
    x2 = _f32(x2_levels, xs.device)
    n2 = ((p[..., :-1] ** 2 - p[..., 1:] ** 2) / t) * 0.25 * \
        (x1[..., :-1] + x1[..., 1:]) * (x2[..., :-1] + x2[..., 1:])
    return n2.abs()[..., None] * xs
