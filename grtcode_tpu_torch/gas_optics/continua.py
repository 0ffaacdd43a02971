"""Water-vapor (MT-CKD 2.5) and ozone continua (port of
grtcode_tpu/gas_optics/continua.py).

Coefficient CSVs are interpolated onto the spectral grid once on the host;
the per-layer optical-depth adds are elementwise tensor math.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import constants
from ..spectral import SpectralGrid
from ..utils.interp import interpolate_to_grid_np


def _read_csv(path: str, expect_cols: int | None = None) -> np.ndarray:
    """Header-skipping CSV -> (nrows, ncols) float64."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    if expect_cols is not None and data.shape[1] != expect_cols:
        raise ValueError(
            f"{path}: expected {expect_cols} columns, found {data.shape[1]}")
    return data


@dataclasses.dataclass
class WaterVaporContinuum:
    """MT-CKD 2.5 coefficients on the spectral grid ((n_w,) f32 tensors)."""

    cs: torch.Tensor    # self coefficient at 296 K (296MTCKD25_S.csv)
    cf: torch.Tensor    # foreign coefficient at 296 K (296MTCKD25_F.csv)
    t0s: torch.Tensor   # self T dependence (CKDS.csv col 1)
    t0f: torch.Tensor   # foreign T dependence (CKDF.csv col 1)

    @classmethod
    def from_directory(cls, directory: str, grid: SpectralGrid, device):
        def load(name, cols):
            data = _read_csv(os.path.join(directory, name), cols + 1)
            # Only the first value column is used.
            y = interpolate_to_grid_np(grid, data[:, 0], data[:, 1])
            return torch.as_tensor(y, dtype=torch.float32, device=device)

        return cls(
            cs=load("296MTCKD25_S.csv", 1),
            cf=load("296MTCKD25_F.csv", 1),
            t0s=load("CKDS.csv", 3),
            t0f=load("CKDF.csv", 3),
        )

    def optical_depth(self, ns, pavg, tavg, psavg, cs=None, cf=None,
                      t0s=None, t0f=None):
        """tau contribution
        ``N (296/T) [Cs Ps e^{T0s (296-T)} + Cf (P-Ps) e^{T0f (296-T)}]``.

        Args: per-row (rows,) tensors — H2O column density ns [cm-2],
        layer pressure pavg [atm], temperature tavg [K], H2O partial
        pressure psavg [atm].  cs/cf/t0s/t0f optionally override the grid
        tables with a spectral-block slice.  Returns (rows, n_w).
        """
        cs = self.cs if cs is None else cs
        cf = self.cf if cf is None else cf
        t0s = self.t0s if t0s is None else t0s
        t0f = self.t0f if t0f is None else t0f
        tref = constants.TREF
        t = tavg.to(torch.float32)[:, None]
        p = pavg.to(torch.float32)[:, None]
        ps = psavg.to(torch.float32)[:, None]
        n = ns.to(torch.float32)[:, None]
        dt = tref - t
        return n * (tref / t) * (
            cs[None, :] * ps * torch.exp(t0s[None, :] * dt)
            + cf[None, :] * (p - ps) * torch.exp(t0f[None, :] * dt))


@dataclasses.dataclass
class OzoneContinuum:
    """Ozone continuum cross-sections on the spectral grid."""

    cross_section: torch.Tensor  # (n_w,) [cm2]

    @classmethod
    def from_file(cls, path: str, grid: SpectralGrid, device):
        data = _read_csv(path, 2)
        y = interpolate_to_grid_np(grid, data[:, 0], data[:, 1])
        return cls(cross_section=torch.as_tensor(y, dtype=torch.float32,
                                                 device=device))

    def optical_depth(self, ns):
        """tau += N_O3 * sigma(w) (kernels.c:495-510): (rows,) O3 column
        densities -> (rows, n_w) on the table's device."""
        ns = torch.as_tensor(ns, dtype=torch.float32,
                             device=self.cross_section.device)
        return ns[:, None] * self.cross_section[None, :]
