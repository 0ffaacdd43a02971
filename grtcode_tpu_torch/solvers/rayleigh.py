"""Rayleigh scattering optics (port of grtcode_tpu/solvers/rayleigh.py).

``tau = n * 1e-20 W^4 / (0.268675e5 (938.076 - 10.8426 W^2))`` with
W = w * 1e-4, omega = 1, g = 0; n is the layer air column density [cm-2].
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..optics import Optics
from ..utils.curtis_godson import number_densities


def rayleigh_tau(n, w):
    """(..., nlayers) column densities x (nw,) wavenumbers ->
    (..., nlayers, nw)."""
    ww = w * 1e-4
    spectral = (1e-20 * ww ** 4) / (0.268675e5 * (9.38076e2 - 10.8426 * ww * ww))
    return n[..., :, None] * spectral


def rayleigh_optics(level_pressure_mb, grid, dtype=torch.float32, *,
                    device) -> Optics:
    """Rayleigh optics on ``grid`` from (..., nlevels) level pressures
    [mb] (rayleigh_scattering, rayleigh.c:100-144): converts to atm,
    integrates layer densities, fills omega = 1, g = 0."""
    if not isinstance(level_pressure_mb, torch.Tensor):
        level_pressure_mb = np.array(level_pressure_mb, np.float64)
    p_atm = torch.as_tensor(level_pressure_mb, dtype=dtype,
                            device=device) * constants.MB_TO_ATM
    tau = rayleigh_tau(number_densities(p_atm),
                       grid.wavenumbers(device, dtype=dtype))
    return Optics(tau=tau, omega=torch.ones_like(tau),
                  g=torch.zeros_like(tau), grid=grid)
