"""Interpolation / integration helpers (port of grtcode_tpu/utils/interp.py).

``interpolate_to_grid_np`` is the host (numpy, float64) ingest path and
keeps the reference's edge quirks: points ``<= x[0]`` take the left
extrapolation rule, points ``> x[-1]`` extrapolate from the second-to-last
sample.  ``trapezoid_integral`` is the host rule that normalizes the solar
spectrum; ``trapezoid_uniform`` integrates fluxes on the device, and
``block_trapezoid_weights`` splits that integral over spectral blocks.
"""
from __future__ import annotations

import numpy as np
import torch


def interpolate_piecewise(x, y, newx, extrapolate: str = "none", fill=0.0):
    """Piecewise-linear interpolation (numpy) matching reference
    interpolate2, including the constant right extrapolation from
    ``y[n-2]``.  ``y`` may carry leading axes (one curve per column, all
    on the sample positions ``x``)."""
    x = np.asarray(x)
    y = np.asarray(y)
    newx = np.asarray(newx)
    n = x.shape[0]
    idx = np.searchsorted(x, newx, side="left")
    j = np.clip(idx - 1, 0, n - 2)
    x0 = x[j]
    x1 = x[j + 1]
    y0 = y[..., j]
    y1 = y[..., j + 1]
    m = (y1 - y0) / (x1 - x0)
    interior = y0 + m * (newx - x0)
    left_mask = idx == 0  # newx <= x[0]
    right_mask = newx > x[-1]
    if extrapolate == "constant":
        left_val = y[..., :1]
        right_val = y[..., n - 2:n - 1]
    elif extrapolate == "none":
        left_val = fill
        right_val = fill
    else:
        raise ValueError(f"unknown extrapolate mode {extrapolate!r}")
    out = np.where(left_mask, left_val, interior)
    out = np.where(right_mask, right_val, out)
    return out


def interpolate_to_grid_np(grid, x, y, extrapolate: str = "none", fill=0.0):
    """Interpolate tabulated host data onto a SpectralGrid (numpy, f64)."""
    w = grid.wavenumbers_np()
    return interpolate_piecewise(
        np.asarray(x, dtype=np.float64),
        np.asarray(y, dtype=np.float64),
        w,
        extrapolate=extrapolate,
        fill=fill,
    )


def trapezoid_integral(x, y):
    """Trapezoid-rule integral of samples ``y(x)`` (host, numpy)."""
    x = np.asarray(x)
    y = np.asarray(y)
    return np.sum(0.5 * (y[..., :-1] + y[..., 1:]) * np.diff(x), axis=-1)


def angstrom_exponent_sample(x, y, newx):
    """Sample aerosol optical depth with an Angstrom exponent
    (utilities.c:45-74): ``newy = y[0] * (x[0]/newx)**alpha`` where
    ``alpha = log(y[1]/y[0]) / log(x[0]/x[1])``; tensors in, tensors out,
    else numpy."""
    xp = torch if isinstance(newx, torch.Tensor) else np
    x, y, newx = (torch.as_tensor(a) if xp is torch else np.asarray(a)
                  for a in (x, y, newx))
    alpha = xp.log(y[1] / y[0]) / xp.log(x[0] / x[1])
    return y[0] * (x[0] / newx) ** alpha


def trapezoid_uniform(y: torch.Tensor, dw: float):
    """Trapezoid integral over the last axis on a uniform grid with spacing
    ``dw`` (the driver's integrated-flux accumulation)."""
    return (0.5 * (y[..., :-1] + y[..., 1:])).sum(-1) * dw


def block_trapezoid_weights(start: int, block: int, n_global: int, dw: float,
                            device=None) -> torch.Tensor:
    """Trapezoid weights of the spectral block [start, start + block): dw
    inside the band, dw/2 at the two global band edges, 0 past the grid
    end (the tail block's padding), so the per-block weighted sums add up
    to the whole-band trapezoid."""
    gidx = start + torch.arange(block, dtype=torch.int32, device=device)
    valid = gidx < n_global
    edge = (gidx == 0) | (gidx == n_global - 1)
    return torch.where(valid, torch.where(edge, 0.5, 1.0), 0.0) * dw
