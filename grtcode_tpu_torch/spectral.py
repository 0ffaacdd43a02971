"""Uniform spectral (wavenumber) grids (port of grtcode_tpu/spectral.py).

The grid is static host metadata; wavenumber tensors are generated on
demand on an explicit device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import constants
from .utils.graphs import device_constant


@dataclasses.dataclass(frozen=True)
class SpectralGrid:
    """Uniform wavenumber grid: points ``w0 + i * dw`` for ``i in [0, n)``.

    ``n`` is ``ceil((wn - w0)/dw) + 1``; the nominal upper bound ``wn``
    may not lie on the grid if the range does not divide evenly.
    """

    w0: float
    wn: float
    dw: float

    def __post_init__(self):
        if not (constants.MIN_WAVENUMBER <= self.w0 <= constants.MAX_WAVENUMBER):
            raise ValueError(f"w0 {self.w0} outside valid range")
        if not (self.w0 < self.wn <= constants.MAX_WAVENUMBER):
            raise ValueError(f"wn {self.wn} outside valid range")
        if not (constants.MIN_RESOLUTION <= self.dw <= constants.MAX_RESOLUTION):
            raise ValueError(f"dw {self.dw} outside valid range")

    @property
    def n(self) -> int:
        return int(math.ceil((self.wn - self.w0) / self.dw)) + 1

    @property
    def last(self) -> float:
        """Largest wavenumber actually on the grid."""
        return self.w0 + (self.n - 1) * self.dw

    def wavenumbers(self, device, start: int = 0, size: int | None = None,
                    dtype=torch.float32) -> torch.Tensor:
        """Grid points ``[start, start + size)`` (all of them by default;
        a spectral block may run past the grid end) as a ``dtype`` tensor
        (f32 by default), with the driver's expression
        ``w0 + dw * index`` evaluated in ``dtype``."""
        size = self.n - start if size is None else size
        idx = torch.arange(start, start + size, dtype=torch.int32,
                           device=device).to(dtype)
        w0 = device_constant(self.w0, device, dtype)
        dw = device_constant(self.dw, device, dtype)
        return w0 + dw * idx

    def wavenumbers_np(self, dtype=np.float64) -> np.ndarray:
        """All grid points as a host numpy array (float64 by default)."""
        return self.w0 + self.dw * np.arange(self.n, dtype=dtype)

    def point_index(self, w: float) -> int:
        """Index of a wavenumber that must lie on the grid (tolerance
        dw*1e-5)."""
        if not (self.w0 <= w <= self.wn):
            raise ValueError(f"wavenumber {w} outside grid [{self.w0}, {self.wn}]")
        index = int(round((w - self.w0) / self.dw))
        if abs(self.w0 + index * self.dw - w) > self.dw * 1e-5:
            raise ValueError(f"wavenumber {w} not located on grid")
        return index

    def __eq__(self, other) -> bool:
        if not isinstance(other, SpectralGrid):
            return NotImplemented
        return self.w0 == other.w0 and self.wn == other.wn and self.dw == other.dw

    def __hash__(self) -> int:
        return hash((self.w0, self.wn, self.dw))
