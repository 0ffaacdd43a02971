"""Optical-property container and combination rules (port of
grtcode_tpu/optics.py).

``Optics`` holds three tensors shaped ``(..., nlayers, nwavenumbers)``;
leading axes are batch axes (columns).  ``grid`` is the spectral grid the
last axis lies on, when known.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .spectral import SpectralGrid


@dataclasses.dataclass
class Optics:
    """tau / omega / g on (..., layer, wavenumber); ``grid`` is metadata."""

    tau: torch.Tensor
    omega: torch.Tensor
    g: torch.Tensor
    grid: SpectralGrid | None = None

    # -- constructors ----------------------------------------------------
    @classmethod
    def zeros(cls, num_layers: int, grid: SpectralGrid,
              dtype=torch.float32, batch_shape: tuple = (), *, device):
        z = torch.zeros(tuple(batch_shape) + (num_layers, grid.n),
                        dtype=dtype, device=device)
        return cls(z, z, z, grid=grid)

    @classmethod
    def from_tau(cls, tau, grid: SpectralGrid | None = None):
        """Absorption-only optics (omega = g = 0), e.g. gas optical depth."""
        z = torch.zeros_like(tau)
        return cls(tau, z, z, grid=grid)

    @property
    def num_layers(self) -> int:
        return self.tau.shape[-2]

    # -- operations ------------------------------------------------------
    def __add__(self, other: "Optics") -> "Optics":
        return combine([self, other])

    def update(self, tau=None, omega=None, g=None) -> "Optics":
        """A new Optics with the given fields swapped in (update_optics,
        optics.c:345-357); their shapes must match tau's."""
        for name, new in (("tau", tau), ("omega", omega), ("g", g)):
            if new is not None and tuple(new.shape) != tuple(self.tau.shape):
                raise ValueError(f"{name} shape {tuple(new.shape)} != "
                                 f"{tuple(self.tau.shape)}")
        return Optics(self.tau if tau is None else tau,
                      self.omega if omega is None else omega,
                      self.g if g is None else g, grid=self.grid)

    def sample(self, dest_grid: SpectralGrid, w0: float | None = None,
               wn: float | None = None) -> "Optics":
        """Down-sample onto a coarser sub-grid (sample_optics,
        optics.c:268-341): the destination grid must be a strided
        subdomain of the source; values are picked by striding (views, no
        averaging)."""
        if self.grid is None:
            raise ValueError("sample() requires grid metadata")
        lower = dest_grid.w0 if w0 is None else w0
        upper = dest_grid.last if wn is None else wn
        d0 = dest_grid.point_index(lower)
        dn = dest_grid.point_index(upper)
        s0 = self.grid.point_index(lower)
        sn = self.grid.point_index(upper)
        n_d = dn - d0 + 1
        n_s = sn - s0 + 1
        if n_d > n_s or (n_s - 1) % (n_d - 1) != 0:
            raise ValueError("destination grid must be a strided subdomain")
        factor = (n_s - 1) // (n_d - 1)
        sl = slice(s0, sn + 1, factor)
        return Optics(self.tau[..., sl], self.omega[..., sl], self.g[..., sl],
                      grid=dest_grid)


def combine(optics_list: Sequence[Optics]) -> Optics:
    """Weighted combination of optical properties (optics.c:128-148):

    ``tau = sum tau_k``;  ``omega = sum omega_k tau_k / tau``;
    ``g = sum g_k omega_k tau_k / sum omega_k tau_k``.

    Zero denominators yield 0 instead of NaN.  The result carries the
    first object's grid; two objects on different grids raise.
    """
    if not optics_list:
        raise ValueError("need at least one optics object")
    grid = optics_list[0].grid
    for o in optics_list[1:]:
        if grid is not None and o.grid is not None and o.grid != grid:
            raise ValueError("incompatible spectral grids")
    tau = sum(o.tau for o in optics_list)
    wtau = sum(o.omega * o.tau for o in optics_list)
    gwtau = sum(o.g * o.omega * o.tau for o in optics_list)
    omega = torch.where(tau > 0, wtau / torch.where(tau > 0, tau, 1.0), 0.0)
    g = torch.where(wtau > 0, gwtau / torch.where(wtau > 0, wtau, 1.0), 0.0)
    return Optics(tau, omega, g, grid=grid)
