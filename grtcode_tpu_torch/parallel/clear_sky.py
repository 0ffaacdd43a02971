"""The two-band clear-sky radiative transfer step over a mesh (port of
grtcode_tpu/parallel/clear_sky.py).

Per column: gas optical depth on the LW and SW grids (line-by-line Voigt
+ continua, CFC, CIA), the four-stream longwave solver, Rayleigh
scattering + the delta-Eddington / adding shortwave solver, and
trapezoid-integrated per-level fluxes: the reference driver's clear-clean
sky tier (framework/src/driver.c:360-599).  A thin adapter over
:class:`grtcode_tpu_torch.framework.driver.RadiationDriver`, which runs it
unsharded or over a (columns x spectral) mesh of ranks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..framework.driver import RadiationDriver
from ..gas_optics.gas_optics import GasOptics
from ..solvers.solar_flux import SolarFlux


def _ids(gas: GasOptics, group: str) -> list:
    if group == "molecules":
        return list(gas.molecules)
    if group == "cfcs":
        return list(gas.cfcs)
    if group == "cias":
        return sorted({s for s1, s2, _ in gas.cias for s in (s1, s2)})
    raise ValueError(group)


def stack_vmr(gas: GasOptics, vmr: dict, group: str = "molecules"):
    """Stack a {species id -> (..., nlevels)} dict into (..., M, nlevels)
    float32 following the gas-optics registration order."""
    ids = _ids(gas, group)
    if not ids:
        return None
    return torch.stack([torch.as_tensor(np.asarray(vmr[i]),
                                        dtype=torch.float32) for i in ids],
                       dim=-2)


def _unstack(gas: GasOptics, rows, group: str) -> dict:
    """(..., M, nlevels) stacked vmr -> {species id: (..., nlevels)}."""
    return {i: rows[..., k, :] for k, i in enumerate(_ids(gas, group))}


@dataclasses.dataclass
class ClearSkyRT:
    """Two-band clear(-clean)-sky radiative transfer, unsharded or over a
    mesh of ranks.

    Attributes:
      lw_gas: GasOptics bound to the longwave grid.
      sw_gas: GasOptics bound to the shortwave grid (None = LW only, like
        the shipped ERA5 binary, era5/src/era5.c:406-415).
      solar: normalized incident solar spectrum on the SW grid.
    """

    lw_gas: GasOptics
    sw_gas: GasOptics | None = None
    solar: SolarFlux | None = None

    def step(self, mesh=None, integrated: bool = True):
        """The batched step function.

        It takes a dict batch with arrays:
          p_lev, t_lev: (B, nlevels) [mb], [K]
          t_surf, emis, mu_dir, albedo_dir, albedo_dif, tsi: (B,)
          vmr_lw: (B, M_lw, nlevels); vmr_sw: (B, M_sw, nlevels)
          optional cfc_vmr_lw / cia_vmr_lw: (B, C, nlevels)
        and returns {"rlu", "rld", "rsu", "rsd"}: (B, nlevels) integrated
        fluxes [W m-2], or (B, nlevels, nw_band) spectra when
        ``integrated=False``, on every rank of ``mesh`` (a (columns x
        spectral) DeviceMesh: the batch splits over "columns" and each
        band's grid into contiguous blocks over "spectral").
        """
        if self.sw_gas is not None and self.solar is None:
            raise ValueError("sw_gas set but no solar flux")
        driver = RadiationDriver(lw_gas=self.lw_gas, sw_gas=self.sw_gas,
                                 solar=self.solar)
        dev = driver.device
        has_sw = self.sw_gas is not None

        def fn(batch):
            def f32(k):
                return torch.as_tensor(np.asarray(batch[k]),
                                       dtype=torch.float32, device=dev)

            t_lev = f32("t_lev")
            B = t_lev.shape[0]

            def grey(k, gas):
                return f32(k)[:, None].expand(B, gas.grid.n)

            col = {
                "p_lev": f32("p_lev"),
                "t_lev": t_lev,
                "t_lay": 0.5 * (t_lev[:, :-1] + t_lev[:, 1:]),
                "t_surf": f32("t_surf"),
                "emis": grey("emis", self.lw_gas),
                "vmr_lw": _unstack(self.lw_gas, f32("vmr_lw"), "molecules"),
                "cfc_vmr": (_unstack(self.lw_gas, f32("cfc_vmr_lw"), "cfcs")
                            if "cfc_vmr_lw" in batch else {}),
                "cia_vmr": (_unstack(self.lw_gas, f32("cia_vmr_lw"), "cias")
                            if "cia_vmr_lw" in batch else {}),
            }
            mu = None
            if has_sw:
                col.update({
                    "mu": f32("mu_dir"),
                    "tsi": f32("tsi"),
                    "albedo": grey("albedo_dir", self.sw_gas),
                    "albedo_dif": grey("albedo_dif", self.sw_gas),
                    "vmr_sw": _unstack(self.sw_gas, f32("vmr_sw"),
                                       "molecules"),
                })
                mu = np.asarray(batch["mu_dir"], np.float64)
            return driver.run_columns(col, mu, integrated=integrated,
                                      mesh=mesh).tiers["csaf"]

        return fn
