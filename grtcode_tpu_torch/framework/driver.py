"""The radiation driver, clear-sky aerosol-free tier (port of
grtcode_tpu/framework/driver.py).

One batched step per call: gas optical depth per band (one kernel launch
per molecule), Rayleigh for the shortwave, the longwave and shortwave
solvers, and trapezoid-integrated per-level fluxes.  The longwave pass
always runs; shortwave fluxes count only where cos(zenith) > 0 (the
full-batch day mask).  With ``spectral_chunks=S > 1`` each band is
streamed through S spectral blocks one after the other, so a production
resolution never holds a band-wide tau.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants
from ..gas_optics.gas_optics import GasOptics
from ..optics import Optics, combine
from ..solvers.longwave import longwave_fluxes
from ..solvers.rayleigh import rayleigh_tau
from ..solvers.shortwave import shortwave_fluxes
from ..solvers.solar_flux import SolarFlux
from ..utils import curtis_godson as cg
from ..utils.interp import (block_trapezoid_weights, interpolate_to_grid_np,
                            trapezoid_uniform)
from .atmosphere import Atmosphere

DIFFUSE_MU = 0.5  # cosine of the diffuse angle


@dataclasses.dataclass
class FluxResults:
    """Per-tier fluxes: {"csaf" -> {"rlu"|"rld"|"rsu"|"rsd" -> (B, nlevels)
    integrated [W m-2] tensors on the driver's device}}."""

    tiers: dict
    integrated: bool


class RadiationDriver:
    """Holds the per-band gas optics + solar spectrum and runs the
    clear-sky aerosol-free tier on their device."""

    def __init__(self, lw_gas: GasOptics, sw_gas: GasOptics | None = None,
                 solar: SolarFlux | None = None,
                 sw_solver: str = "two_stream"):
        self.lw_gas = lw_gas
        self.sw_gas = sw_gas
        self.solar = solar
        self.sw_solver = sw_solver
        self.device = lw_gas.device

    def _surface_spectra(self, atm: Atmosphere):
        """Emissivity / albedo on the solver grids (linear interpolation,
        constant extrapolation), all columns at once."""
        B = atm.batch
        if atm.emissivity is not None:
            emis = interpolate_to_grid_np(
                self.lw_gas.grid, atm.emissivity_grid,
                np.asarray(atm.emissivity, np.float64),
                extrapolate="constant")
        else:
            emis = np.ones((B, self.lw_gas.grid.n))
        albedo = None
        if self.sw_gas is not None:
            if atm.albedo is not None:
                albedo = interpolate_to_grid_np(
                    self.sw_gas.grid, atm.albedo_grid,
                    np.asarray(atm.albedo, np.float64),
                    extrapolate="constant")
            else:
                albedo = np.zeros((B, self.sw_gas.grid.n))
        return emis, albedo

    def run(self, atm: Atmosphere, integrated: bool = True, mesh=None,
            column_chunk: int | None = None, col_index=None,
            spectral_chunks: int | None = None) -> FluxResults:
        """The clear-sky aerosol-free fluxes of the batch.

        ``spectral_chunks`` streams each band through that many spectral
        blocks, one after the other: the block is ``ceil(n / S)`` rounded
        up to the band's ``block_quantum``, the per-column surface spectra
        and the solar spectrum are zero-padded to S blocks, and each
        block's fluxes are reduced with its exact trapezoid weights and
        summed.  ``col_index`` only keys the cloudy tier's subcolumn draws
        and has no effect here.  Everything this slice does not port
        raises :class:`NotImplementedError` naming its ROADMAP item.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-GPU runs are ROADMAP queue 1, O6")
        if column_chunk is not None:
            raise NotImplementedError(
                "column_chunk: column chunking is ROADMAP queue 1, O2")
        S = 1 if spectral_chunks is None else int(spectral_chunks)
        if S < 1:
            raise ValueError(
                f"spectral_chunks must be >= 1, got {spectral_chunks}")
        if not integrated:
            raise NotImplementedError(
                "integrated=False: spectrally resolved output is ROADMAP "
                "queue 1, O2")
        if not atm.clean:
            raise NotImplementedError(
                "aerosols: the clear-sky (CS) tier is ROADMAP queue 1, O2")
        if not atm.clear:
            raise NotImplementedError(
                "clouds: the all-sky (AF) tier is ROADMAP queue 1, O3")
        if self.sw_solver != "two_stream":
            raise NotImplementedError(
                f"sw_solver={self.sw_solver!r}: DISORT is ROADMAP queue 1, "
                "O4")

        dev = self.device
        f32 = torch.float32

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=f32,
                                   device=dev)

        def vmr(ppmv, keep=None):
            return {k: t(np.asarray(v, np.float64) * 1e-6)
                    for k, v in ppmv.items() if keep is None or k in keep}

        def blocks(gas):
            """(block size, block starts) of a band: the whole band
            unstreamed."""
            n = gas.grid.n
            if S == 1:
                return n, [0]
            q = gas.block_quantum
            size = -(-(-(-n // S)) // q) * q
            return size, [s * size for s in range(S)]

        def spectrum(a, size, count):
            """A (B, n) host spectrum on the device, zero-padded to the
            blocks' total width."""
            a = np.asarray(a, np.float64)
            return t(np.pad(a, ((0, 0), (0, size * count - a.shape[-1]))))

        def integrate(fx, grid, start, size):
            if S == 1:
                return trapezoid_uniform(fx, grid.dw)
            return (fx * block_trapezoid_weights(start, size, grid.n,
                                                 grid.dw, dev)).sum(-1)

        emis_np, albedo_np = self._surface_spectra(atm)
        p_lev = t(atm.level_pressure)
        t_lev = t(atm.level_temperature)
        t_surf = t(atm.surface_temperature)
        t_lay = t(atm.layer_temperature)
        cfc_vmr = vmr(atm.cfc_ppmv)
        cia_vmr = vmr(atm.cia_ppmv)

        lwg = self.lw_gas.grid
        vmr_lw = vmr(atm.ppmv, self.lw_gas.molecules)
        size_lw, starts_lw = blocks(self.lw_gas)
        emis = spectrum(emis_np, size_lw, len(starts_lw))
        rlu = rld = 0.0
        for start in starts_lw:
            window = ({} if S == 1 else
                      dict(block_start=start, block_size=size_lw))
            tau_lw = self.lw_gas.optical_depth(
                p_lev, t_lev, vmr_lw, cfc_vmr=cfc_vmr, cia_vmr=cia_vmr,
                **window)
            gas_lw = Optics.from_tau(tau_lw)
            flu, fld = longwave_fluxes(
                gas_lw.tau, gas_lw.omega, t_surf, t_lay, t_lev,
                emis[:, start:start + size_lw],
                lwg.wavenumbers(dev, start, size_lw))
            del tau_lw, gas_lw
            rlu = rlu + integrate(flu, lwg, start, size_lw)
            rld = rld + integrate(fld, lwg, start, size_lw)
            del flu, fld

        mu_host = atm.cos_zenith
        with_sw = (self.sw_gas is not None and mu_host is not None
                   and bool(np.any(np.asarray(mu_host) > 0.0)))
        if not with_sw:
            zero = torch.zeros_like(rlu)
            return FluxResults(
                tiers={"csaf": {"rlu": rlu, "rld": rld, "rsu": zero,
                                "rsd": zero.clone()}},
                integrated=True)

        swg = self.sw_gas.grid
        vmr_sw = vmr(atm.ppmv, self.sw_gas.molecules)
        size_sw, starts_sw = blocks(self.sw_gas)
        albedo = spectrum(albedo_np, size_sw, len(starts_sw))
        sol = self.solar.incident_flux
        sol = torch.nn.functional.pad(
            sol, (0, size_sw * len(starts_sw) - sol.shape[-1]))
        n_air = cg.number_densities(p_lev * constants.MB_TO_ATM)
        mu_raw = t(mu_host)
        tsi = t(atm.total_solar_irradiance
                if atm.total_solar_irradiance is not None
                else np.zeros(atm.batch))
        mu = torch.clamp(mu_raw, min=1e-6)
        day = (mu_raw > 0.0).to(f32)[:, None]
        rsu = rsd = 0.0
        for start in starts_sw:
            window = ({} if S == 1 else
                      dict(block_start=start, block_size=size_sw))
            tau_sw = self.sw_gas.optical_depth(
                p_lev, t_lev, vmr_sw, cfc_vmr=cfc_vmr, cia_vmr=cia_vmr,
                **window)
            ray = rayleigh_tau(n_air, swg.wavenumbers(dev, start, size_sw))
            gasray = combine([
                Optics.from_tau(tau_sw),
                Optics(ray, torch.ones_like(ray), torch.zeros_like(ray))])
            del tau_sw, ray
            alb = albedo[:, start:start + size_sw]
            fsu, fsd = shortwave_fluxes(
                gasray.tau, gasray.omega, gasray.g, mu,
                torch.full_like(mu, DIFFUSE_MU), alb, alb, tsi,
                sol[start:start + size_sw])
            del gasray
            rsu = rsu + integrate(fsu, swg, start, size_sw) * day
            rsd = rsd + integrate(fsd, swg, start, size_sw) * day
            del fsu, fsd
        return FluxResults(
            tiers={"csaf": {"rlu": rlu, "rld": rld, "rsu": rsu, "rsd": rsd}},
            integrated=True)
