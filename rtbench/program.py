"""The system under test: ``grtcode_tpu_torch``'s ``RadiationDriver``,
built from a deployment's raw inputs through the port's own public
constructors, and the ``Atmosphere`` of a call.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from grtcode_tpu_torch import constants
from grtcode_tpu_torch.framework.atmosphere import Atmosphere
from grtcode_tpu_torch.framework.driver import RadiationDriver
from grtcode_tpu_torch.gas_optics.continua import (OzoneContinuum,
                                                    WaterVaporContinuum)
from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.gas_optics.xsec import CrossSectionTable
from grtcode_tpu_torch.solvers.solar_flux import SolarFlux
from grtcode_tpu_torch.spectral import SpectralGrid
from grtcode_tpu_torch.utils import metrics

from .deployment import Band, Deployment

# The kernels' dispatchers, whose ``.launches`` the traced run reads.
from grtcode_tpu_torch.gas_optics.bins_kernel import accumulate_bins_kernel
from grtcode_tpu_torch.gas_optics.voigt_kernel import accumulate_voigt

LAUNCH_COUNTERS = {"k1": accumulate_voigt, "k2": accumulate_bins_kernel}


def _gas(band: Band, device) -> GasOptics:
    grid = SpectralGrid(band.w0, band.wn, band.dw)
    if grid.n != band.n:
        raise ValueError(f"{band.name}: the program's grid has {grid.n} "
                         f"points, the deployment's {band.n}")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    gas = GasOptics(
        grid, wcutoff=band.cutoff, line_chunk=1024, method=band.method,
        bin_width=band.bin_width,
        h2o_ctm=WaterVaporContinuum(**{k: f32(v)
                                       for k, v in band.h2o.items()}),
        o3_ctm=OzoneContinuum(cross_section=f32(band.o3)), device=device)
    for mol, p in band.lines.items():
        gas.add_catalog(synthetic_catalog(mol, **p))
    for cfc_id, sigma in band.cfcs.items():
        gas.cfcs[cfc_id] = CrossSectionTable(
            id=cfc_id, name=f"cfc{cfc_id}", cross_section=f32(sigma))
    for s1, s2, sigma in band.cias:
        # The port keeps the pressure-squared column factor folded into
        # its CIA tables, as GasOptics.add_cia does for a file.
        gas.cias.append((s1, s2, CrossSectionTable(
            id=s1, name=f"cia_{s1}_{s2}",
            cross_section=f32(sigma * constants.CIA_COLUMN_FACTOR))))
    return gas


def build_driver(dep: Deployment, device) -> RadiationDriver:
    """The clear-sky driver of the deployment on ``device`` (longwave
    only where the deployment has no shortwave band), with the
    configuration's ``sw_solver`` and ``disort_streams``, which the
    driver checks."""
    device = torch.device(device)
    cfg = dep.config
    if cfg["sky"] != "csaf":
        raise ValueError(f"{cfg['name']}: sky {cfg['sky']!r} is not built: "
                         "the benchmark makes no cloud state (fractions, "
                         "water contents, layer thickness, cloud optics) "
                         "and reads no 'af' tier; only 'csaf'")
    lw = _gas(dep.bands["lw"], device)
    options = dict(sw_solver=cfg.get("sw_solver", "two_stream"),
                   disort_streams=cfg.get("disort_streams", 16))
    if "sw" not in dep.bands:
        return RadiationDriver(lw, **options)
    sw = _gas(dep.bands["sw"], device)
    solar = SolarFlux(grid=sw.grid, incident_flux=torch.as_tensor(
        dep.solar, dtype=torch.float32, device=device))
    return RadiationDriver(lw, sw, solar, **options)


def _one_grid(grids) -> np.ndarray:
    """The surface grid of a call's columns: the program takes one for
    all of them."""
    grids = np.asarray(grids, np.float64)
    if not np.all(grids == grids[:1]):
        raise ValueError("the columns of one call have different surface "
                         "grids; the program takes one a call")
    return grids[0]


def atmosphere(cols: dict) -> Atmosphere:
    """The clean, clear ``Atmosphere`` of a call's columns, with their
    surface spectra as the layout gives them."""
    return Atmosphere(
        level_pressure=cols["p_lev"], level_temperature=cols["t_lev"],
        surface_temperature=cols["t_surf"], ppmv=cols["ppmv"],
        cfc_ppmv=cols["cfc_ppmv"], cia_ppmv=cols["cia_ppmv"],
        emissivity_grid=_one_grid(cols["emissivity_grid"]),
        emissivity=cols["emissivity"],
        cos_zenith=cols["mu"], total_solar_irradiance=cols["tsi"],
        albedo_grid=_one_grid(cols["albedo_grid"]), albedo=cols["albedo"],
        clean=True, clear=True)


def run(driver: RadiationDriver, atm: Atmosphere, spectral_chunks: int):
    """The program's entry: the fluxes of every sky tier, on the device."""
    return driver.run(atm, spectral_chunks=spectral_chunks)


def host(results) -> dict:
    """The fluxes on the host, as a user takes them ({"rlu" | "rld" |
    "rsu" | "rsd": (B, nlevels) numpy})."""
    return results.host()["csaf"]


def call(driver: RadiationDriver, atm: Atmosphere, spectral_chunks: int):
    """One timed call: the run and its fluxes on the host."""
    return host(run(driver, atm, spectral_chunks))


def layer_times():
    """The program's block that times each ``grtcode::`` device layer in
    the replays of captured steps inside it (``metrics.layer_times``)."""
    return metrics.layer_times()


def step_stats(driver: RadiationDriver) -> dict:
    """The driver's step-cache counts, layer times and line-prep counts
    (``RadiationDriver.step_stats``)."""
    return driver.step_stats()
