"""Build the port's state from the JAX package's objects.

Each converter reads the JAX object's fields with ``np.asarray`` (optics
with their grid, grid-bound line arrays, padded and unpadded, near-core
widths, per-tile line ranges, the bin-method settings, continuum and
cross-section tables, the solar spectrum, the cloud-optics tables, the
atmosphere with its aerosols and clouds, the driver's settings) and builds
the port's counterpart, so both packages compute the same thing from the
same state.  Nothing here imports JAX: the objects are read by their fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .clouds.hu_stamnes import HuStamnesLiquidOptics
from .clouds.lib import CloudOpticsLib
from .clouds.pade import PadeCloudOptics
from .framework.atmosphere import Atmosphere
from .framework.driver import RadiationDriver
from .gas_optics import lines as lines_mod
from .gas_optics.continua import OzoneContinuum, WaterVaporContinuum
from .gas_optics.gas_optics import GasOptics
from .gas_optics.tips import PowerLawTips, TabulatedTips
from .gas_optics.voigt_kernel import ChunkRanges
from .gas_optics.xsec import CrossSectionTable
from .optics import Optics
from .solvers.solar_flux import SolarFlux
from .spectral import SpectralGrid

_LINE_ARRAYS = ("c0", "frac0", "vnn", "snn", "yair", "yself", "en", "n", "d",
                "iso0")
_CHUNK_TABLES = ("lo", "nchunks", "cnl", "cnh", "m0l", "m0h", "fll", "flh",
                 "frl", "frh")


def _f32(a, device):
    return torch.as_tensor(np.array(a), dtype=torch.float32, device=device)


def _grid(grid) -> SpectralGrid:
    return SpectralGrid(float(grid.w0), float(grid.wn), float(grid.dw))


def optics_from_jax(optics, device) -> Optics:
    """The port's Optics from a JAX ``Optics`` (dtypes kept), its grid
    carried across."""
    return Optics(*(torch.as_tensor(np.array(getattr(optics, f)),
                                    device=device)
                    for f in ("tau", "omega", "g")),
                  grid=None if optics.grid is None else _grid(optics.grid))


def _tips(tips):
    """A TabulatedTips (tables + fallback) or a PowerLawTips."""
    if hasattr(tips, "_tables"):
        return TabulatedTips.from_arrays(tips._tgrid, tips._tables,
                                         _tips(tips.fallback))
    return PowerLawTips(q296=dict(tips._q296))


def gas_optics_from_jax(gas, device) -> GasOptics:
    """The port's GasOptics from a registered JAX ``GasOptics``."""
    port = GasOptics(_grid(gas.grid), wcutoff=float(gas.wcutoff),
                     hitran_path=gas.hitran_path, tips=_tips(gas.tips),
                     line_chunk=int(gas.line_chunk), method=gas.method,
                     bin_width=float(gas.bin_width),
                     bin_group=int(gas.bin_group), tile=int(gas.tile),
                     ch=int(gas.pallas_ch), device=device)

    def grid_lines(gl):
        return lines_mod.GridLines(
            mol_id=int(gl.mol_id), mass_g=float(gl.mass_g),
            num_iso=int(gl.num_iso),
            **{f: np.asarray(getattr(gl, f)) for f in _LINE_ARRAYS})

    for mol_id, gl in gas.molecules.items():
        port.molecules[mol_id] = grid_lines(gl)
        # The bin methods bracket lines on the unpadded catalog.
        port._raw_bounds[mol_id] = grid_lines(gas._raw_bounds[mol_id])
        port.near_steps[mol_id] = int(gas.near_steps[mol_id])
        cr = gas.chunk_ranges[mol_id]
        port.chunk_ranges[mol_id] = ChunkRanges(
            *(np.asarray(getattr(cr, f)) for f in _CHUNK_TABLES),
            tile=port.tile, ch=port.ch, hw=int(gas.near_hw[mol_id]),
            shift_margin=lines_mod.shift_margin(port.molecules[mol_id],
                                                port.grid.dw))
    if gas.h2o_ctm is not None:
        c = gas.h2o_ctm
        port.h2o_ctm = WaterVaporContinuum(
            cs=_f32(c.cs, device), cf=_f32(c.cf, device),
            t0s=_f32(c.t0s, device), t0f=_f32(c.t0f, device))
    if gas.o3_ctm is not None:
        port.o3_ctm = OzoneContinuum(
            cross_section=_f32(gas.o3_ctm.cross_section, device))

    def table(tb):
        return CrossSectionTable(id=int(tb.id), name=tb.name,
                                 cross_section=_f32(tb.cross_section,
                                                    device))

    port.cfcs = {int(k): table(tb) for k, tb in gas.cfcs.items()}
    port.cias = [(int(s1), int(s2), table(tb)) for s1, s2, tb in gas.cias]
    return port


def solar_from_jax(solar, device) -> SolarFlux:
    """The port's SolarFlux from a JAX ``SolarFlux``."""
    return SolarFlux(grid=_grid(solar.grid),
                     incident_flux=_f32(solar.incident_flux, device))


def pade_from_jax(table, device) -> PadeCloudOptics:
    """The port's PadeCloudOptics from a JAX ``PadeCloudOptics``."""
    return PadeCloudOptics(*(_f32(getattr(table, f.name), device)
                             for f in dataclasses.fields(PadeCloudOptics)))


def hu_stamnes_from_jax(table, device) -> HuStamnesLiquidOptics:
    """The port's HuStamnesLiquidOptics from a JAX
    ``HuStamnesLiquidOptics``."""
    coeffs = {f: _f32(getattr(table, f), device)
              for f in ("a1", "b1", "c1", "a2", "b2", "c2", "a3", "b3", "c3")}
    return HuStamnesLiquidOptics(
        radii=np.asarray(table.radii, np.float64),
        band_lims=_f32(table.band_lims, device), **coeffs,
        min_radius=float(table.min_radius),
        max_radius=float(table.max_radius))


def cloud_lib_from_jax(lib, device) -> CloudOpticsLib:
    """The port's CloudOpticsLib from a JAX ``CloudOpticsLib`` (a Pade or
    Hu & Stamnes liquid table, a Pade ice table)."""
    liquid = (hu_stamnes_from_jax(lib.liquid, device)
              if hasattr(lib.liquid, "a1") else
              pade_from_jax(lib.liquid, device))
    return CloudOpticsLib(liquid=liquid, ice=pade_from_jax(lib.ice, device),
                          liquid_radius=float(lib.liquid_radius))


def driver_from_jax(driver, device, cloud_optics=None) -> RadiationDriver:
    """The port's RadiationDriver from a JAX ``RadiationDriver``: its gas
    optics, solar spectrum, subcolumn count, cloud seed and SW solver.  The
    JAX cloud callback is a closure and cannot be read by its fields: pass
    the port's own as ``cloud_optics`` (for example
    ``cloud_lib_from_jax(lib, device).driver_callback()``)."""
    return RadiationDriver(
        gas_optics_from_jax(driver.lw_gas, device),
        None if driver.sw_gas is None else
        gas_optics_from_jax(driver.sw_gas, device),
        None if driver.solar is None else solar_from_jax(driver.solar,
                                                         device),
        cloud_optics=cloud_optics,
        num_subcolumns=int(driver.num_subcolumns),
        cloud_seed=int(driver.cloud_seed), sw_solver=driver.sw_solver,
        disort_streams=int(driver.disort_streams))


def atmosphere_from_jax(atm) -> Atmosphere:
    """The port's (numpy) Atmosphere from a JAX ``Atmosphere``, aerosols,
    clouds and the clean/clear flags included."""
    def host(v):
        if v is None or isinstance(v, bool):
            return v
        if isinstance(v, dict):
            return {int(k): np.asarray(x) for k, x in v.items()}
        return np.asarray(v)

    return Atmosphere(**{f.name: host(getattr(atm, f.name))
                         for f in dataclasses.fields(Atmosphere)})
