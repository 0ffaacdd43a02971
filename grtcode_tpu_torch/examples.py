"""The repo's RFMIP-IRF production-scale configuration and its
reference-C driver-golden case, built for the port.

:func:`rfmip_like` builds the same model and batch as the JAX benchmark
(``bench.py::build``): 7 longwave molecules at HITRAN2016-scale line
counts (366,000 lines) and 4 shortwave molecules (64,000 lines), H2O + O3
continua, 3 CFC and 3 CIA cross sections, the LW band 1-3250 cm-1 (at 0.1
by default; ``lw_res=0.01`` is the production resolution, 324,901 points)
with the LW method ``lw_method`` (line_sample by default, or a bin method),
the SW band 1-50,000 cm-1 at 1.0 with line_sample, and B = 32 columns of
54 layers.  Seeds, line counts, grids and profiles are the benchmark's, so
the catalogs and batch are identical; ``smoke`` shrinks the line counts
64x and the grids 8x.

:func:`golden_case` builds the clean, clear case of the end-to-end
reference-C golden (tests/data/driver_golden.txt) from the input files
``tools/goldens/driver_inputs.write_inputs`` writes, through the port's own
file readers.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import constants
from .framework.atmosphere import Atmosphere
from .framework.driver import RadiationDriver
from .gas_optics.continua import OzoneContinuum, WaterVaporContinuum
from .gas_optics.gas_optics import GasOptics
from .gas_optics.hitran import synthetic_catalog
from .gas_optics.molecules import CfcId, CiaId
from .gas_optics.xsec import CrossSectionTable
from .solvers.solar_flux import SolarFlux
from .spectral import SpectralGrid

# HITRAN2016-scale line counts per band (the benchmark's LW_LINES /
# SW_LINES).
LW_LINES = {1: 60000, 2: 100000, 3: 120000, 4: 30000, 6: 50000,
            5: 4000, 7: 2000}
SW_LINES = {1: 40000, 2: 10000, 3: 10000, 7: 4000}

SURFACE_ALBEDO = 0.15   # the benchmark's grey shortwave albedo
SURFACE_DT = 1.5        # surface temperature above the bottom level [K]


def rfmip_like(smoke: bool = False, batch_size: int | None = None, *,
               device, lw_method: str = "line_sample", lw_res: float = 0.1):
    """(lw_gas, sw_gas, solar, batch, B, nlayers) on ``device``, as
    ``bench.build(smoke, batch_size, lw_method=..., lw_res=...)`` returns
    them for the JAX package.  ``batch`` holds numpy profiles;
    :func:`atmosphere` turns it into an :class:`Atmosphere`."""
    shrink = 64 if smoke else 1
    lw_grid = SpectralGrid(1.0, 3250.0, lw_res * (8 if smoke else 1))
    sw_grid = SpectralGrid(1.0, 50000.0, 1.0 * (8 if smoke else 1))
    B = batch_size if batch_size else (4 if smoke else 32)
    nlayers = 54

    def catalog(mol_id, grid, L, seed):
        rng = np.random.default_rng(seed)
        vnn = np.sort(rng.uniform(grid.w0, grid.last, L))
        return synthetic_catalog(
            mol_id, vnn, 10.0 ** rng.uniform(-23.5, -19.5, L),
            yair=rng.uniform(0.02, 0.11, L), yself=rng.uniform(0.05, 0.4, L),
            en=rng.uniform(0.0, 2800.0, L), n=rng.uniform(0.35, 0.85, L),
            d=rng.uniform(-0.01, 0.01, L))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def continua(grid):
        w = np.asarray(grid.wavenumbers_np())
        h2o = WaterVaporContinuum(
            cs=f32(2.5e-22 * np.exp(-w / 900.0) + 4e-25),
            cf=f32(6.0e-25 * np.exp(-w / 1500.0) + 1e-27),
            t0s=f32(0.012 + 0.004 * np.sin(w / 800.0)),
            t0f=f32(0.006 + 0.002 * np.cos(w / 1100.0)))
        o3 = OzoneContinuum(cross_section=f32(
            4e-22 * np.exp(-0.5 * ((w - 17500.0) / 2600.0) ** 2)))
        return h2o, o3

    def xsec_tables(gas, grid):
        w = np.asarray(grid.wavenumbers_np())
        # 3 CFC species + 3 CIA pairs (N2-N2, O2-N2, O2-O2).
        for cfc_id, center in ((0, 850.0), (1, 920.0), (3, 790.0)):
            sig = 8e-19 * np.exp(-0.5 * ((w - center) / 40.0) ** 2)
            gas.cfcs[cfc_id] = CrossSectionTable(
                id=cfc_id, name=f"cfc{cfc_id}", cross_section=f32(sig))
        for k, (s1, s2, center, width) in enumerate(
                ((0, 0, 95.0, 70.0), (1, 0, 150.0, 90.0),
                 (1, 1, 1550.0, 120.0))):
            sig = 4e-44 * np.exp(-0.5 * ((w - center) / width) ** 2)
            gas.cias.append((s1, s2, CrossSectionTable(
                id=s1, name=f"cia{k}", cross_section=f32(
                    np.float64(sig) * constants.CIA_COLUMN_FACTOR))))

    lw_h2o, lw_o3 = continua(lw_grid)
    lw_gas = GasOptics(lw_grid, line_chunk=1024, h2o_ctm=lw_h2o,
                       o3_ctm=lw_o3, method=lw_method, device=device)
    for seed, (mol, L) in enumerate(LW_LINES.items()):
        lw_gas.add_catalog(catalog(mol, lw_grid, max(64, L // shrink), seed))
    xsec_tables(lw_gas, lw_grid)

    sw_h2o, sw_o3 = continua(sw_grid)
    sw_gas = GasOptics(sw_grid, line_chunk=1024, h2o_ctm=sw_h2o,
                       o3_ctm=sw_o3, device=device)
    for seed, (mol, L) in enumerate(SW_LINES.items()):
        sw_gas.add_catalog(
            catalog(mol, sw_grid, max(64, L // shrink), 100 + seed))
    xsec_tables(sw_gas, sw_grid)

    solar = SolarFlux.from_samples(
        np.linspace(1.0, 50100.0, 256),
        np.exp(-0.5 * ((np.linspace(1.0, 50100.0, 256) - 18000.0)
                       / 9000.0) ** 2) + 1e-3, sw_grid, device)

    rng = np.random.default_rng(7)
    nlev = nlayers + 1
    batch = {
        "p_lev": np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1)),
        "t_lev": np.linspace(210.0, 290.0, nlev)[None, :]
        + rng.uniform(-5, 5, (B, nlev)),
        "vmr": {1: 2.0 + 19000.0 * (np.arange(nlev) / nlev)[None, :] ** 3
                * np.ones((B, 1)),
                2: np.full((B, nlev), 400.0), 3: np.full((B, nlev), 1.0),
                4: np.full((B, nlev), 0.33), 5: np.full((B, nlev), 0.1),
                6: np.full((B, nlev), 1.85),
                7: np.full((B, nlev), 209000.0)},
        "cfc_vmr": {0: np.full((B, nlev), 2.6e-4),
                    1: np.full((B, nlev), 5.2e-4),
                    3: np.full((B, nlev), 1.0e-4)},
        "cia_vmr": {0: np.full((B, nlev), 781000.0),
                    1: np.full((B, nlev), 209000.0)},
        "mu": rng.uniform(0.1, 0.95, B),
        "tsi": np.full(B, 1361.0),
    }
    return lw_gas, sw_gas, solar, batch, B, nlayers


def atmosphere(batch: dict) -> Atmosphere:
    """The clean, clear :class:`Atmosphere` of an :func:`rfmip_like` batch:
    levels and abundances (ppmv) as given, the surface 1.5 K above the
    bottom level, emissivity 1, grey albedo 0.15."""
    B = batch["p_lev"].shape[0]
    return Atmosphere(
        level_pressure=batch["p_lev"], level_temperature=batch["t_lev"],
        surface_temperature=batch["t_lev"][:, -1] + SURFACE_DT,
        ppmv=batch["vmr"], cfc_ppmv=batch["cfc_vmr"],
        cia_ppmv=batch["cia_vmr"], cos_zenith=batch["mu"],
        total_solar_irradiance=batch["tsi"],
        albedo_grid=np.array([constants.MIN_WAVENUMBER,
                              constants.MAX_WAVENUMBER]),
        albedo=np.full((B, 2), SURFACE_ALBEDO))


def golden_case(directory: str, inputs: dict, lw_grid: SpectralGrid,
                sw_grid: SpectralGrid, *, device):
    """(RadiationDriver, Atmosphere) of the driver golden's CSAF case.

    ``directory`` holds the files ``driver_inputs.write_inputs`` wrote
    (HITRAN .par, MT-CKD and O3 continua, CFC-11/12 and N2-N2 / O2-N2 CIA
    cross sections, solar spectrum) and ``inputs`` is the atmosphere it
    returned.
    """
    def path(*name):
        return os.path.join(directory, *name)

    def gas(grid):
        g = GasOptics(
            grid, hitran_path=path("synthetic.par"),
            h2o_ctm=WaterVaporContinuum.from_directory(path("h2o_ctm"), grid,
                                                       device),
            o3_ctm=OzoneContinuum.from_file(path("o3_ctm.csv"), grid, device),
            device=device)
        for mol in (1, 2, 3, 4, 6):
            g.add_molecule(mol)
        g.add_cfc(CfcId.CFC11, path("cfc11.csv"))
        g.add_cfc(CfcId.CFC12, path("cfc12.csv"))
        g.add_cia(CiaId.N2, CiaId.N2, path("cia_n2n2.csv"))
        g.add_cia(CiaId.O2, CiaId.N2, path("cia_o2n2.csv"))
        return g

    driver = RadiationDriver(
        gas(lw_grid), gas(sw_grid),
        SolarFlux.from_csv(path("solar.csv"), sw_grid, device))
    a = inputs
    atm = Atmosphere(
        level_pressure=a["p"][None], level_temperature=a["t"][None],
        surface_temperature=np.array([a["ts"]]),
        ppmv={m: v[None] for m, v in a["ppmv"].items()},
        cfc_ppmv={k: v[None] for k, v in a["cfc_ppmv"].items()},
        cia_ppmv={k: v[None] for k, v in a["cia_ppmv"].items()},
        emissivity_grid=a["emis_w"], emissivity=a["emis"][None],
        cos_zenith=np.array([a["mu"]]),
        total_solar_irradiance=np.array([a["tsi"]]),
        albedo_grid=a["alb_w"], albedo=a["alb"][None])
    return driver, atm
