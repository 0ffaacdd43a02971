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

:func:`allsky_like` adds the other two sky tiers to that configuration:
Angstrom aerosols, an ERA5-like cloud field drawn into stochastic
subcolumns with synthetic Pade optics, and half the columns at night.

:func:`golden_case` builds the end-to-end reference-C golden's case
(tests/data/driver_golden.txt) from the input files
``tools/goldens/driver_inputs.write_inputs`` writes, through the port's own
file readers: clean and clear, or with its aerosols and its fixed-condensate
clouds.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import constants
from .clouds.lib import CloudOpticsLib, band_to_grid, ice_particle_size
from .clouds.pade import PadeCloudOptics, synthetic_pade_table
from .framework.atmosphere import Atmosphere
from .framework.driver import RadiationDriver
from .gas_optics.continua import OzoneContinuum, WaterVaporContinuum
from .gas_optics.gas_optics import GasOptics
from .gas_optics.hitran import synthetic_catalog
from .gas_optics.molecules import CfcId, CiaId
from .gas_optics.xsec import CrossSectionTable
from .optics import Optics
from .solvers.solar_flux import SolarFlux
from .spectral import SpectralGrid

# HITRAN2016-scale line counts per band (the benchmark's LW_LINES /
# SW_LINES).
LW_LINES = {1: 60000, 2: 100000, 3: 120000, 4: 30000, 6: 50000,
            5: 4000, 7: 2000}
SW_LINES = {1: 40000, 2: 10000, 3: 10000, 7: 4000}

SURFACE_ALBEDO = 0.15   # the benchmark's grey shortwave albedo
SURFACE_DT = 1.5        # surface temperature above the bottom level [K]

# Hydrostatic layer thickness, as the ERA5 app computes it.
GAS_CONSTANT = 8.314462     # [J mol-1 K-1]
MOLAR_MASS_KG = 28.9647e-3  # dry air [kg mol-1]
GRAVITY = 9.81              # [m s-2]


def line_lists(lw_grid: SpectralGrid, sw_grid: SpectralGrid,
               shrink: int = 1) -> dict:
    """The raw line parameters of :func:`rfmip_like`'s catalogs, as the
    benchmark draws them: ``{"lw": {mol: params}, "sw": {mol: params}}``,
    each ``params`` a dict of float64 arrays ``vnn`` (ascending, uniform
    over the band's grid), ``s0`` (HITRAN-convention intensity), ``yair``,
    ``yself``, ``en``, ``n`` and ``d``; LW molecule k from seed k, SW
    molecule k from seed 100 + k, ``LW_LINES`` / ``SW_LINES`` lines each
    divided by ``shrink`` (at least 64)."""
    def draw(grid, L, seed):
        rng = np.random.default_rng(seed)
        return dict(
            vnn=np.sort(rng.uniform(grid.w0, grid.last, L)),
            s0=10.0 ** rng.uniform(-23.5, -19.5, L),
            yair=rng.uniform(0.02, 0.11, L), yself=rng.uniform(0.05, 0.4, L),
            en=rng.uniform(0.0, 2800.0, L), n=rng.uniform(0.35, 0.85, L),
            d=rng.uniform(-0.01, 0.01, L))

    return {
        "lw": {mol: draw(lw_grid, max(64, L // shrink), seed)
               for seed, (mol, L) in enumerate(LW_LINES.items())},
        "sw": {mol: draw(sw_grid, max(64, L // shrink), 100 + seed)
               for seed, (mol, L) in enumerate(SW_LINES.items())}}


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

    lines = line_lists(lw_grid, sw_grid, shrink)
    lw_h2o, lw_o3 = continua(lw_grid)
    lw_gas = GasOptics(lw_grid, line_chunk=1024, h2o_ctm=lw_h2o,
                       o3_ctm=lw_o3, method=lw_method, device=device)
    for mol, params in lines["lw"].items():
        lw_gas.add_catalog(synthetic_catalog(mol, **params))
    xsec_tables(lw_gas, lw_grid)

    sw_h2o, sw_o3 = continua(sw_grid)
    sw_gas = GasOptics(sw_grid, line_chunk=1024, h2o_ctm=sw_h2o,
                       o3_ctm=sw_o3, device=device)
    for mol, params in lines["sw"].items():
        sw_gas.add_catalog(synthetic_catalog(mol, **params))
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


def ice_pade_table(nbnd: int = 16, w0: float = 1.0, wn: float = 50000.0,
                   seed: int = 1, *, device) -> PadeCloudOptics:
    """A synthetic ice table whose optics are physical at every radius of
    its size regimes ([2, 20] and [20, 90] microns about 10 and 40, so the
    offset x from the reference radius has |x| <= 50): each Pade
    numerator is p0 x^2 + p1 x + p2 and each denominator q0 x^2 + q1 x +
    1 with |p0|, |q0| <= 1e-6 and |p1|, |q1| <= 1e-5, so the x terms move
    a ratio by at most 3.5e-3 and the denominators stay within 3e-3 of 1.
    The constant terms, ice-like: extinction 0.042-0.078 m2 g-1, single-
    scattering albedo 0.855-0.945, asymmetry 0.675-0.825; hence 0 < ssa <
    0.96 and 0 < g < 0.84 everywhere.  (synthetic_pade_table's larger
    denominator terms give ssa up to 1.47 and g up to 1.76 at cirrus
    radii, where DISORT returns NaN.)"""
    rng = np.random.default_rng(seed)
    edges = np.linspace(w0, wn, nbnd + 1)
    band_lims = np.stack([edges[:-1], edges[1:]])
    sizereg = np.array([[2.0, 20.0], [20.0, 90.0]])
    ref = np.array([10.0, 40.0])
    scale = np.array([1e-6, 1e-5])

    def coeffs(base, jitter):
        p = np.concatenate(
            [rng.uniform(-1.0, 1.0, (nbnd, 2, 2)) * scale,
             base * rng.uniform(1.0 - jitter, 1.0 + jitter, (nbnd, 2, 1))],
            axis=-1)
        q = np.concatenate(
            [rng.uniform(-1.0, 1.0, (nbnd, 2, 2)) * scale,
             np.ones((nbnd, 2, 1))], axis=-1)
        return p, q

    ep, eq = coeffs(0.06, 0.3)
    sp, sq = coeffs(0.90, 0.05)
    ap, aq = coeffs(0.75, 0.1)
    return PadeCloudOptics.from_arrays(band_lims, sizereg, ref, ep, eq, sp,
                                       sq, ap, aq, device=device)


def allsky_like(smoke: bool = False, *, device):
    """(RadiationDriver, Atmosphere) of the all-sky step: the gas optics,
    solar spectrum and batch of :func:`rfmip_like` (line_sample at LW 0.1)
    with, from fixed seeds,

    * an Angstrom aerosol profile (the reference-C golden's shape stretched
      to 54 layers, alpha 1.48, each column scaled by 0.5-1.5);
    * an ERA5-like cloud field: a liquid deck at 700-900 mb with cloud
      fraction 0.3-1.0 and LWC up to 0.3 g m-3, cirrus at 200-350 mb with
      IWC up to 0.02 g m-3, hydrostatic layer thickness;
    * every odd column at night (cos zenith -0.9 to 0), so day compaction
      is on the path;
    * a synthetic Pade liquid table (16 bands over 1-50,000 cm-1, seed 0)
      and the physical ice table of :func:`ice_pade_table`, drawn into one
      stochastic subcolumn per column.
    """
    lw_gas, sw_gas, solar, batch, B, nlayers = rfmip_like(smoke,
                                                          device=device)
    rng = np.random.default_rng(4242)
    s = (np.arange(nlayers) + 0.5) / nlayers
    scale = rng.uniform(0.5, 1.5, (B, 1))
    p_lev = batch["p_lev"]
    p_lay = 0.5 * (p_lev[:, :-1] + p_lev[:, 1:])
    t_lev = batch["t_lev"]
    t_lay = 0.5 * (t_lev[:, :-1] + t_lev[:, 1:])
    thickness = (np.abs(np.log(p_lev[:, :-1]) - np.log(p_lev[:, 1:]))
                 * t_lay * GAS_CONSTANT) / (MOLAR_MASS_KG * GRAVITY)
    liquid = (p_lay >= 700.0) & (p_lay <= 900.0)
    cirrus = (p_lay >= 200.0) & (p_lay <= 350.0)
    mu = batch["mu"].copy()
    mu[1::2] = -rng.uniform(0.0, 0.9, mu[1::2].shape)
    atm = dataclasses.replace(
        atmosphere(batch), cos_zenith=mu, clean=False, clear=False,
        aerosol_optical_depth_1um=scale * 0.28 * np.exp(
            -0.5 * ((s - 0.85) / 0.13) ** 2),
        aerosol_angstrom_exponent=1.48,
        aerosol_single_scatter_albedo=np.broadcast_to(
            0.88 + 0.06 * np.sin(3.0 * s), (B, nlayers)).copy(),
        aerosol_asymmetry_factor=np.broadcast_to(
            0.55 + 0.15 * s, (B, nlayers)).copy(),
        cloud_fraction=np.where(liquid | cirrus,
                                rng.uniform(0.3, 1.0, (B, nlayers)), 0.0),
        liquid_water_content=np.where(
            liquid, rng.uniform(0.0, 0.3, (B, nlayers)), 0.0),
        ice_water_content=np.where(
            cirrus, rng.uniform(0.0, 0.02, (B, nlayers)), 0.0),
        layer_thickness=thickness)
    clouds = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0,
                                    device=device),
        ice=ice_pade_table(device=device))
    driver = RadiationDriver(lw_gas, sw_gas, solar,
                             cloud_optics=clouds.driver_callback(),
                             num_subcolumns=1)
    return driver, atm


def _fixed_cloud_optics(inputs, lw_grid, sw_grid, device):
    """The golden's cloud callback: the fixed (ql, qi) profile of
    ``driver_inputs.clouds()`` in place of a stochastic sample, through the
    Pade tables and ``band_to_grid``, with the reference's gap at each
    interior band boundary replayed (tests/test_driver_golden.py's
    ``ref_gap_keep``)."""
    pade, cld = inputs["pade"], inputs["clouds"]

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def table(tb):
        return PadeCloudOptics.from_arrays(
            tb["band_lims"], tb["sizereg"], tb["sizeref"], tb["ext_p"],
            tb["ext_q"], tb["ssa_p"], tb["ssa_q"], tb["asy_p"], tb["asy_q"],
            device=device)

    liq_tb, ice_tb = table(pade["liquid"]), table(pade["ice"])
    t_lay = f32(0.5 * (inputs["t"][:-1] + inputs["t"][1:]))
    thick = f32(cld["thickness"])
    rice = ice_particle_size(t_lay) / 2.0
    rliq = torch.full_like(rice, 10.0)
    liq = liq_tb.evaluate(f32(cld["ql"]), rliq)
    ice = ice_tb.evaluate(f32(cld["qi"]), rice)

    def ref_gap_keep(tb, grid):
        """(nw,) 0/1: the one grid point whose pseudo-band left edge is
        the last below each interior band boundary gets no cloud optics in
        the reference (its upper_bound returns the last index <= target)."""
        centers = grid.w0 + np.arange(grid.n) * grid.dw
        ledge = np.empty(grid.n)
        ledge[1:] = centers[1:] - 0.5 * grid.dw
        ledge[0] = max(centers[0] - grid.dw, 0.0)
        keep = np.ones(grid.n, np.float32)
        for e in np.asarray(tb["band_lims"][0][1:], np.float64):
            j = int(np.searchsorted(ledge, e, side="right")) - 1
            if 0 <= j < grid.n and ledge[j] < e:
                keep[j] = 0.0
        return f32(keep)

    gaps = {(ph, band): ref_gap_keep(pade[ph], g) for ph in ("liquid", "ice")
            for band, g in (("lw", lw_grid), ("sw", sw_grid))}

    def optics(vals, tb, w, keep):
        e, s, g = (band_to_grid(v, tb.band_lims, w) * keep for v in vals)
        return Optics(tau=(e * thick[:, None])[None], omega=s[None],
                      g=g[None])

    def callback(cloud_args, key, w_lw, w_sw):
        out = [optics(liq, liq_tb, w_lw, gaps[("liquid", "lw")]),
               optics(ice, ice_tb, w_lw, gaps[("ice", "lw")])]
        if w_sw is None:
            return out[0], out[1], None, None
        return (out[0], out[1],
                optics(liq, liq_tb, w_sw, gaps[("liquid", "sw")]),
                optics(ice, ice_tb, w_sw, gaps[("ice", "sw")]))

    return callback


def golden_case(directory: str, inputs: dict, lw_grid: SpectralGrid,
                sw_grid: SpectralGrid, *, device, sky: str = "clear"):
    """(RadiationDriver, Atmosphere) of the driver golden's case.

    ``directory`` holds the files ``driver_inputs.write_inputs`` wrote
    (HITRAN .par, MT-CKD and O3 continua, CFC-11/12 and N2-N2 / O2-N2 CIA
    cross sections, solar spectrum) and ``inputs`` is the atmosphere it
    returned.  ``sky="clear"`` is the clean, clear case (the CSAF rows);
    ``sky="all"`` also needs ``inputs["aerosol"]``, ``inputs["clouds"]``
    and ``inputs["pade"]`` (``driver_inputs.aerosol()``, ``clouds()`` and
    ``pade_tables()``) and adds the aerosols and the fixed-condensate
    clouds, so all three tiers (every row of the golden) are computed.
    """
    if sky not in ("clear", "all"):
        raise ValueError(f"sky={sky!r}: 'clear' or 'all'")
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
    if sky == "all":
        aero, cld = a["aerosol"], a["clouds"]
        driver.cloud_optics = _fixed_cloud_optics(a, lw_grid, sw_grid,
                                                  device)
        atm = dataclasses.replace(
            atm, clean=False, clear=False,
            aerosol_optical_depth_1um=aero["tau1um"][None],
            aerosol_angstrom_exponent=aero["alpha"],
            aerosol_single_scatter_albedo=aero["omega"][None],
            aerosol_asymmetry_factor=aero["g"][None],
            cloud_fraction=((cld["ql"] + cld["qi"]) > 0)
            .astype(np.float64)[None],
            liquid_water_content=cld["ql"][None],
            ice_water_content=cld["qi"][None],
            layer_thickness=cld["thickness"][None])
    return driver, atm


def write_rfmip_input(path: str, nsite: int = 100, nexpt: int = 18,
                      nlayer: int = 60, seed: int = 5):
    """A synthetic RFMIP-IRF input file at the real file's size (100 sites,
    18 experiments, 61 levels / 60 layers): the variables, float64 types,
    string ``units`` and value recipe of tests/test_rfmip.py's input, drawn
    in its order (at its 5 sites, 3 experiments and 10 layers the values
    are its own), written by the port's HDF5 writer."""
    from .utils.hdf5 import FileWriter

    rng = np.random.default_rng(seed)
    nlevel = nlayer + 1
    with FileWriter(path) as f:
        f.create_dataset("site", np.arange(nsite, dtype=np.float64))
        f.create_dataset("level", np.arange(nlevel, dtype=np.float64))
        p_lev = np.linspace(1.0, 101325.0, nlevel)[None, :] * \
            rng.uniform(0.95, 1.05, (nsite, 1))          # [Pa]
        f.create_dataset("pres_level", p_lev)
        f.create_dataset("pres_layer", 0.5 * (p_lev[:, :-1] + p_lev[:, 1:]))
        t_lev = np.linspace(210.0, 290.0, nlevel)[None, None, :] + \
            rng.uniform(-3, 3, (nexpt, nsite, nlevel))
        f.create_dataset("temp_level", t_lev)
        f.create_dataset("temp_layer", 0.5 * (t_lev[..., :-1]
                                              + t_lev[..., 1:]))
        f.create_dataset("surface_temperature", t_lev[..., -1] + 1.0)
        f.create_dataset("solar_zenith_angle",
                         np.resize([30.0, 60.0, 85.0, 95.0, 45.0], nsite))
        f.create_dataset("total_solar_irradiance", np.full(nsite, 1361.0))
        f.create_dataset("surface_albedo", rng.uniform(0.05, 0.3, nsite))
        f.create_dataset("surface_emissivity", rng.uniform(0.95, 1.0, nsite))
        f.create_dataset("water_vapor",
                         rng.uniform(1e-6, 1e-2, (nexpt, nsite, nlayer)))
        f.create_dataset("ozone",
                         rng.uniform(1e-8, 1e-5, (nexpt, nsite, nlayer)))
        for name, value, units in (
                ("carbon_dioxide_GM", 397.55, "1e-06"),
                ("methane_GM", 1831.47, "1e-09"),
                ("nitrous_oxide_GM", 326.99, "1e-09"),
                ("carbon_monoxide_GM", 0.12, "1e-06"),
                ("oxygen_GM", 0.2095, "1"), ("nitrogen_GM", 0.781, "1"),
                ("cfc11_GM", 233.05, "1e-12"),
                ("cfc11eq_GM", 653.46, "1e-12"),
                ("cfc12_GM", 520.58, "1e-12"),
                ("hfc134aeq_GM", 300.0, "1e-12"),
                ("sf6_GM", 8.16, "1e-12")):
            f.create_dataset(name, np.full(nexpt, value)).attrs["units"] = \
                units


def write_era5_inputs(era5_path: str, ghg_path: str, ntime: int = 1,
                      nlevel: int = 37, nlat: int = 8, nlon: int = 16,
                      seed: int = 9):
    """A synthetic preprocessed ERA5 snapshot (the variables of
    tests/test_era5.py's file: time, lat, lon, p, t, q, o3, skt, fal,
    tisr, cc, ciwc, clwc) and a 5-year GHG file, written by the port's
    HDF5 writer.  Pressure levels 1-1,000 mb; humidity falling off with
    height; the eastern half of the longitudes at night (tisr 0); liquid
    cloud below 500 mb and ice between 150 and 500 mb, at a tenth of
    tests/test_era5.py's mixing ratios, so the layers' cloud optical
    depths stay below ~10."""
    from .utils.hdf5 import FileWriter

    rng = np.random.default_rng(seed)
    shape = (ntime, nlevel, nlat, nlon)
    p = np.linspace(1.0, 1000.0, nlevel)[None, :, None, None] * \
        np.ones((ntime, 1, nlat, nlon))                        # [mb]
    lon = np.arange(nlon) * (360.0 / nlon)
    day = (lon < 180.0)[None, None, :]
    with FileWriter(era5_path) as f:
        f.create_dataset("time", np.arange(ntime, dtype=np.float64))
        f.create_dataset("lat", np.linspace(-80.0, 80.0, nlat))
        f.create_dataset("lon", lon)
        f.create_dataset("p", p)
        f.create_dataset("t", np.linspace(220, 290, nlevel)[None, :, None,
                                                            None]
                         + rng.uniform(-3, 3, shape))
        # Specific humidity falling off as p^4 from ~1e-2 at the surface,
        # floored at a stratospheric 3e-6 (tests/test_era5.py draws
        # uniform(1e-6, 1e-2) at every level, which the full line list
        # makes opaque far above the clouds).
        f.create_dataset("q", np.maximum(
            3e-6, 1e-2 * (p / 1000.0) ** 4 * rng.uniform(0.5, 1.5, shape)))
        f.create_dataset("o3", rng.uniform(1e-8, 1e-5, shape))
        f.create_dataset("skt", rng.uniform(280, 300, (ntime, nlat, nlon)))
        f.create_dataset("fal", rng.uniform(0.05, 0.5, (ntime, nlat, nlon)))
        f.create_dataset("tisr", rng.uniform(0.2e7, 1.6e7,
                                             (ntime, nlat, nlon)) * day)
        f.create_dataset("cc", rng.uniform(-0.1, 0.9, shape))
        f.create_dataset("ciwc", rng.uniform(-1e-7, 1e-5, shape)
                         * ((p > 150.0) & (p < 500.0)))
        f.create_dataset("clwc", rng.uniform(-1e-7, 5e-5, shape)
                         * (p >= 500.0))
    years = np.arange(5)
    with FileWriter(ghg_path) as f:
        f.create_dataset("co2", 300.0 + years)
        f.create_dataset("ch4", 1.7 + 0.01 * years)
        f.create_dataset("n2o", 0.3 + 0.001 * years)
        f.create_dataset("hfc134aeq", 1e-4 * (1 + years))
        f.create_dataset("cfc12eq", 5e-4 * (1 + years))
