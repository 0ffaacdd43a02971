"""ERA5 global reanalysis application (port of grtcode_tpu/apps/era5.py;
era5/src/era5.c).

Reads preprocessed ERA5 netCDF snapshots (time, level, lat, lon), an
annual-mean GHG file, and builds a batched Atmosphere over the
(time, lat, lon) hyperslab; writes 4-D flux output with lon_start/
lon_stop/lon_global_size attributes for segment merging
(era5.c:156-159).

Reference quirks:
  * the tisr-derived cos(zenith) is commented out and hardcoded to -1
    (era5.c:406-415), making the shipped binary longwave-only; here the
    derivation is implemented and selectable via ``derive_zenith=True``
    (default False = reference behavior);
  * specific humidity q and o3 mass mixing ratios convert to vmr with the
    dry-air/molar-mass ratio (era5.c:292-300, no humidity correction);
  * hydrostatic layer thickness dz = |dln p| T R / (M g) (era5.c:540-548);
  * GHG/CFC-eq annual means are scalar per year index (era5.c:568-640).

    python -m grtcode_tpu_torch.apps.era5 lines.par solar.csv era5.nc \\
        ghg.nc -year 1 -clear -integrated -o fluxes.nc [-d N]

The netCDF inputs (the ERA5 snapshot, the GHG file, the Pade cloud
tables) and the output go through the port's own HDF5 IO
(``utils.ncio``).
"""
from __future__ import annotations

import numpy as np

from ..framework.atmosphere import Atmosphere
from ..gas_optics.molecules import CfcId, CiaId, MoleculeId
from ..utils.ncio import Dataset, Writer

SECONDS_PER_DAY = 86400.0
DRY_AIR_MASS = 28.97       # era5.c:293
H2O_MASS = 18.01528
O3_MASS = 48.0
GAS_CONSTANT = 8.314462    # [J mol-1 K-1]
MOLAR_MASS_KG = 28.9647e-3
GRAVITY = 9.81
PA_PER_MB = 100.0

GHG_VARS = {MoleculeId.CO2: "co2", MoleculeId.CH4: "ch4",
            MoleculeId.N2O: "n2o"}
CFC_EQ_VARS = {CfcId.HFC134a: "hfc134aeq", CfcId.CFC12: "cfc12eq"}
CIA_PAIRS = {"N2-N2": (CiaId.N2, CiaId.N2), "O2-N2": (CiaId.O2, CiaId.N2),
             "O2-O2": (CiaId.O2, CiaId.O2)}
# Well-mixed vmr used for CIA when the file carries no N2/O2 fields
# (era5.c:660-700 reads them from the GHG file when present).
CIA_DEFAULT_VMR = {CiaId.N2: 0.781, CiaId.O2: 0.2095}


def build_driver(lw_grid=None, sw_grid=None, hitran_path: str | None = None,
                 molecules=(MoleculeId.H2O, MoleculeId.O3, MoleculeId.CO2,
                            MoleculeId.CH4, MoleculeId.N2O), *, device,
                 **gas_kwargs):
    """ERA5 driver on ``device``: LW 1-3250 @0.1 by default; SW only
    when a grid is given (the shipped reference binary is LW-only,
    era5.c:406-415; pass sw_grid + use derive_zenith=True to enable the SW
    pass)."""
    from ..gas_optics.gas_optics import GasOptics
    from ..framework.driver import RadiationDriver
    from ..solvers.solar_flux import SolarFlux
    from ..spectral import SpectralGrid

    lw_grid = lw_grid or SpectralGrid(1.0, 3250.0, 0.1)
    lw_gas = GasOptics(lw_grid, hitran_path=hitran_path, device=device,
                       **gas_kwargs)
    sw_gas = solar = None
    if sw_grid is not None:
        sw_gas = GasOptics(sw_grid, hitran_path=hitran_path, device=device,
                           **gas_kwargs)
        # Flat normalized spectrum unless an app supplies a measured one.
        solar = SolarFlux.from_samples(
            np.asarray([sw_grid.w0, sw_grid.last]), np.asarray([1.0, 1.0]),
            sw_grid, device)
    if hitran_path:
        for m in molecules:
            lw_gas.add_molecule(m)
            if sw_gas is not None:
                sw_gas.add_molecule(m)
    return RadiationDriver(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar)


def _tzyx_to_byz(a):
    """(T, Z, Y, X) -> (T*Y*X, Z) column-major batch (tzyx_to_tyxz,
    era5.c:70-93)."""
    t, z, y, x = a.shape
    return np.transpose(a, (0, 2, 3, 1)).reshape(t * y * x, z)


def load_atmosphere(era5_path: str, ghg_path: str, year: int,
                    t=slice(None), y=slice(None), x=slice(None),
                    z=slice(None), ghg_start_year: int = 1,
                    molecules=(MoleculeId.H2O, MoleculeId.O3),
                    ghg=(MoleculeId.CO2, MoleculeId.CH4, MoleculeId.N2O),
                    cfc_eq=(), cia_pairs=(), clear: bool = True,
                    derive_zenith: bool = False) -> Atmosphere:
    with Dataset(era5_path) as nc:
        p = nc.var("p", (t, z, y, x))           # [mb] (T, Z, Y, X)
        temp = nc.var("t", (t, z, y, x))
        level_p = _tzyx_to_byz(p)
        level_t = _tzyx_to_byz(temp)
        layer_p = 0.5 * (level_p[:, :-1] + level_p[:, 1:])
        # Pressure-interpolated layer temperature (era5.c:271-289).
        layer_t = level_t[:, :-1] + (level_t[:, 1:] - level_t[:, :-1]) * (
            (layer_p - level_p[:, :-1])
            / (level_p[:, 1:] - level_p[:, :-1]))

        t_surf = nc.var("skt", (t, y, x)).reshape(-1)
        albedo = nc.var("fal", (t, y, x)).reshape(-1)

        ppmv = {}
        if MoleculeId.H2O in molecules:
            q = _tzyx_to_byz(nc.var("q", (t, z, y, x)))
            ppmv[int(MoleculeId.H2O)] = q * 1e6 * (DRY_AIR_MASS / H2O_MASS)
        if MoleculeId.O3 in molecules:
            o3 = _tzyx_to_byz(nc.var("o3", (t, z, y, x)))
            ppmv[int(MoleculeId.O3)] = o3 * 1e6 * (DRY_AIR_MASS / O3_MASS)

        B, nlev = level_p.shape

        # Solar zenith angle from tisr (era5.c:350-415; the reference
        # comments the derivation out and hardcodes -1 -> LW only).
        if derive_zenith:
            # mu = tisr / planetary-mean irradiance, where the mean is a
            # cos(lat)-weighted average of the GLOBAL field (era5.c:352-400
            # reads weights and irradiance with start=0 over every lat/lon,
            # not the selected hyperslab) times 4 (sphere/disc ratio).
            # One read of the (largest) tisr variable serves both the
            # global mean and the hyperslab.
            lat_g = nc.var("lat")
            w_g = np.cos(np.deg2rad(lat_g))
            tisr_g = nc.var("tisr", (t, slice(None), slice(None))) \
                / SECONDS_PER_DAY
            tisr = tisr_g[:, y][:, :, x]             # selected slab
            zonal = tisr_g.mean(axis=2)              # (T, nlat_global)
            mean_irr = 4.0 * (zonal * w_g).sum(axis=1) / w_g.sum()
            mu = (tisr / mean_irr[:, None, None]).reshape(-1)
            # era5.c:429: tsi = tisr / (86400 * mu); night columns (the
            # reference leaves them negative, unused) are zeroed here.
            tsi = np.where(mu > 0, tisr.reshape(-1) / np.maximum(mu, 1e-6),
                           0.0)
        else:
            mu = np.full(B, -1.0)
            tsi = np.zeros(B)

        cloud = {}
        if not clear:
            air_density = (layer_p * PA_PER_MB * MOLAR_MASS_KG) / \
                (layer_t * GAS_CONSTANT)            # [kg m-3]
            # The reference reads the first num_layers entries of the level
            # axis and clamps negatives to zero (era5.c:477-525).
            cc = np.maximum(_tzyx_to_byz(nc.var("cc", (t, z, y, x)))[:, :-1],
                            0.0)
            ciwc = np.maximum(
                _tzyx_to_byz(nc.var("ciwc", (t, z, y, x)))[:, :-1], 0.0)
            clwc = np.maximum(
                _tzyx_to_byz(nc.var("clwc", (t, z, y, x)))[:, :-1], 0.0)
            thickness = (np.abs(np.log(level_p[:, :-1])
                                - np.log(level_p[:, 1:]))
                         * layer_t * GAS_CONSTANT) / (MOLAR_MASS_KG * GRAVITY)
            cloud = {
                "cloud_fraction": cc,
                # kg/kg * kg/m3 * 1000 -> g/m3
                "liquid_water_content": clwc * air_density * 1000.0,
                "ice_water_content": ciwc * air_density * 1000.0,
                "layer_thickness": thickness,
            }

    ppmv_ghg, cfc_ppmv, cia_ppmv = {}, {}, {}
    with Dataset(ghg_path) as gf:
        yi = year - ghg_start_year
        for mol in ghg:
            val = float(gf.var(GHG_VARS[MoleculeId(mol)], (yi,)))
            ppmv_ghg[int(mol)] = np.full((B, nlev), val)
        for cfc in cfc_eq:
            val = float(gf.var(CFC_EQ_VARS[CfcId(cfc)], (yi,)))
            cfc_ppmv[int(cfc)] = np.full((B, nlev), val)
    for pair in cia_pairs:
        for species in CIA_PAIRS[pair]:
            cia_ppmv.setdefault(
                int(species),
                np.full((B, nlev), CIA_DEFAULT_VMR[species] * 1e6))
    ppmv.update(ppmv_ghg)

    spec = np.array([1.0, 2.0])
    return Atmosphere(
        level_pressure=level_p, level_temperature=level_t,
        layer_temperature=layer_t, surface_temperature=t_surf,
        ppmv=ppmv, cfc_ppmv=cfc_ppmv, cia_ppmv=cia_ppmv,
        emissivity_grid=spec, emissivity=np.ones((B, 2)),  # era5.c:556-566
        cos_zenith=mu, total_solar_irradiance=tsi,
        albedo_grid=spec, albedo=np.repeat(albedo[:, None], 2, axis=1),
        clean=True, clear=clear, **cloud,
    )


# The reference flux file's variable surface (era5.c:865-955):
# (name, standard_name, tier, flux key, level selector).  "sfc"/"toa"
# pick the boundary level, "user" the -l user level.  Every variable is
# DEFINED in every file; data lands only for tiers/bands the run computed
# (write_output fills computed ids, the rest stay netCDF fill values).
_FLUX_VARS = (
    ("rldsaf", "downwelling_surface_aerosol_free_longwave_flux_in_air",
     "af", "rld", "sfc"),
    ("rlusaf", "upwelling_surface_aerosol_free_longwave_flux_in_air",
     "af", "rlu", "sfc"),
    ("rlutaf", "upwelling_toa_aerosol_free_longwave_flux_in_air",
     "af", "rlu", "toa"),
    ("rldscsaf",
     "downwelling_surface_clear_sky_aerosol_free_longwave_flux_in_air",
     "csaf", "rld", "sfc"),
    ("rluscsaf",
     "upwelling_surface_clear_sky_aerosol_free_longwave_flux_in_air",
     "csaf", "rlu", "sfc"),
    ("rlutcsaf",
     "upwelling_toa_clear_sky_aerosol_free_longwave_flux_in_air",
     "csaf", "rlu", "toa"),
    ("rluaf_level", "upwelling_aerosol_free_longwave_flux_in_air",
     "af", "rlu", "user"),
    ("rldaf_level", "downwelling_aerosol_free_longwave_flux_in_air",
     "af", "rld", "user"),
    ("rlucsaf_level",
     "upwelling_clear_sky_aerosol_free_longwave_flux_in_air",
     "csaf", "rlu", "user"),
    ("rldcsaf_level",
     "downwelling_clear_sky_aerosol_free_longwave_flux_in_air",
     "csaf", "rld", "user"),
    ("rsdsaf", "downwelling_surface_aerosol_free_shortwave_flux_in_air",
     "af", "rsd", "sfc"),
    ("rsusaf", "upwelling_surface_aerosol_free_shortwave_flux_in_air",
     "af", "rsu", "sfc"),
    ("rsdtaf", "downwelling_toa_aerosol_free_shortwave_flux_in_air",
     "af", "rsd", "toa"),
    ("rsutaf", "upwelling_toa_aerosol_free_shortwave_flux_in_air",
     "af", "rsu", "toa"),
    ("rsdscsaf",
     "downwelling_surface_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsd", "sfc"),
    ("rsuscsaf",
     "upwelling_surface_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsu", "sfc"),
    ("rsdtcsaf",
     "downwelling_toa_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsd", "toa"),
    ("rsutcsaf",
     "upwelling_toa_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsu", "toa"),
    ("rsuaf_level", "upwelling_aerosol_free_shortwave_flux_in_air",
     "af", "rsu", "user"),
    ("rsdaf_level", "downwelling_aerosol_free_shortwave_flux_in_air",
     "af", "rsd", "user"),
    ("rsucsaf_level",
     "upwelling_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsu", "user"),
    ("rsdcsaf_level",
     "downwelling_clear_sky_aerosol_free_shortwave_flux_in_air",
     "csaf", "rsd", "user"),
)

# State variables written per column (driver.c:716-738): name,
# standard_name, units, Atmosphere attribute / ppmv molecule.
_STATE_VARS = (
    ("p", "air_pressure", "mb", "level_pressure"),
    ("t", "air_temperature", "K", "level_temperature"),
    ("h2o_vmr", "water_vapor_vmr", "ppmv", MoleculeId.H2O),
    ("o3_vmr", "ozone_vmr", "ppmv", MoleculeId.O3),
    ("ch4_vmr", "methane_vmr", "ppmv", MoleculeId.CH4),
    ("co2_vmr", "carbon_dioxide_vmr", "ppmv", MoleculeId.CO2),
    ("n2o_vmr", "nitrous_oxide_vmr", "ppmv", MoleculeId.N2O),
)

_DEFAULT_SW_GRID = (1.0, 50000.0, 1.0)   # driver.c:918-921 default band


def write_fluxes(path: str, results, shape_tyx: tuple, lon_start: int,
                 lon_stop: int, lon_global_size: int, lw_grid=None,
                 sw_grid=None, atm=None, user_level: int = -1):
    """Write the reference-shaped ERA5 flux file (era5.c:760-1060).

    Defines the full reference variable surface — both AF and CSAF tier
    fluxes at surface/TOA/user level for both bands, plus the atmospheric
    state (p, t, vmr profiles, ts, t_layer) — with the
    lon_start/lon_stop/lon_global_size merge attributes (era5.c:156-159).
    Data is written for whatever the run computed: tiers present in
    ``results.tiers``, SW only when ``sw_grid`` is given (the shipped
    reference binary is LW-only, so its SW variables stay fill values —
    same here), user-level variables only when ``user_level >= 0``.
    Integrated results are 3-D (time, lat, lon); spectral results add the
    lw_wavenumber/sw_wavenumber dim (era5.c:842-846 num_dimensions).
    ``atm`` supplies the state profiles; omit to define them unwritten.
    """
    from ..spectral import SpectralGrid

    T, Y, X = shape_tyx
    tiers = results.host()
    any_tier = next(iter(tiers.values()))
    nlev = any_tier["rlu"].shape[1]
    nlay = nlev - 1
    integrated = results.integrated
    if lw_grid is None:
        raise ValueError("write_fluxes needs lw_grid")
    sw_def = sw_grid or SpectralGrid(*_DEFAULT_SW_GRID)

    def grid4(data):
        """(B, ...) -> (time, lat, lon, ...)."""
        d = np.asarray(data)
        return d.reshape(T, Y, X, *d.shape[1:])

    def profile4(data):
        """(B, nz) -> (time, z, lat, lon) (write_output's start/count
        layout for LEVEL_*/LAYER_* ids, era5.c:993-1003)."""
        d = np.asarray(data)
        return d.reshape(T, Y, X, d.shape[1]).transpose(0, 3, 1, 2)

    with Writer(path) as w:
        w.create_dimension("time", T)
        w.create_dimension("lat", Y)
        w.create_dimension("lon", X)
        w.create_dimension("level", nlev)
        w.create_dimension("layer", nlay)
        w.create_dimension("lw_wavenumber", lw_grid.n,
                           values=lw_grid.wavenumbers_np())
        w.create_dimension("sw_wavenumber", sw_def.n,
                           values=sw_def.wavenumbers_np())

        for name, std, units, src in _STATE_VARS:
            dims = ("time", "level", "lat", "lon")
            data = None
            if atm is not None:
                if isinstance(src, str):
                    data = profile4(getattr(atm, src))
                elif int(src) in atm.ppmv:
                    data = profile4(atm.ppmv[int(src)])
            w.create_variable(name, dims, data, units=units,
                              standard_name=std)
        w.create_variable(
            "ts", ("time", "lat", "lon"),
            None if atm is None else grid4(atm.surface_temperature),
            units="K", standard_name="surface_temperature")
        # NOTE: "mb" matches the reference's (mislabeled) t_layer units
        # attribute, era5.c:880.
        w.create_variable(
            "t_layer", ("time", "layer", "lat", "lon"),
            None if atm is None else profile4(atm.layer_temperature),
            units="mb", standard_name="air_layer_temperature")

        for name, std, tier, key, lev in _FLUX_VARS:
            shortwave = key[1] == "s"
            wdim = "sw_wavenumber" if shortwave else "lw_wavenumber"
            dims = (("time", "lat", "lon") if integrated
                    else ("time", "lat", "lon", wdim))
            data = None
            have = (tier in tiers
                    and (sw_grid is not None or not shortwave)
                    and (user_level >= 0 or lev != "user"))
            if have:
                idx = {"toa": 0, "sfc": nlev - 1, "user": user_level}[lev]
                data = grid4(tiers[tier][key][:, idx])
            attrs = {"level": user_level} if lev == "user" else {}
            w.create_variable(name, dims, data, units="W m-2",
                              standard_name=std, **attrs)
        w.set_global(lon_start=lon_start, lon_stop=lon_stop,
                     lon_global_size=lon_global_size)


def main(argv=None, *, device=None):
    """ERA5 runner (era5.c:97-128 flag surface) on ``cuda:N`` (``-d N``)
    or the caller's ``device``."""
    from ..framework import cli

    p = cli.shared_parser("ERA5 global reanalysis radiative fluxes.")
    p.add_argument("input_file", help="Preprocessed ERA5 netCDF.")
    p.add_argument("ghg_file", help="Annual-mean GHG netCDF.")
    p.add_argument("-year", type=int, required=True)
    p.add_argument("-ghg_start_year", type=int, default=1)
    p.add_argument("-x", type=int, default=0)
    p.add_argument("-X", type=int, default=None)
    p.add_argument("-y", type=int, default=0)
    p.add_argument("-Y", type=int, default=None)
    p.add_argument("-t", type=int, default=0)
    p.add_argument("-T", type=int, default=None)
    p.add_argument("-clear", action="store_true")
    p.add_argument("-sw", action="store_true",
                   help="Enable the SW pass with the tisr-derived zenith "
                        "angle (the reference hardcodes LW-only).")
    cli.add_gas_flags(p, ["H2O", "O3", "CO2", "CH4", "N2O"],
                      cfcs=["HFC-134a-eq", "CFC-12-eq"],
                      cias=list(CIA_PAIRS))
    args = p.parse_args(argv)
    cli.configure(args)
    mesh = cli.mesh_from_args(args, device)
    dev = cli.device_from_args(args, device, mesh)

    xs = slice(args.x, None if args.X is None else args.X + 1)
    ys = slice(args.y, None if args.Y is None else args.Y + 1)
    ts = slice(args.t, None if args.T is None else args.T + 1)
    mols = tuple(m for m in (MoleculeId.H2O, MoleculeId.O3)
                 if getattr(args, m.name, False)) or \
        (MoleculeId.H2O, MoleculeId.O3)
    ghg = tuple(m for m in GHG_VARS if getattr(args, m.name, False)) or \
        tuple(GHG_VARS)
    cfc = tuple(c for c in CFC_EQ_VARS
                if getattr(args, CFC_EQ_VARS[c].replace("eq", "_eq").
                           replace("-", "_"), False))
    atm = load_atmosphere(args.input_file, args.ghg_file, args.year,
                          t=ts, y=ys, x=xs,
                          ghg_start_year=args.ghg_start_year,
                          molecules=mols, ghg=ghg, cfc_eq=cfc,
                          clear=args.clear, derive_zenith=args.sw)
    lw_grid, sw_grid = cli.grids_from_args(args)
    hitran = None if args.hitran_file in ("none", "-") else args.hitran_file
    driver = build_driver(lw_grid=lw_grid,
                          sw_grid=sw_grid if args.sw else None,
                          hitran_path=hitran, wcutoff=args.line_cutoff,
                          device=dev)
    if hitran:
        # Continua + -eq cross-section / CIA CSVs on every active band
        # (driver.c:193-210, 616-625).
        cli.register_cross_sections(
            driver, args, cfc_options=("HFC-134a-eq", "CFC-12-eq"),
            cia_pairs=CIA_PAIRS)
    if not args.clear:
        # All-sky tier: Pade band optics from the -liquid-path/-ice-path
        # files (run-era5.sh:116-145 runs ERA5 with clouds on via
        # initialize_clouds_lib).
        if not (args.liquid_path and args.ice_path):
            raise SystemExit("cloudy ERA5 run needs -liquid-path and "
                             "-ice-path (or pass -clear)")
        from ..clouds import CloudOpticsLib, PadeCloudOptics
        driver.cloud_optics = CloudOpticsLib(
            liquid=PadeCloudOptics.from_netcdf(args.liquid_path, dev),
            ice=PadeCloudOptics.from_netcdf(args.ice_path, dev)
        ).driver_callback()
    res = driver.run(atm, integrated=args.integrated, mesh=mesh,
                     spectral_chunks=args.spectral_chunks)
    if not cli.writes_output(mesh):
        return
    with Dataset(args.input_file) as nc:
        nlon = nc.dim_size("lon")
        nlat = nc.dim_size("lat")
        ntime = nc.dim_size("time")
    T_ = len(range(*ts.indices(ntime)))
    Y_ = len(range(*ys.indices(nlat)))
    X_ = len(range(*xs.indices(nlon)))
    write_fluxes(args.output, res, (T_, Y_, X_), lon_start=args.x,
                 lon_stop=args.x + X_ - 1, lon_global_size=nlon,
                 lw_grid=lw_grid, sw_grid=sw_grid if args.sw else None,
                 atm=atm,
                 user_level=(-1 if args.flux_at_level is None
                             else args.flux_at_level))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
