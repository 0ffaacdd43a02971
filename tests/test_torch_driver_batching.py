"""How the port's driver splits a batch, with all three sky tiers on.

On a small two-band model (LW 100-400 cm-1 at 0.1, SW 1,000-9,000 cm-1 at
4.0, six columns of eight layers, three of them at night, aerosols and
stochastic clouds):

* ``column_chunk`` equals the unchunked run, cloud realizations included
  (each chunk carries its columns' global ids), rtol 2e-6 / atol 1e-6 as
  tests/test_framework.py holds the JAX driver;
* day compaction (lit columns LW + SW, night columns LW only) equals
  per-column runs, rtol 2e-5 / atol 1e-4 (tests/test_framework.py);
* ``integrated=False`` gives JAX's spectra on the mixed batch, night SW
  zeros of the SW band's width;
* ``spectral_chunks=3`` equals the unstreamed run in every tier, for
  line_sample and wavenumber_sweep (rtol 2e-5 / atol 1e-4);
* ``Atmosphere.subset`` and ``pressure_interp_layers_to_levels`` are
  JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu.clouds.lib import CloudOpticsLib as JCloudOpticsLib
from grtcode_tpu.clouds.pade import synthetic_pade_table as jpade
from grtcode_tpu.framework import atmosphere as jatmosphere
from grtcode_tpu.framework.driver import RadiationDriver as JDriver
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.solvers.solar_flux import SolarFlux as JSolarFlux
from grtcode_tpu.spectral import SpectralGrid as JGrid
from grtcode_tpu_torch.clouds.lib import CloudOpticsLib
from grtcode_tpu_torch.clouds.pade import synthetic_pade_table
from grtcode_tpu_torch.convert import (atmosphere_from_jax, driver_from_jax,
                                       gas_optics_from_jax)
from grtcode_tpu_torch.framework import atmosphere
from grtcode_tpu_torch.framework.driver import RadiationDriver
from tests.test_torch_driver_tiers import (FLUXES, TOLERANCE,
                                           exact_betainc, worst_rel)

CHUNK_RTOL, CHUNK_ATOL = 2e-6, 1e-6
RTOL, ATOL = 2e-5, 1e-4
SW_SPECTRUM_TOL = 5e-3
MU = np.array([0.6, -1.0, 0.3, -0.5, 0.9, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _jax_gas(grid, method, mols):
    g = JGasOptics(grid, line_chunk=64, method=method, pallas="off")
    for mol, seed in mols:
        rng = np.random.default_rng(seed)
        n = 150
        vnn = np.sort(rng.uniform(grid.w0 - 15.0, grid.wn + 15.0, n))
        g.add_catalog(jcatalog(
            mol, vnn, 10.0 ** rng.uniform(-22.0, -19.0, n),
            yair=rng.uniform(0.02, 0.1, n), yself=rng.uniform(0.05, 0.4, n),
            en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
            d=rng.uniform(-0.01, 0.01, n)))
    return g


def _jax_model(lw_method="line_sample", sw_band=(1000.0, 9000.0, 4.0)):
    """(JAX driver with the JAX cloud optics, JAX Atmosphere); the SW grid
    is ``sw_band`` (first, last, step) [cm-1]."""
    lw_grid, sw_grid = JGrid(100.0, 400.0, 0.1), JGrid(*sw_band)
    jlw = _jax_gas(lw_grid, lw_method, ((1, 21), (2, 22)))
    jsw = _jax_gas(sw_grid, "line_sample", ((1, 23),))
    jsol = JSolarFlux.from_samples(
        np.linspace(900.0, 9100.0, 64),
        1.0 + 0.5 * np.sin(np.linspace(0.0, 3.0, 64)), sw_grid)
    rng = np.random.default_rng(9)
    B, nlev = MU.size, 9
    nlay = nlev - 1
    p = np.linspace(0.05, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + rng.uniform(-4, 4,
                                                               (B, nlev))
    cf = np.zeros((B, nlay))
    cf[:, 2:6] = rng.uniform(0.3, 1.0, (B, 4))
    jatm = jatmosphere.Atmosphere(
        level_pressure=p, level_temperature=t,
        surface_temperature=t[:, -1] + 1.0,
        ppmv={1: rng.uniform(10.0, 2e4, (B, nlev)),
              2: np.full((B, nlev), 400.0)},
        emissivity_grid=np.array([50.0, 500.0]),
        emissivity=rng.uniform(0.85, 1.0, (B, 2)),
        cos_zenith=MU.copy(), total_solar_irradiance=np.full(B, 1361.0),
        albedo_grid=np.array([500.0, 10000.0]),
        albedo=rng.uniform(0.05, 0.3, (B, 2)),
        clean=False, clear=False,
        aerosol_optical_depth_1um=rng.uniform(0.0, 0.05, (B, nlay)),
        aerosol_angstrom_exponent=1.3,
        aerosol_single_scatter_albedo=rng.uniform(0.8, 0.95, (B, nlay)),
        aerosol_asymmetry_factor=rng.uniform(0.5, 0.75, (B, nlay)),
        cloud_fraction=cf,
        liquid_water_content=np.where(cf > 0, rng.uniform(0.05, 0.3,
                                                          (B, nlay)), 0.0),
        ice_water_content=np.where(cf > 0, rng.uniform(0.0, 0.02,
                                                       (B, nlay)), 0.0),
        layer_thickness=np.full((B, nlay), 400.0))
    jdriver = JDriver(jlw, jsw, jsol, cloud_optics=JCloudOpticsLib(
        liquid=jpade(nbnd=8, w0=1.0, wn=10000.0, seed=0),
        ice=jpade(nbnd=8, w0=1.0, wn=10000.0, seed=1)).driver_callback(),
        num_subcolumns=2, cloud_seed=5)
    return jdriver, jatm


def _port(jdriver):
    clouds = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=8, w0=1.0, wn=10000.0, seed=0,
                                    device="cpu"),
        ice=synthetic_pade_table(nbnd=8, w0=1.0, wn=10000.0, seed=1,
                                 device="cpu"))
    return driver_from_jax(jdriver, "cpu",
                           cloud_optics=clouds.driver_callback())


@pytest.fixture(scope="module")
def model():
    jdriver, jatm = _jax_model()
    return jdriver, _port(jdriver), jatm, atmosphere_from_jax(jatm)


@pytest.fixture(scope="module")
def full(model):
    return model[1].run(model[3])


def _assert_close(got, want, rtol, atol):
    assert list(got.tiers) == list(want.tiers) == ["csaf", "cs", "af"]
    for tier in want.tiers:
        for var in FLUXES:
            g = np.asarray(got.tiers[tier][var])
            np.testing.assert_allclose(g, np.asarray(want.tiers[tier][var]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{tier}/{var}")


def test_driver_from_jax_carries_the_settings(model):
    jdriver, driver, _, _ = model
    assert (driver.num_subcolumns, driver.cloud_seed, driver.sw_solver) == \
        (2, 5, "two_stream")
    assert driver.lw_gas.grid.n == jdriver.lw_gas.grid.n == 3001
    assert driver.sw_gas.grid.n == jdriver.sw_gas.grid.n == 2001
    assert np.array_equal(driver.solar.incident_flux.numpy(),
                          np.asarray(jdriver.solar.incident_flux))


@pytest.mark.parametrize("column_chunk", [1, 4])
def test_column_chunk_matches_unchunked(model, full, column_chunk):
    """Chunks of 4 and 2 columns (each mixed day and night) or of one:
    the same fluxes and the same cloud realizations."""
    _, driver, _, atm = model
    chunked = driver.run(atm, column_chunk=column_chunk)
    _assert_close(chunked, full, CHUNK_RTOL, CHUNK_ATOL)
    assert not np.allclose(full.tiers["af"]["rlu"].numpy(),
                           full.tiers["csaf"]["rlu"].numpy())


def test_column_chunk_spectral_output(model):
    _, driver, _, atm = model
    whole = driver.run(atm, integrated=False)
    chunked = driver.run(atm, integrated=False, column_chunk=4)
    assert chunked.tiers["af"]["rsu"].shape == (6, 9, 2001)
    _assert_close(chunked, whole, CHUNK_RTOL, CHUNK_ATOL)


def test_day_compaction_matches_per_column_runs(model, full, monkeypatch):
    """The lit columns run LW + SW and the night ones LW only (one step
    each, each padded to JAX's power-of-two bucket: 3 of 6 columns run as
    4), equal to runs of one column each (global ids carried by
    ``col_index``); night SW is exactly 0."""
    _, driver, _, atm = model
    calls = []
    step = RadiationDriver._step

    def spy(self, col, cloud_args, **kw):
        calls.append((kw["with_sw"], col["p_lev"].shape[0]))
        return step(self, col, cloud_args, **kw)

    monkeypatch.setattr(RadiationDriver, "_step", spy)
    res = driver.run(atm)
    assert sorted(calls) == [(False, 4), (True, 4)]
    monkeypatch.setattr(RadiationDriver, "_step", step)
    one = [driver.run(atm.subset([i]), col_index=[i])
           for i in range(atm.batch)]
    for tier in res.tiers:
        for var in FLUXES:
            got = res.tiers[tier][var].numpy()
            assert np.array_equal(got, full.tiers[tier][var].numpy())
            want = np.concatenate([o.tiers[tier][var].numpy() for o in one])
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tier}/{var}")
            if var in ("rsu", "rsd"):
                assert not got[MU <= 0].any()
                assert got[MU > 0].all()


def test_spectral_output_matches_jax(model, full, monkeypatch):
    """Spectra per point against JAX's: LW at the integrated fluxes' 1e-4,
    SW at 5e-3.  At this model's optically thin SW points the float32
    two-stream solve is ill-conditioned in both packages: with the same
    optics, both lie up to 3.3e-3 (CS rsu; CSAF 2.3e-4) from a float64
    solve, and a last-bit difference in the optics (an aerosol power, a
    sum order) moves a point by as much.  The spectra's integrals agree
    with the integrated run to 1e-5, and integrated fluxes with JAX's to
    1e-4 (tests/test_torch_driver_tiers.py)."""
    jdriver, driver, jatm, atm = model
    monkeypatch.setattr(jbeta, "betainc", exact_betainc)
    want = jdriver.run(jatm, integrated=False)
    got = driver.run(atm, integrated=False)
    assert not got.integrated
    for tier in ("csaf", "cs", "af"):
        for var in FLUXES:
            g = got.tiers[tier][var].numpy()
            w = np.asarray(want.tiers[tier][var])
            lw = var in ("rlu", "rld")
            assert g.shape == w.shape == (6, 9, 3001 if lw else 2001)
            assert worst_rel(g, w) < (TOLERANCE if lw else SW_SPECTRUM_TOL)
            if not lw:
                assert not g[MU <= 0].any()
            # The spectra integrate to the integrated run's fluxes.
            grid = driver.lw_gas.grid if lw else driver.sw_gas.grid
            integral = (0.5 * (g[..., :-1] + g[..., 1:])).sum(-1) * grid.dw
            assert worst_rel(integral, full.tiers[tier][var].numpy()) < 1e-5
    lw, sw = got.variable("RLUTAF"), got.variable("RSDSCS")
    assert lw.shape == (6, 3001) and sw.shape == (6, 2001)


def test_sw_spectra_float32_conditioning(model):
    """Why SW spectra are held at 5e-3: the float32 two-stream solve of
    the CS tier's optics on this model lies 1e-3 to 5e-3 (per point, 1 %
    floor) from a float64 solve of the same optics, in the port and in
    JAX alike."""
    import jax.numpy as jnp

    from grtcode_tpu.solvers import shortwave as jshortwave
    from grtcode_tpu_torch import constants
    from grtcode_tpu_torch.optics import Optics, combine
    from grtcode_tpu_torch.solvers.rayleigh import rayleigh_tau
    from grtcode_tpu_torch.solvers.shortwave import shortwave_fluxes
    from grtcode_tpu_torch.utils import curtis_godson as cg

    _, driver, _, atm = model
    lit = MU > 0
    ids = np.flatnonzero(lit)
    col, _ = driver._inputs(atm.subset(ids), ids)
    sw = driver.sw_gas
    w = sw.grid.wavenumbers("cpu")
    tau = sw.optical_depth(col["p_lev"], col["t_lev"], col["vmr_sw"])
    ray = rayleigh_tau(cg.number_densities(col["p_lev"]
                                           * constants.MB_TO_ATM), w)
    lam = 1e4 / w
    aero = col["aero_tau1um"][:, :, None] * \
        lam ** (-col["aero_alpha"][:, None, None])
    opt = combine([Optics.from_tau(tau),
                   Optics(ray, torch.ones_like(ray), torch.zeros_like(ray)),
                   Optics(aero, col["aero_omega"][:, :, None].expand_as(aero),
                          col["aero_g"][:, :, None].expand_as(aero))])
    mu = col["mu"]
    args = [opt.tau, opt.omega, opt.g, mu, torch.full_like(mu, 0.5),
            col["albedo"], col["albedo"], col["tsi"],
            driver.solar.incident_flux]
    up32 = shortwave_fluxes(*args)[0].numpy()
    up64 = shortwave_fluxes(*[a.double() for a in args])[0].numpy()
    upj = np.asarray(jshortwave.shortwave_fluxes(
        *[jnp.asarray(a.numpy()) for a in args])[0])
    for up in (up32, upj):
        assert 1e-3 < worst_rel(up, up64) < SW_SPECTRUM_TOL


@pytest.mark.parametrize("lw_method", ["line_sample", "wavenumber_sweep"])
def test_streamed_all_sky_matches_unstreamed(lw_method):
    jdriver, jatm = _jax_model(lw_method)
    driver = _port(jdriver)
    assert driver.lw_gas.block_quantum == (88 if lw_method ==
                                           "wavenumber_sweep" else 64)
    atm = atmosphere_from_jax(jatm)
    whole = driver.run(atm)
    streamed = driver.run(atm, spectral_chunks=3)
    _assert_close(streamed, whole, RTOL, ATOL)
    assert float(streamed.tiers["af"]["rsd"][0, 0]) > 0


def test_cloudy_atmosphere_needs_cloud_optics(model):
    _, driver, _, atm = model
    with pytest.raises(ValueError, match="cloud_optics"):
        dataclasses.replace(driver, cloud_optics=None).run(atm)


def test_subset_matches_jax(model):
    _, _, jatm, atm = model
    idx = np.array([4, 1, 1])
    sub, jsub = atm.subset(idx), jatm.subset(idx)
    assert (sub.batch, sub.num_levels, sub.num_layers) == (3, 9, 8)
    for f in dataclasses.fields(atmosphere.Atmosphere):
        got, want = getattr(sub, f.name), getattr(jsub, f.name)
        if isinstance(want, dict):
            assert list(got) == list(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), (f.name, k)
        elif want is None or isinstance(want, (bool, float)):
            assert got == want, f.name
        else:
            assert np.array_equal(got, want), f.name
    assert np.array_equal(sub.cloud_fraction, atm.cloud_fraction[idx])
    assert sub.aerosol_angstrom_exponent == 1.3
    assert sub.emissivity_grid is atm.emissivity_grid


def test_pressure_interp_layers_to_levels_matches_jax():
    rng = np.random.default_rng(3)
    lev = np.sort(rng.uniform(1.0, 1000.0, (3, 11)), axis=1)
    lay = 0.5 * (lev[:, :-1] + lev[:, 1:])
    vals = rng.uniform(200.0, 300.0, (3, 10))
    got = atmosphere.pressure_interp_layers_to_levels(vals, lay, lev)
    want = jatmosphere.pressure_interp_layers_to_levels(vals, lay, lev)
    assert got.shape == (3, 11) and np.array_equal(got, want)
