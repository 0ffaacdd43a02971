"""The port's aerosol (CS) and all-sky (AF) tiers as a whole.

* ``examples.allsky_like(smoke=True)`` builds the gas optics of
  ``rfmip_like`` with the aerosols, clouds, night columns and cloud
  optics it documents;
* its CSAF, CS and AF fluxes (one subcolumn, half the columns at night, so
  both packages compact the lit columns) match the JAX driver's on the
  same atmosphere, and ``FluxResults.variable`` gives JAX's values for
  every tier and level selector.

Two subcolumns and the reference-C golden's rows are in
tests/test_torch_driver_allsky.py; batching (column chunks, day
compaction, spectral output, streaming) in
tests/test_torch_driver_batching.py.

JAX's ``betainc`` is up to ~3e-6 off the exact incomplete beta (see
tests/test_torch_clouds.py); the JAX driver here runs with the exact one,
so the comparison measures the driver, not that error.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import bench  # noqa: E402

from grtcode_tpu.clouds import beta as jbeta  # noqa: E402
from grtcode_tpu.clouds.lib import CloudOpticsLib as JCloudOpticsLib  # noqa: E402
from grtcode_tpu.clouds.pade import PadeCloudOptics as JPadeCloudOptics  # noqa: E402
from grtcode_tpu.clouds.pade import synthetic_pade_table as jpade  # noqa: E402
from grtcode_tpu.framework.driver import RadiationDriver as JDriver  # noqa: E402
from grtcode_tpu_torch import examples  # noqa: E402
from grtcode_tpu_torch.clouds import beta  # noqa: E402
from grtcode_tpu_torch.clouds.lib import CloudOpticsLib  # noqa: E402
from grtcode_tpu_torch.clouds.pade import synthetic_pade_table  # noqa: E402
from grtcode_tpu_torch.utils import prng  # noqa: E402
# Against the JAX driver: TOLERANCE and the worst-relative measure of the
# CSAF tests.
from tests.test_torch_driver import FLUXES, TOLERANCE  # noqa: E402
from tests.test_torch_driver import _jax_atmosphere as jax_atmosphere  # noqa: E402
from tests.test_torch_driver import _worst_rel as worst_rel  # noqa: E402

TIERS = ("csaf", "cs", "af")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def jax_cloud_optics():
    """The JAX twin of allsky_like's cloud optics: the synthetic liquid
    table of seed 0 and the port's physical ice table, its arrays given
    to JAX's PadeCloudOptics."""
    ice = examples.ice_pade_table(device="cpu")
    return JCloudOpticsLib(
        liquid=jpade(nbnd=16, w0=1.0, wn=50000.0, seed=0),
        ice=JPadeCloudOptics.from_arrays(*(
            getattr(ice, f.name).numpy() for f in dataclasses.fields(ice)))
    ).driver_callback()


def exact_betainc(a, b, x):
    """jax.scipy.special.betainc's stand-in: the port's exact I_x(p, q)
    through a host callback."""
    import jax
    import jax.numpy as jnp

    def host(av, bv, xv):
        p, q = int(np.asarray(av).flat[0]), int(np.asarray(bv).flat[0])
        return beta.beta_value(p, q, torch.as_tensor(
            np.array(xv, np.float32))).numpy()

    return jax.pure_callback(host, jax.ShapeDtypeStruct(jnp.shape(x),
                                                        jnp.float32),
                             a, b, x, vmap_method="broadcast_all")


def smoke_tiers(num_subcolumns):
    """(port FluxResults, JAX FluxResults, port atmosphere) of
    allsky_like(smoke=True) with ``num_subcolumns`` subcolumns."""
    jlw, jsw, jsol, _, _, _ = bench.build(smoke=True)
    driver, atm = examples.allsky_like(smoke=True, device="cpu")
    jdriver = JDriver(jlw, jsw, jsol, cloud_optics=jax_cloud_optics(),
                      num_subcolumns=num_subcolumns)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbeta, "betainc", exact_betainc)
    try:
        want = jdriver.run(jax_atmosphere(atm), integrated=True)
    finally:
        mp.undo()
    got = dataclasses.replace(driver, num_subcolumns=num_subcolumns).run(atm)
    return got, want, atm


@pytest.fixture(scope="module")
def smoke():
    return smoke_tiers(1)


def test_allsky_like_builds_its_fields(smoke):
    _, _, atm = smoke
    driver, atm2 = examples.allsky_like(smoke=True, device="cpu")
    lw, sw, sol, batch, B, nlay = examples.rfmip_like(smoke=True,
                                                      device="cpu")
    assert (atm.batch, atm.num_layers) == (B, nlay) == (4, 54)
    assert driver.lw_gas.grid == lw.grid and driver.sw_gas.grid == sw.grid
    assert list(driver.lw_gas.molecules) == list(lw.molecules)
    assert driver.num_subcolumns == 1 and driver.cloud_optics is not None
    assert not atm.clean and not atm.clear
    # Half the columns at night, the others as rfmip_like's.
    assert np.all(atm.cos_zenith[1::2] <= 0.0)
    assert np.array_equal(atm.cos_zenith[0::2], batch["mu"][0::2])
    p_lay = 0.5 * (atm.level_pressure[:, :-1] + atm.level_pressure[:, 1:])
    liquid = (p_lay >= 700.0) & (p_lay <= 900.0)
    cirrus = (p_lay >= 200.0) & (p_lay <= 350.0)
    cloudy = atm.cloud_fraction > 0
    assert np.array_equal(cloudy, liquid | cirrus)
    assert atm.cloud_fraction[cloudy].min() >= 0.3
    assert atm.cloud_fraction.max() <= 1.0
    assert 0 < atm.liquid_water_content.max() <= 0.3
    assert not atm.liquid_water_content[~liquid].any()
    assert 0 < atm.ice_water_content.max() <= 0.02
    assert not atm.ice_water_content[~cirrus].any()
    # Hydrostatic thickness: ~190 m per 18.8 mb layer near 800 mb.
    assert atm.layer_thickness.shape == (4, 54)
    assert 150.0 < float(np.median(atm.layer_thickness[liquid])) < 250.0
    assert atm.aerosol_optical_depth_1um.shape == (4, 54)
    assert float(atm.aerosol_angstrom_exponent) == 1.48
    # Deterministic: built again, the same fields.
    for f in ("cloud_fraction", "liquid_water_content", "cos_zenith",
              "aerosol_optical_depth_1um"):
        assert np.array_equal(getattr(atm, f), getattr(atm2, f)), f
    # Its cloud optics: the synthetic Pade liquid table of seed 0 and the
    # physical ice table, both over 1-50,000 cm-1 in 16 bands.
    lib = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0,
                                    device="cpu"),
        ice=examples.ice_pade_table(device="cpu"))
    dev = driver.device
    f32 = torch.float32
    args = {
        "col_index": torch.arange(B),
        "cloud_fraction": torch.as_tensor(atm.cloud_fraction, dtype=f32),
        "liquid_water_content": torch.as_tensor(atm.liquid_water_content,
                                                dtype=f32),
        "ice_water_content": torch.as_tensor(atm.ice_water_content,
                                             dtype=f32),
        "t_lay": torch.as_tensor(atm.layer_temperature, dtype=f32),
        "layer_pressure": torch.as_tensor(p_lay, dtype=f32),
        "layer_thickness": torch.as_tensor(atm.layer_thickness, dtype=f32)}
    key = prng.prng_key(0, dev)
    w = sw.grid.wavenumbers(dev)
    got = driver.cloud_optics(args, key, w, None)
    want = lib.driver_callback()(args, key, w, None)
    for g, wt in zip(got[:2], want[:2]):
        assert torch.equal(g.tau, wt.tau) and float(g.tau.max()) > 0


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("var", FLUXES)
def test_tiers_match_jax_driver(smoke, tier, var):
    got, want, atm = smoke
    g, w = got.tiers[tier][var].numpy(), np.asarray(want.tiers[tier][var])
    assert g.shape == w.shape == (4, 55)
    assert np.isfinite(g).all()
    assert worst_rel(g, w) < TOLERANCE
    if var in ("rsu", "rsd"):
        assert not g[atm.cos_zenith <= 0].any()


def test_clouds_and_aerosols_change_the_fluxes(smoke):
    got, _, atm = smoke
    t = {k: {v: got.tiers[k][v].numpy() for v in FLUXES} for k in TIERS}
    assert not np.allclose(t["af"]["rlu"], t["csaf"]["rlu"])
    lit = atm.cos_zenith > 0
    assert (t["cs"]["rsd"][lit, -1] < t["csaf"]["rsd"][lit, -1]).all()


@pytest.mark.parametrize("sfx", ["CSAF", "CS", "AF"])
@pytest.mark.parametrize("band,direction", [("L", "U"), ("L", "D"),
                                            ("S", "U"), ("S", "D")])
@pytest.mark.parametrize("level", ["", "T", "S"])
def test_variable_matches_jax(smoke, sfx, band, direction, level):
    """Every tier, band, direction and level selector (none: all levels;
    T: the top; S: the surface), against JAX's with the floor of the
    variable's whole profile (rld at the top is 0)."""
    got, want, _ = smoke
    name = f"R{band}{direction}{level}{sfx}"
    g, w = got.variable(name), np.asarray(want.variable(name), np.float64)
    assert isinstance(g, np.ndarray) and g.shape == w.shape
    assert g.shape == ((4, 55) if level == "" else (4,))
    profile = np.asarray(want.variable(f"R{band}{direction}{sfx}"))
    scale = np.maximum(np.abs(w), 0.01 * np.abs(profile).max())
    assert float((np.abs(g - w) / scale).max()) < TOLERANCE


@pytest.mark.parametrize("name", ["RLU", "RSDT", "RLUTXX"])
def test_variable_refuses_unknown_tiers(smoke, name):
    got, want, _ = smoke
    for res in (got, want):
        with pytest.raises(KeyError):
            res.variable(name)
