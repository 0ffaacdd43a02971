"""The library path: the clear-sky aerosol-free step built by hand from the
public imports (``grtcode_tpu_torch.drive.clear_sky_step``: per-band
``GasOptics.optical_depth``, ``Optics.from_tau`` with its grid,
``rayleigh_optics``, ``+``, ``longwave_fluxes`` / ``shortwave_fluxes``,
``trapezoid_uniform``), at smoke size on the CPU:

* bit-identical to the port's ``RadiationDriver.run`` on the same
  atmosphere (the driver goes through the same functions in the same
  order);
* within the driver parity bar (1e-4 of each level's flux, floored at
  1 % of the variable's largest; tests/test_driver_golden.py:40) of the
  same step built by hand from the JAX package's public imports;
* the recipe's five physics invariants hold (``python -m
  grtcode_tpu_torch.drive --device cpu``), and without a GPU the module's
  default device refuses to run.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import bench  # noqa: E402

from grtcode_tpu import Optics as JOptics  # noqa: E402
from grtcode_tpu.framework import Atmosphere as JAtmosphere  # noqa: E402
from grtcode_tpu.solvers import (longwave_fluxes as jlongwave,  # noqa: E402
                                 rayleigh_optics as jrayleigh,
                                 shortwave_fluxes as jshortwave)
from grtcode_tpu.utils.interp import trapezoid_uniform as jtrapz  # noqa: E402
from grtcode_tpu_torch import drive, examples  # noqa: E402
from grtcode_tpu_torch.framework import Atmosphere, RadiationDriver  # noqa: E402

TOLERANCE = 1e-4
FLUXES = ("rlu", "rld", "rsu", "rsd")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _worst_rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


def _jax_step(lw_gas, sw_gas, solar, atm):
    """The same step from the JAX package's public imports."""
    def vmr(ppmv):
        return {k: np.asarray(v, np.float64) * 1e-6 for k, v in ppmv.items()}

    def f32(a):
        return jnp.asarray(np.asarray(a, np.float64), jnp.float32)

    p, t = atm.level_pressure, atm.level_temperature
    xs = dict(cfc_vmr=vmr(atm.cfc_ppmv), cia_vmr=vmr(atm.cia_ppmv))
    lwg, swg = lw_gas.grid, sw_gas.grid
    gas_lw = JOptics.from_tau(
        lw_gas.optical_depth(p, t, vmr(atm.ppmv), **xs), lwg)
    flu, fld = jax.jit(jlongwave)(
        gas_lw.tau, gas_lw.omega, f32(atm.surface_temperature),
        f32(atm.layer_temperature), f32(t),
        jnp.ones((atm.batch, lwg.n), jnp.float32), lwg.wavenumbers())
    opt = JOptics.from_tau(sw_gas.optical_depth(p, t, vmr(atm.ppmv), **xs),
                           swg) + jrayleigh(p, swg)
    assert opt.grid == swg
    mu = jnp.maximum(f32(atm.cos_zenith), 1e-6)
    albedo = jnp.full((atm.batch, swg.n), examples.SURFACE_ALBEDO,
                      jnp.float32)
    fsu, fsd = jax.jit(jshortwave)(
        opt.tau, opt.omega, opt.g, mu, jnp.full_like(mu, 0.5), albedo,
        albedo, f32(atm.total_solar_irradiance), solar.incident_flux)
    return {"rlu": jtrapz(flu, lwg.dw), "rld": jtrapz(fld, lwg.dw),
            "rsu": jtrapz(fsu, swg.dw), "rsd": jtrapz(fsd, swg.dw)}


@pytest.fixture(scope="module")
def steps():
    lw, sw, sol, batch, B, nlayers = examples.rfmip_like(smoke=True,
                                                         device="cpu")
    atm = examples.atmosphere(batch)
    hand = drive.clear_sky_step(lw, sw, sol, atm)
    run = RadiationDriver(lw, sw, sol).run(atm).tiers["csaf"]
    jlw, jsw, jsol, _, _, _ = bench.build(smoke=True)
    jatm = JAtmosphere(**{f.name: getattr(atm, f.name)
                          for f in dataclasses.fields(Atmosphere)})
    jhand = _jax_step(jlw, jsw, jsol, jatm)
    return hand, run, jhand, (B, nlayers + 1)


@pytest.mark.parametrize("var", FLUXES)
def test_hand_step_is_the_driver_step(steps, var):
    hand, run, _, shape = steps
    assert tuple(hand[var].shape) == shape
    assert torch.isfinite(hand[var]).all()
    assert torch.equal(hand[var], run[var])


@pytest.mark.parametrize("var", FLUXES)
def test_hand_step_matches_jax_hand_step(steps, var):
    hand, _, jhand, shape = steps
    want = np.asarray(jhand[var])
    assert want.shape == shape
    assert _worst_rel(hand[var].numpy(), want) < TOLERANCE


def test_hand_step_needs_lit_columns():
    lw, sw, sol, batch, _, _ = examples.rfmip_like(smoke=True, device="cpu")
    batch = dict(batch, mu=np.where(np.arange(4) == 2, -0.5, batch["mu"]))
    with pytest.raises(ValueError, match="every column lit"):
        drive.clear_sky_step(lw, sw, sol, examples.atmosphere(batch))


def test_physics_invariants_hold_on_the_cpu(capsys):
    checks = drive.physics_invariants("cpu")
    assert len(checks) == 9
    assert {c["name"][0] for c in checks} == set("12345")
    assert [c["name"] for c in checks if not c["ok"]] == []
    assert drive.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "9 of 9 checks hold on cpu" in out


def test_drive_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        drive.main([])
