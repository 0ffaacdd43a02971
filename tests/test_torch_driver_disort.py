"""The port's driver with the discrete-ordinates shortwave solver
(``RadiationDriver(sw_solver="disort")``), against the JAX driver, on the
all-tier model of tests/test_torch_driver_batching.py (six columns of
eight layers, three at night, aerosols, two stochastic subcolumns) with
its SW band cut to 1,000-2,000 cm-1 at 10:

* CSAF, CS and AF integrated fluxes at 16 streams match the JAX driver's
  at 1e-4 (worst relative with the golden's 1 % floor, as
  tests/test_torch_driver_tiers.py holds the two-stream tiers); night
  columns get no shortwave.

4 streams, integrated and spectral, are in
tests/test_torch_driver_disort_spectra.py, the driver golden's case in
tests/test_torch_driver_disort_golden.py, DISORT against the two-stream
solver in tests/test_torch_driver_disort_band.py (one JAX run of ~20 s per
driver variant bounds each file).  The smoke
``rfmip_like`` model takes minutes with DISORT on the CPU (6,251 SW points
x 54 layers per column; 35 s for the port at 4 streams, three for JAX), so
its all-tier form, ``allsky_like(smoke=True)``, is held card against CPU
at 4 streams in tests/test_torch_gpu.py instead.

The JAX driver runs its DISORT with ``wchunk=256`` (patched in, like the
exact ``betainc``): each wavenumber is solved on its own, so the block size
changes no result, and JAX's default 2,048 would pad these 101 points
twenty-fold.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import grtcode_tpu.solvers.disort as jdisort
from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu_torch.convert import atmosphere_from_jax
from tests.test_torch_driver_batching import MU, _jax_model, _port
from tests.test_torch_driver_tiers import (FLUXES, TIERS, TOLERANCE,
                                           exact_betainc, worst_rel)

SW_BAND = (1000.0, 2000.0, 10.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def disort(driver, nstr):
    return dataclasses.replace(driver, sw_solver="disort",
                               disort_streams=nstr)


def run_jax(jdriver, jatm, **kw):
    """The JAX driver's run with the exact betainc and DISORT at
    ``wchunk=256``."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbeta, "betainc", exact_betainc)
    mp.setattr(jdisort, "disort_shortwave",
               functools.partial(jdisort.disort_shortwave, wchunk=256))
    try:
        return jdriver.run(jatm, **kw)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def model():
    jdriver, jatm = _jax_model(sw_band=SW_BAND)
    return jdriver, _port(jdriver), jatm, atmosphere_from_jax(jatm)


def assert_tiers_match(got, want):
    """Every tier's integrated fluxes at TOLERANCE; night SW zero."""
    assert list(got.tiers) == list(TIERS)
    for tier in TIERS:
        for var in FLUXES:
            g = got.tiers[tier][var].numpy()
            w = np.asarray(want.tiers[tier][var])
            assert g.shape == w.shape == (6, 9) and np.isfinite(g).all()
            assert worst_rel(g, w) < TOLERANCE, (tier, var)
            if var in ("rsu", "rsd"):
                assert not g[MU <= 0].any() and g[MU > 0].all()


def test_all_tiers_match_jax_driver(model):
    jdriver, driver, jatm, atm = model
    assert_tiers_match(disort(driver, 16).run(atm),
                       run_jax(disort(jdriver, 16), jatm))
