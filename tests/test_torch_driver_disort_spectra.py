"""The port's driver with DISORT at 4 streams against the JAX driver, on
the model of tests/test_torch_driver_disort.py: the spectra of every tier
at 1e-4 (worst relative, 1 % floor per spectrum; the worst found at 16
streams is 1.4e-5, AF rsu, so the SW spectra need no looser bar than the
integrated fluxes, unlike the two-stream solver's in
tests/test_torch_driver_batching.py), and the port's integrated fluxes
against the trapezoid of JAX's spectra (JAX's own integrated output is
that trapezoid; one JAX compile instead of two) at 1e-4.  Each port
spectrum integrates to the port's integrated flux at 1e-5.
"""
import types

import numpy as np
import pytest
import torch

from tests.test_torch_driver_disort import (MU, assert_tiers_match,  # noqa: F401
                                            disort, model, run_jax)
from tests.test_torch_driver_tiers import (FLUXES, TIERS, TOLERANCE,
                                           worst_rel)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def trapezoid(spectra, grid):
    return (0.5 * (spectra[..., :-1] + spectra[..., 1:])).sum(-1) * grid.dw


@pytest.fixture(scope="module")
def runs(model):  # noqa: F811
    jdriver, driver, jatm, atm = model
    return (disort(driver, 4).run(atm),
            disort(driver, 4).run(atm, integrated=False),
            run_jax(disort(jdriver, 4), jatm, integrated=False))


def test_four_streams_match_jax_driver(model, runs):  # noqa: F811
    driver = model[1]
    integrated, _, want = runs
    grids = {"rlu": driver.lw_gas.grid, "rld": driver.lw_gas.grid,
             "rsu": driver.sw_gas.grid, "rsd": driver.sw_gas.grid}
    assert_tiers_match(integrated, types.SimpleNamespace(tiers={
        t: {k: trapezoid(np.asarray(v, np.float64), grids[k])
            for k, v in fx.items()} for t, fx in want.tiers.items()}))


def test_spectra_match_jax_driver(model, runs):  # noqa: F811
    driver = model[1]
    integrated, got, want = runs
    for tier in TIERS:
        for var in FLUXES:
            g = got.tiers[tier][var].numpy()
            w = np.asarray(want.tiers[tier][var])
            lw = var in ("rlu", "rld")
            assert g.shape == w.shape == (6, 9, 3001 if lw else 101)
            assert worst_rel(g, w) < TOLERANCE, (tier, var)
            if not lw:
                assert not g[MU <= 0].any()
            grid = driver.lw_gas.grid if lw else driver.sw_gas.grid
            assert worst_rel(trapezoid(g, grid),
                             integrated.tiers[tier][var].numpy()) < 1e-5
