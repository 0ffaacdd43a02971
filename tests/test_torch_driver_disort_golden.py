"""The driver golden's clean, clear case with DISORT: the port's
``examples.golden_case`` (the files of ``driver_inputs.write_inputs``
through the port's readers) against the JAX driver built from the same
files as tests/test_driver_golden.py builds it, at coarse grids (LW
1-3,250 cm-1 at 5, SW 2,000-4,000 at 10), 16 streams: CSAF fluxes at 1e-4
(worst relative, 1 % floor); the top receives TSI * mu.  The JAX
driver's DISORT runs at ``wchunk=256`` (see
tests/test_torch_driver_disort.py).  4 streams are held on the all-tier
model (tests/test_torch_driver_disort_spectra.py): each JAX driver variant
compiles for ~10 s, and a second one would take this file past 40 s.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools.goldens import driver_inputs  # noqa: E402

from grtcode_tpu.framework.driver import RadiationDriver as JDriver  # noqa: E402
from grtcode_tpu.gas_optics.continua import (  # noqa: E402
    OzoneContinuum as JOzone, WaterVaporContinuum as JWaterVapor)
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics  # noqa: E402
from grtcode_tpu.gas_optics.molecules import CfcId, CiaId  # noqa: E402
from grtcode_tpu.solvers.solar_flux import SolarFlux as JSolarFlux  # noqa: E402
from grtcode_tpu.spectral import SpectralGrid as JGrid  # noqa: E402
from grtcode_tpu_torch import examples  # noqa: E402
from grtcode_tpu_torch.spectral import SpectralGrid  # noqa: E402
from tests.test_torch_driver import _jax_atmosphere  # noqa: E402
from tests.test_torch_driver_disort import disort, run_jax  # noqa: E402
from tests.test_torch_driver_tiers import (FLUXES, TOLERANCE,  # noqa: E402
                                           worst_rel)

GOLDEN_LW, GOLDEN_SW = (1.0, 3250.0, 5.0), (2000.0, 4000.0, 10.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _jax_golden_driver(d):
    def gas(grid):
        g = JGasOptics(
            grid, hitran_path=os.path.join(d, "synthetic.par"),
            h2o_ctm=JWaterVapor.from_directory(os.path.join(d, "h2o_ctm"),
                                               grid),
            o3_ctm=JOzone.from_file(os.path.join(d, "o3_ctm.csv"), grid))
        for mol in (1, 2, 3, 4, 6):
            g.add_molecule(mol)
        g.add_cfc(CfcId.CFC11, os.path.join(d, "cfc11.csv"))
        g.add_cfc(CfcId.CFC12, os.path.join(d, "cfc12.csv"))
        g.add_cia(CiaId.N2, CiaId.N2, os.path.join(d, "cia_n2n2.csv"))
        g.add_cia(CiaId.O2, CiaId.N2, os.path.join(d, "cia_o2n2.csv"))
        return g

    sw_grid = JGrid(*GOLDEN_SW)
    return JDriver(gas(JGrid(*GOLDEN_LW)), gas(sw_grid),
                   JSolarFlux.from_csv(os.path.join(d, "solar.csv"),
                                       sw_grid))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("driver_inputs"))
    driver, atm = examples.golden_case(
        d, driver_inputs.write_inputs(d), SpectralGrid(*GOLDEN_LW),
        SpectralGrid(*GOLDEN_SW), device="cpu")
    return driver, atm, _jax_golden_driver(d)


def test_golden_case_matches_jax_driver(golden):
    driver, atm, jdriver = golden
    got = disort(driver, 16).run(atm).tiers["csaf"]
    want = run_jax(disort(jdriver, 16), _jax_atmosphere(atm)).tiers["csaf"]
    for var in FLUXES:
        g, w = got[var].numpy(), np.asarray(want[var])
        assert g.shape == w.shape == (1, driver_inputs.NLEV)
        assert worst_rel(g, w) < TOLERANCE, var
    assert float(got["rsd"][0, 0]) == pytest.approx(
        driver_inputs.TSI * driver_inputs.MU, rel=1e-5)
