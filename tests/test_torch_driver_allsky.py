"""The all-sky driver with two subcolumns, and the reference-C golden.

* ``examples.allsky_like(smoke=True)`` with ``num_subcolumns=2``: CSAF, CS
  and AF fluxes (the AF tier the mean of two stochastic subcolumns) match
  the JAX driver's, with JAX's betainc replaced by the exact one as in
  tests/test_torch_driver_tiers.py;
* all 12 rows of the reference-C driver golden (tests/data/
  driver_golden.txt) hold through ``examples.golden_case(sky="all")``:
  the golden's aerosols and its fixed-condensate clouds.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools.goldens import driver_inputs  # noqa: E402

from grtcode_tpu_torch import examples  # noqa: E402
from grtcode_tpu_torch.spectral import SpectralGrid  # noqa: E402
from tests.test_torch_driver import _golden  # noqa: E402
from tests.test_torch_driver_tiers import (FLUXES, TIERS,  # noqa: E402
                                           TOLERANCE, smoke_tiers,
                                           worst_rel)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def two_subcolumns():
    return smoke_tiers(2)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("var", FLUXES)
def test_two_subcolumns_match_jax_driver(two_subcolumns, tier, var):
    got, want, atm = two_subcolumns
    g, w = got.tiers[tier][var].numpy(), np.asarray(want.tiers[tier][var])
    assert g.shape == w.shape == (4, 55)
    assert np.isfinite(g).all()
    assert worst_rel(g, w) < TOLERANCE
    if var in ("rsu", "rsd"):
        assert not g[atm.cos_zenith <= 0].any()


@pytest.fixture(scope="module")
def golden_all_sky(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("driver_inputs"))
    inputs = driver_inputs.write_inputs(d)
    inputs.update(aerosol=driver_inputs.aerosol(),
                  clouds=driver_inputs.clouds(),
                  pade=driver_inputs.pade_tables())
    driver, atm = examples.golden_case(
        d, inputs, SpectralGrid(*driver_inputs.LW_GRID),
        SpectralGrid(*driver_inputs.SW_GRID), device="cpu", sky="all")
    return driver.run(atm, integrated=True)


@pytest.mark.parametrize("label,tier,var", [
    (v + sfx, tier, v) for sfx, tier in (("", "csaf"), ("_cs", "cs"),
                                         ("_af", "af")) for v in FLUXES])
def test_all_tiers_match_reference_golden(golden_all_sky, label, tier, var):
    """The golden test's bars (tests/test_driver_golden.py): CSAF 1e-4,
    CS and AF 1e-3."""
    ref = _golden()[label]
    ours = golden_all_sky.tiers[tier][var][0].numpy()
    assert ours.shape == ref.shape == (driver_inputs.NLEV,)
    assert worst_rel(ours, ref) < (TOLERANCE if tier == "csaf" else 1e-3)


def test_golden_case_refuses_unknown_sky(tmp_path):
    with pytest.raises(ValueError, match="sky"):
        examples.golden_case(str(tmp_path), {}, None, None, device="cpu",
                             sky="cloudy")
