"""The port's driver with DISORT against its own two-stream driver, on
the model of tests/test_torch_driver_disort.py: at 16 streams every
tier's SW fluxes lie within the two-stream band of tests/test_disort.py
(0.12 x the level's maximum + 1e-3), the longwave is unchanged and the top
receives TSI * mu; an unknown solver raises."""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_driver_disort import MU, disort, model  # noqa: F401
from tests.test_torch_driver_tiers import TIERS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_disort_within_the_two_stream_band(model):  # noqa: F811
    _, driver, _, atm = model
    two = driver.run(atm).tiers
    many = disort(driver, 16).run(atm).tiers
    lit = MU > 0
    for tier in TIERS:
        for var in ("rsu", "rsd"):
            a, b = many[tier][var].numpy()[lit], two[tier][var].numpy()[lit]
            band = 0.12 * np.abs(b).max(axis=1, keepdims=True) + 1e-3
            assert np.all(np.abs(a - b) <= band), (tier, var)
        for var in ("rlu", "rld"):
            assert torch.equal(many[tier][var], two[tier][var])
    # The top of the atmosphere receives TSI * mu with either solver.
    np.testing.assert_allclose(many["csaf"]["rsd"].numpy()[lit, 0],
                               1361.0 * MU[lit], rtol=1e-5)


def test_unknown_solver_raises(model):  # noqa: F811
    _, driver, _, atm = model
    with pytest.raises(ValueError, match="sw_solver"):
        dataclasses.replace(driver, sw_solver="eddington").run(atm)
