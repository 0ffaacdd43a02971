"""The port's CIRC app with ``-spectral-chunks 3`` (each band streamed
through three blocks) against the JAX package's on the driver golden's
input files at the coarse grids: every tier's fluxes and the printed table
at 1e-4 (worst relative, the golden's 1 % floor).  The driver's streamed
runs against its unstreamed ones are in tests/test_torch_driver.py."""
import pytest
import torch

from grtcode_tpu.apps import circ as jcirc
from grtcode_tpu_torch.apps import circ
from tests.test_torch_apps_circ import (assert_tables_match,  # noqa: F401
                                        assert_tiers_match, inputs)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_streamed_main_matches_jax(inputs, capsys):  # noqa: F811
    argv = inputs + ["-o", "", "-spectral-chunks", "3"]
    got = circ.main(argv, device="cpu")
    got_out = capsys.readouterr().out
    want = jcirc.main(argv)
    want_out = capsys.readouterr().out
    assert_tiers_match(got, want)
    assert_tables_match(got_out, want_out)
