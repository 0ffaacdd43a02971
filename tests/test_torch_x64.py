"""The port's float64 check of its solvers (``grtcode_tpu_torch.x64_validate``,
the counterpart of ``tools/x64_validate.py``): 8 LW and 12 SW comparisons
against the f64 reference-C goldens within 3e-9 x 10 on the CPU, its copied
case tables and inputs equal to the JAX suite's, and a result that is not
float64 failing the check.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_longwave as tlw  # noqa: E402
import test_shortwave as tsw  # noqa: E402

from grtcode_tpu_torch import x64_validate  # noqa: E402

BAR = 3e-8   # tools/x64_validate.py: RTOL x 10
LINE = re.compile(r"^(lw|sw) case (\d+) (up|down): max rel (\S+) "
                  r"\(torch\.float64\) ok$")


def test_x64_validation_passes_on_the_cpu(capsys):
    assert x64_validate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("X64 OK")
    found = [LINE.match(line) for line in out[:-1]]
    assert all(found), out
    bands = [m.group(1) for m in found]
    assert (bands.count("lw"), bands.count("sw")) == (8, 12)
    assert max(float(m.group(4)) for m in found) <= BAR
    assert x64_validate.RTOL * 10 == BAR


def test_case_tables_and_inputs_are_the_jax_suites():
    assert x64_validate.LW_CASES == tlw.CASES
    assert x64_validate.SW_CASES == tsw.CASES
    for case in tlw.CASES:
        nlevels, _, _, t_top, t_bot, tau_scale, w0, dw, nw = case
        args = (nlevels, t_top, t_bot, tau_scale, w0, dw, nw)
        for got, want in zip(x64_validate.lw_case_inputs(*args),
                             tlw._case_inputs(*args)):
            assert np.array_equal(got, want)
    for case in tsw.CASES:
        args = (case[0], case[5], case[6], case[7], case[8])
        for got, want in zip(x64_validate.sw_case_inputs(*args),
                             tsw._case_inputs(*args)):
            assert np.array_equal(got, want)


def test_a_float32_result_fails(monkeypatch, capsys):
    solver = x64_validate.longwave_fluxes

    def downcast(*args):
        return tuple(f.to(torch.float32) for f in solver(*args))

    monkeypatch.setattr(x64_validate, "longwave_fluxes", downcast)
    assert x64_validate.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("(torch.float32) FAIL") == 8
    assert "X64 FAILED (8 of 20 comparisons)" in out


def test_golden_dir_is_a_flag(tmp_path):
    with pytest.raises(FileNotFoundError):
        x64_validate.main(["--device", "cpu", "--golden-dir",
                           str(tmp_path)])
