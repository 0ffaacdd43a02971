"""A whole run (``rtbench.run`` on the CPU at a small cut, the chip look
skipped) with the timed path broken underneath: ``correct`` comes out
false for an answer altered where it is produced and for half of the
batch left out, true for the unbroken path.  And the runs that must
print no result: no card, a forbidden module, no program beside the
benchmark."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import grtcode_tpu_torch.framework.driver as driver_mod
from rtbench import deployment, program, run
from rtbench.spec import ROOT, Spec

CUT = {"line_shrink": 256, "grid_coarsen": 8, "sites": 6, "experiments": 2}
CELLS = [c["name"] for c in Spec().data["workloads"]]
ARGS = ["--seed", "2147483711", "--seconds", "0.1", "--trace", "0",
        "--smoke"]


@pytest.fixture(params=CELLS)
def small(request, monkeypatch):
    """Each cell at a small cut (the bin method's grid coarser still, so
    that its plain version runs in seconds); the cell's name."""
    build = deployment.build

    def cut(cfg, seed, smoke=False):
        fine = any(b["method"] == "wavenumber_sweep"
                   for b in cfg["bands"].values())
        return build(dict(cfg, smoke=dict(
            CUT, **({"grid_coarsen": 20, "line_shrink": 512} if fine
                    else {}))), seed, smoke)
    monkeypatch.setattr(deployment, "build", cut)
    return request.param


def _run(capsys, cell):
    result = run.main(["--workload", cell, *ARGS])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == json.loads(json.dumps(result))
    return result


def test_the_unbroken_path_is_correct(small, capsys):
    assert _run(capsys, small)["correct"]


def test_an_answer_altered_where_it_is_produced(small, capsys, monkeypatch):
    lw = driver_mod.longwave_fluxes

    def altered(*a, **k):
        up, down = lw(*a, **k)
        return up * 1.001, down
    monkeypatch.setattr(driver_mod, "longwave_fluxes", altered)
    result = _run(capsys, small)
    assert not result["correct"]
    assert result["check"]["rlu_gap"][0] > result["check"]["rlu_gap"][1]


def test_half_of_the_batch_left_out(small, capsys, monkeypatch):
    """The first half of the columns computed, its fluxes handed out for
    the second half too."""
    class Half:
        def __init__(self, res, B):
            self.res, self.B = res, B

        def host(self):
            out = self.res.host()
            return {t: {k: np.resize(v, (self.B,) + v.shape[1:])
                        for k, v in fx.items()} for t, fx in out.items()}

    def half(driver, atm, S):
        B = atm.batch
        return Half(driver.run(atm.subset(np.arange((B + 1) // 2)),
                               spectral_chunks=S), B)
    monkeypatch.setattr(program, "run", half)
    assert not _run(capsys, small)["correct"]


def test_no_card_no_result(capsys):
    with pytest.raises(SystemExit) as err:
        run.main(["--workload", CELLS[0],
                  *[a for a in ARGS if a != "--smoke"]])
    assert err.value.code != 0
    assert capsys.readouterr().out == ""


def test_a_forbidden_module_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-m", "rtbench.run",
                           "--workload", CELLS[0], *ARGS],
                          cwd=tmp_path, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
