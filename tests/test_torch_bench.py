"""The port's headline benchmark (``grtcode_tpu_torch.bench``) against the
JAX package's ``bench.py`` (the bin method at 0.01 cm-1 and the census of
the step's launches: ``tests/test_torch_bench_bins.py``).

* ``make_step`` gives the five outputs of ``bench.make_step`` at
  ``--smoke`` size, line_sample with the LW band in 1 and 2 blocks;
* ``--chunk 2`` on B = 4 gives the unchunked step's last two columns;
* the flags are ``bench.py``'s (read from its source), less
  ``--shared-hw``, plus ``--device``, with the same defaults;
* ``main(["--smoke", "--profile"], device="cpu")`` prints one JSON line
  with the JAX bench's metric and ``kernel_work``'s bound, leaves the
  device rates and the profiled keys out on the CPU and says why; without
  CUDA and without ``--device`` it exits naming ``--device cpu``;
* ``sweep_batch`` picks the best batch, falls back to ``--chunk 16`` after
  a failed run and exits when every run fails (``subprocess.run`` patched).
"""
import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import bench as jbench  # noqa: E402

from grtcode_tpu_torch import bench  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_driver.py's bars for the same model: integrated fluxes
# relative per level with the driver golden's 1 % floor
# (tests/test_driver_golden.py:40), and for the streamed LW band rtol /
# atol (tests/test_framework.py:324-339).  The SW band is never streamed
# here; the two packages' f32 two-stream SW differ by up to 4.2e-5 of rsu
# at smoke size, streamed LW or not.
TOLERANCE = 1e-4
STREAM_RTOL, STREAM_ATOL = 2e-5, 1e-4
# A column slice against the whole batch (the chain added to t_lev is
# ~1e-28 K, below f32's resolution at 200-300 K).
CHUNK_RTOL = 1e-6
OUTPUTS = ("rlu", "rld", "rsu", "rsd", "chain")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _worst_rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


def _zero():
    return torch.zeros((), dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    """The smoke-size line_sample model: (JAX model, port model)."""
    return jbench.build(smoke=True), bench.build(smoke=True, device="cpu")


@pytest.fixture(scope="module")
def steps(models):
    """Every JAX step of the file, beside the port's same step: {LW blocks:
    (JAX outputs, port outputs)}, each five numpy arrays."""
    jm, pm = models
    out = {}
    for blocks in (1, 2):
        jstep = jbench.make_step(*jm[:3], lw_blocks=blocks)
        want = jstep(*bench.step_args(jm[3]), jnp.float32(0.0))
        got = bench.make_step(*pm[:3], lw_blocks=blocks)(
            *bench.step_args(pm[3]), _zero())
        out[blocks] = ([np.asarray(a) for a in want],
                       [a.numpy() for a in got])
    return out


def assert_step_matches(got, want, streamed):
    """The five outputs: each at the same model's bar, and with the LW band
    streamed, rlu and rld at the streamed bar too."""
    B = want[0].shape[0]
    for var, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape == (() if var == "chain" else (B, 55))
        assert np.isfinite(g).all(), var
        assert _worst_rel(g, w) <= TOLERANCE, (var, _worst_rel(g, w))
        if streamed and var in ("rlu", "rld"):
            np.testing.assert_allclose(g, w, rtol=STREAM_RTOL,
                                       atol=STREAM_ATOL, err_msg=var)
    assert float(got[0][0, 0]) > 0 and float(got[3][0, 0]) > 0


@pytest.mark.parametrize("blocks", [1, 2])
def test_make_step_matches_jax(steps, blocks):
    want, got = steps[blocks]
    assert_step_matches(got, want, streamed=blocks > 1)


def test_blocks_match_the_unblocked_step(steps):
    _, one = steps[1]
    _, two = steps[2]
    for var, a, b in zip(OUTPUTS[:4], two, one):
        np.testing.assert_allclose(a, b, rtol=STREAM_RTOL, atol=STREAM_ATOL,
                                   err_msg=var)


def test_chunk_matches_the_unchunked_step(models, steps):
    pm = models[1]
    step, args = bench.chunked_step(bench.make_step(*pm[:3]), pm[3], 2)
    assert args == ()
    got = step(_zero())
    _, whole = steps[1]
    for var, g, w in zip(OUTPUTS[:4], got, whole):
        assert tuple(g.shape) == (2, 55)
        np.testing.assert_allclose(g.numpy(), w[2:], rtol=CHUNK_RTOL,
                                   atol=0, err_msg=var)
    np.testing.assert_allclose(float(got[4]), float(whole[0][2, 0]) * 1e-30,
                               rtol=CHUNK_RTOL)


def _jax_flags():
    """{flag: default} of every add_argument call in bench.py."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else (False if ast.literal_eval(kw["action"]) == "store_true"
                      else None)
            flags[node.args[0].value] = default
    return flags


def test_flags_are_the_jax_bench_flags():
    want = _jax_flags()
    assert "--shared-hw" in want
    del want["--shared-hw"]   # TPU-only: pads a TPU kernel signature
    got = {a.option_strings[0]: a.default
           for a in bench.parser()._actions if a.option_strings
           and a.option_strings[0] != "-h"}
    assert got.pop("--device") == "cuda:0"
    assert got == want


@pytest.fixture(scope="module")
def smoke_main():
    """(result, stdout, stderr) of main(["--smoke", "--profile"]) on the
    CPU."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = bench.main(["--smoke", "--profile"], device="cpu")
    return result, out.getvalue(), err.getvalue()


def test_main_prints_one_json_line(smoke_main):
    result, out, err = smoke_main
    lines = out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    assert result["metric"] == "gridpoints_per_s_per_chip"
    assert result["unit"] == "column*layer*wavenumber points/s (LW+SW)"
    assert result["value"] > 0 and result["compile_first_s"] > 0
    assert result["vs_baseline"] == result["value"] / 9.9e5
    assert result["device"] == "cpu"
    assert result["kernel_launches_per_step"] == {"voigt_line_sample": 11,
                                                  "voigt_bins": 0}
    assert result["kernel_bound_ms_per_step"] > 0
    # Device numbers are not measured on the CPU.
    for key in ("peak_hbm_gib", "est_tflops", "est_share_of_f32_peak"):
        assert key not in result
    assert "not measured on the CPU" in err
    for key in ("lw_method", "lw_res", "lw_points"):
        assert key not in result   # the default configuration


def test_profile_on_the_cpu_leaves_the_keys_out(smoke_main):
    result, _, err = smoke_main
    assert not any(k.startswith("profiled_") for k in result)
    assert "no CUDA device track" in err


def test_main_without_cuda_names_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--smoke"])
    assert "--device cpu" in str(exc.value.code)


def _fake_run(values):
    """A subprocess.run that answers each bench command from ``values``
    ({label: points/s, or None for a failed run}) and records the
    commands."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        i = cmd.index("--batch")
        label = f"B={cmd[i + 1]}" + ("+chunk16" if "--chunk" in cmd else "")
        value = values[label]
        if value is None:
            return subprocess.CompletedProcess(cmd, 1, "", "out of memory")
        line = json.dumps({"metric": "gridpoints_per_s_per_chip",
                           "value": value})
        return subprocess.CompletedProcess(cmd, 0, "log\n" + line + "\n", "")
    return run, calls


def test_sweep_batch_picks_the_best_and_falls_back(monkeypatch, capsys):
    run, calls = _fake_run({"B=16": 1.0e8, "B=32": None,
                            "B=32+chunk16": 1.5e8, "B=64": 1.2e8,
                            "B=64+chunk16": 9.9e9})
    monkeypatch.setattr(bench.subprocess, "run", run)
    result = bench.sweep_batch("cuda:0")
    labels = [" ".join(c[3:]) for c in calls]
    assert labels == ["--batch 16 --device cuda:0",
                      "--batch 32 --device cuda:0",
                      "--batch 32 --device cuda:0 --chunk 16",
                      "--batch 64 --device cuda:0"]
    assert all(c[:3] == [sys.executable, "-m", "grtcode_tpu_torch.bench"]
               for c in calls)
    assert result["best_config"] == "B=32+chunk16"
    assert result["value"] == 1.5e8
    assert result["sweep"] == {"B=16": 1.0e8, "B=32+chunk16": 1.5e8,
                               "B=64": 1.2e8}
    assert json.loads(capsys.readouterr().out.strip()) == result


def test_sweep_batch_exits_when_every_run_fails(monkeypatch):
    run, calls = _fake_run(dict.fromkeys(
        ("B=16", "B=32", "B=32+chunk16", "B=64", "B=64+chunk16")))
    monkeypatch.setattr(bench.subprocess, "run", run)
    with pytest.raises(SystemExit, match="every configuration failed"):
        bench.sweep_batch("cuda:0")
    assert len(calls) == 5


def test_kernel_bound_is_kernel_work(models, smoke_main):
    lw, sw, _, batch, _, _ = models[1]
    work = bench.kernel_work(lw, sw, batch, lw_blocks=1)
    assert smoke_main[0]["kernel_bound_ms_per_step"] == work["bound_ms"]
