"""The port's clear-sky aerosol-free radiation step as a whole.

* ``examples.rfmip_like(smoke=True)`` builds exactly the catalogs, tables
  and batch of ``bench.build(smoke=True)``, also with the bin method at
  the production resolution (``lw_method="wavenumber_sweep"``,
  ``lw_res=0.01``);
* the port's ``RadiationDriver`` CSAF fluxes match the JAX driver's on that
  atmosphere, and a mixed day/night batch (which both drivers split into
  lit and night columns) gives the lit column the same fluxes;
* ``run(spectral_chunks=S)`` streams both bands through S blocks and
  matches the port's unstreamed run and the JAX driver's streamed run, for
  line_sample and wavenumber_sweep; ``block_trapezoid_weights`` matches;
* the CSAF rows of the reference-C golden (tests/data/driver_golden.txt)
  match through the port's own file readers;
* ``mesh`` with ``spectral_chunks > 1`` raises, spectral output with spectral
  streaming raises ValueError;
* importing the port (the bindings and the parallel modules too) loads no
  JAX and no h5py, starts no process group and builds no library.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import bench  # noqa: E402
from tools.goldens import driver_inputs  # noqa: E402

from grtcode_tpu.framework.atmosphere import Atmosphere as JAtmosphere  # noqa: E402
from grtcode_tpu.framework.driver import RadiationDriver as JDriver  # noqa: E402
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics  # noqa: E402
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog  # noqa: E402
from grtcode_tpu.solvers.solar_flux import SolarFlux as JSolarFlux  # noqa: E402
from grtcode_tpu.spectral import SpectralGrid as JGrid  # noqa: E402
from grtcode_tpu.utils.interp import block_trapezoid_weights as jweights  # noqa: E402
from grtcode_tpu_torch import examples  # noqa: E402
from grtcode_tpu_torch.convert import (atmosphere_from_jax,  # noqa: E402
                                       gas_optics_from_jax, solar_from_jax)
from grtcode_tpu_torch.framework.atmosphere import Atmosphere  # noqa: E402
from grtcode_tpu_torch.framework.driver import RadiationDriver  # noqa: E402
from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics  # noqa: E402
from grtcode_tpu_torch.solvers.solar_flux import SolarFlux  # noqa: E402
from grtcode_tpu_torch.spectral import SpectralGrid  # noqa: E402
from grtcode_tpu_torch.utils.interp import block_trapezoid_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "driver_golden.txt")
# Integrated fluxes against the JAX driver and against the reference C
# (tests/test_driver_golden.py:40), relative per level with the golden
# test's floor (1 % of the variable's largest magnitude).
TOLERANCE = 1e-4
# Streamed against unstreamed and against the JAX streamed run
# (tests/test_framework.py:324-339).
STREAM_RTOL, STREAM_ATOL = 2e-5, 1e-4
FLUXES = ("rlu", "rld", "rsu", "rsd")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _worst_rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


@pytest.fixture(scope="module")
def smoke():
    jax_model = bench.build(smoke=True)
    port_model = examples.rfmip_like(smoke=True, device="cpu")
    return jax_model, port_model


def _jax_atmosphere(atm):
    return JAtmosphere(**{f.name: getattr(atm, f.name)
                          for f in dataclasses.fields(Atmosphere)})


def _assert_same_model(jax_model, port_model):
    (jlw, jsw, jsol, jbatch, jB, jnl), (lw, sw, sol, batch, B, nl) = \
        jax_model, port_model
    assert (B, nl) == (jB, jnl) == (4, 54)
    for key, val in jbatch.items():
        if isinstance(val, dict):
            assert list(batch[key]) == list(val)
            for k in val:
                assert np.array_equal(batch[key][k], val[k]), (key, k)
        else:
            assert np.array_equal(batch[key], val), key
    for jg, g in ((jlw, lw), (jsw, sw)):
        assert g.grid.n == jg.grid.n and g.tile == jg.tile
        assert g.method == jg.method
        assert list(g.molecules) == list(jg.molecules)
        for mol, gl in jg.molecules.items():
            for f in ("c0", "frac0", "vnn", "snn", "yair", "yself", "en",
                      "n", "d", "iso0"):
                assert np.array_equal(getattr(g.molecules[mol], f),
                                      np.asarray(getattr(gl, f))), (mol, f)
                assert np.array_equal(
                    getattr(g._raw_bounds[mol], f),
                    np.asarray(getattr(jg._raw_bounds[mol], f))), (mol, f)
            assert g.near_steps[mol] == jg.near_steps[mol]
            assert np.array_equal(g.chunk_ranges[mol].lo,
                                  jg.chunk_ranges[mol].lo)
        for f in ("cs", "cf", "t0s", "t0f"):
            assert np.array_equal(getattr(g.h2o_ctm, f).numpy(),
                                  np.asarray(getattr(jg.h2o_ctm, f)))
        assert np.array_equal(g.o3_ctm.cross_section.numpy(),
                              np.asarray(jg.o3_ctm.cross_section))
        for k, tb in jg.cfcs.items():
            assert np.array_equal(g.cfcs[k].cross_section.numpy(),
                                  np.asarray(tb.cross_section))
        for (a, b, t), (ja, jb, jt) in zip(g.cias, jg.cias):
            assert (a, b) == (ja, jb)
            assert np.array_equal(t.cross_section.numpy(),
                                  np.asarray(jt.cross_section))
    assert np.array_equal(sol.incident_flux.numpy(),
                          np.asarray(jsol.incident_flux))
    assert np.array_equal(solar_from_jax(jsol, "cpu").incident_flux.numpy(),
                          sol.incident_flux.numpy())


def test_rfmip_like_equals_bench_build(smoke):
    _assert_same_model(*smoke)


def test_rfmip_like_bin_method_equals_bench_build():
    """The production-resolution bin-method configuration, smoke-sized:
    LW at 0.08 cm-1 (0.01 x 8), 3,125 bins of 13 points, the last one of
    2 (so the last-bin interpolation switch is on the path)."""
    model = dict(lw_method="wavenumber_sweep", lw_res=0.01)
    jax_model = bench.build(smoke=True, **model)
    port_model = examples.rfmip_like(smoke=True, device="cpu", **model)
    _assert_same_model(jax_model, port_model)
    jlw, lw = jax_model[0], port_model[0]
    assert (lw.grid.n, lw.bins.ppb, lw.bins.n, lw.bins.last_ppb) == \
        (jlw.grid.n, jlw.bins.ppb, jlw.bins.n, jlw.bins.last_ppb) == \
        (40614, 13, 3125, 2)
    for mol in jlw.molecules:
        pr, jr = lw._get_bin_ranges(mol), jlw._get_bin_ranges(mol)
        for f in ("local_lo", "local_cnt", "rem_lo", "rem_cnt_l",
                  "rem_hi_start", "rem_cnt_r"):
            assert np.array_equal(getattr(pr, f), getattr(jr, f)), (mol, f)


@pytest.fixture(scope="module")
def smoke_fluxes(smoke):
    (jlw, jsw, jsol, _, _, _), (lw, sw, sol, batch, _, _) = smoke
    jatm = _jax_atmosphere(examples.atmosphere(batch))
    want = JDriver(jlw, jsw, jsol).run(jatm, integrated=True).tiers["csaf"]
    got = RadiationDriver(lw, sw, sol).run(atmosphere_from_jax(jatm))
    return ({k: v.numpy() for k, v in got.tiers["csaf"].items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("var", FLUXES)
def test_csaf_fluxes_match_jax_driver(smoke_fluxes, var):
    got, want = smoke_fluxes
    assert got[var].shape == want[var].shape == (4, 55)
    assert np.isfinite(got[var]).all()
    assert _worst_rel(got[var], want[var]) < TOLERANCE


def test_mixed_day_night_batch(smoke, smoke_fluxes):
    """Column 1 lit, the rest night (the lit column runs LW + SW, the
    night ones LW only): longwave unchanged, the lit column's shortwave
    that of the all-lit JAX run, night columns zero."""
    _, (lw, sw, sol, batch, _, _) = smoke
    _, want = smoke_fluxes
    atm = examples.atmosphere(batch)
    atm.cos_zenith = np.where(np.arange(4) == 1, batch["mu"],
                              [-0.3, 0.0, -0.05, 0.0])
    got = RadiationDriver(lw, sw, sol).run(atm).tiers["csaf"]
    for var in ("rlu", "rld"):
        assert _worst_rel(got[var].numpy(), want[var]) < TOLERANCE, var
    for var in ("rsu", "rsd"):
        assert _worst_rel(got[var][1].numpy(), want[var][1]) < TOLERANCE
        assert not got[var][[0, 2, 3]].any()


@pytest.fixture(scope="module")
def golden_fluxes(tmp_path_factory):
    """The driver-golden inputs through the port's own file readers, on
    the clean, clear form of that atmosphere."""
    d = str(tmp_path_factory.mktemp("driver_inputs"))
    driver, atm = examples.golden_case(
        d, driver_inputs.write_inputs(d),
        SpectralGrid(*driver_inputs.LW_GRID),
        SpectralGrid(*driver_inputs.SW_GRID), device="cpu")
    return driver.run(atm, integrated=True).tiers["csaf"]


def _golden():
    vals, cur = {}, None
    with open(GOLDEN) as f:
        for line in f:
            line = line.strip()
            if line.startswith("nlev"):
                continue
            if line.startswith("r"):
                cur = line
                vals[cur] = []
            else:
                vals[cur].append(float(line))
    return {k: np.asarray(v) for k, v in vals.items()}


@pytest.mark.parametrize("var", FLUXES)
def test_csaf_matches_reference_golden(golden_fluxes, var):
    ref = _golden()[var]      # the unsuffixed rows are the CSAF tier
    ours = golden_fluxes[var][0].numpy()
    assert ours.shape == ref.shape == (driver_inputs.NLEV,)
    assert _worst_rel(ours, ref) < TOLERANCE


@pytest.fixture(scope="module")
def tiny():
    grid = SpectralGrid(100.0, 120.0, 1.0)
    gas = GasOptics(grid, device="cpu")
    atm = Atmosphere(level_pressure=[[1.0, 500.0, 1000.0]],
                     level_temperature=[[220.0, 250.0, 280.0]],
                     surface_temperature=[281.0], ppmv={},
                     cos_zenith=np.array([0.5]),
                     total_solar_irradiance=np.array([1361.0]))
    solar = SolarFlux.from_samples([90.0, 130.0], [1.0, 1.0], grid, "cpu")
    return RadiationDriver(gas, GasOptics(grid, device="cpu"), solar), atm


@pytest.mark.parametrize("request_, item", [
    pytest.param(dict(mesh=object(), spectral_chunks=2), "spectral_chunks",
                 id="request_0-O6"),
])
def test_requests_off_the_slice_raise(tiny, request_, item):
    """A mesh with spectral_chunks > 1 raises, as in JAX
    (grtcode_tpu/framework/driver.py:375-378)."""
    driver, atm = tiny
    with pytest.raises(ValueError, match=item):
        driver.run(atm, **request_)


def test_tiny_column_runs_and_validates_spectral_chunks(tiny):
    driver, atm = tiny
    res = driver.run(atm, spectral_chunks=1).tiers["csaf"]
    assert all(torch.isfinite(v).all() for v in res.values())
    assert float(res["rld"][0, 0]) == 0.0 and float(res["rsd"][0, 0]) > 0
    with pytest.raises(ValueError, match="spectral_chunks"):
        driver.run(atm, spectral_chunks=0)


def test_spectral_output_is_not_streamed(tiny):
    driver, atm = tiny
    with pytest.raises(ValueError, match="spectral_chunks"):
        driver.run(atm, integrated=False, spectral_chunks=2)
    res = driver.run(atm, integrated=False, spectral_chunks=1)
    assert res.tiers["csaf"]["rsd"].shape == (1, 3, 21)


@pytest.mark.parametrize("start,block,n,dw", [
    (0, 64, 200, 0.1), (128, 64, 200, 0.1), (192, 64, 200, 0.1),
    (0, 5, 5, 1.0), (33128 * 9, 33128, 324901, 0.01)])
def test_block_trapezoid_weights_match_jax(start, block, n, dw):
    got = block_trapezoid_weights(start, block, n, dw).numpy()
    want = np.asarray(jweights(start, block, n, dw))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _mini_model(lw_method):
    """A small two-band model for the streaming tests, built for the JAX
    package and converted: LW 100-400 cm-1 at 0.1 (3,001 points; for the
    bin method 273 bins of 11, the last one of 9) with two molecules whose
    lines reach past both band ends; SW 1,000-9,000 cm-1 at 4.0
    (line_sample) with one molecule; 2 columns of 8 layers, grey-ish
    surface spectra."""
    def gas(grid, method, mols):
        g = JGasOptics(grid, line_chunk=64, method=method, pallas="off")
        for mol, seed in mols:
            rng = np.random.default_rng(seed)
            n = 150
            vnn = np.sort(rng.uniform(grid.w0 - 15.0, grid.wn + 15.0, n))
            g.add_catalog(jcatalog(
                mol, vnn, 10.0 ** rng.uniform(-22.0, -19.0, n),
                yair=rng.uniform(0.02, 0.1, n),
                yself=rng.uniform(0.05, 0.4, n),
                en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
                d=rng.uniform(-0.01, 0.01, n)))
        return g

    lw_grid, sw_grid = JGrid(100.0, 400.0, 0.1), JGrid(1000.0, 9000.0, 4.0)
    jlw = gas(lw_grid, lw_method, ((1, 21), (2, 22)))
    jsw = gas(sw_grid, "line_sample", ((1, 23),))
    jsol = JSolarFlux.from_samples(
        np.linspace(900.0, 9100.0, 64),
        1.0 + 0.5 * np.sin(np.linspace(0.0, 3.0, 64)), sw_grid)
    rng = np.random.default_rng(9)
    B, nlev = 2, 9
    p = np.linspace(0.05, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + rng.uniform(-4, 4,
                                                               (B, nlev))
    jatm = JAtmosphere(
        level_pressure=p, level_temperature=t,
        surface_temperature=t[:, -1] + 1.0,
        ppmv={1: rng.uniform(10.0, 2e4, (B, nlev)),
              2: np.full((B, nlev), 400.0)},
        emissivity_grid=np.array([50.0, 500.0]),
        emissivity=np.array([[0.95, 0.9], [1.0, 0.85]]),
        cos_zenith=np.array([0.6, 0.25]),
        total_solar_irradiance=np.array([1361.0, 1361.0]),
        albedo_grid=np.array([500.0, 10000.0]),
        albedo=np.array([[0.1, 0.3], [0.2, 0.05]]))
    port = (gas_optics_from_jax(jlw, "cpu"), gas_optics_from_jax(jsw, "cpu"),
            solar_from_jax(jsol, "cpu"))
    return (jlw, jsw, jsol), port, jatm


@pytest.mark.parametrize("lw_method", ["line_sample", "wavenumber_sweep"])
def test_spectral_chunks_streaming_matches(lw_method):
    jax_objs, port_objs, jatm = _mini_model(lw_method)
    atm = atmosphere_from_jax(jatm)
    driver = RadiationDriver(*port_objs)
    full = driver.run(atm).tiers["csaf"]
    streamed = driver.run(atm, spectral_chunks=3).tiers["csaf"]
    want = JDriver(*jax_objs).run(jatm, integrated=True,
                                  spectral_chunks=3).tiers["csaf"]
    q = port_objs[0].block_quantum
    assert q == (88 if lw_method == "wavenumber_sweep" else 64)
    for var in FLUXES:
        got = streamed[var].numpy()
        assert got.shape == (2, 9) and np.isfinite(got).all()
        np.testing.assert_allclose(got, full[var].numpy(), rtol=STREAM_RTOL,
                                   atol=STREAM_ATOL, err_msg=var)
        np.testing.assert_allclose(got, np.asarray(want[var]),
                                   rtol=STREAM_RTOL, atol=STREAM_ATOL,
                                   err_msg=var)
    assert float(streamed["rlu"][0, 0]) > 0 and float(streamed["rsd"][0, 0])


def test_night_batch_has_no_shortwave(tiny):
    driver, atm = tiny
    night = dataclasses.replace(atm, cos_zenith=np.array([-0.4]))
    res = driver.run(night).tiers["csaf"]
    assert not res["rsu"].any() and not res["rsd"].any()
    assert float(res["rlu"][0, 0]) > 0


def _code_strings(path):
    """Every string constant of a module that is not a docstring."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_names_no_path_of_the_jax_package():
    """No module of the port builds a path under grtcode_tpu/: its data
    files are its own (grtcode_tpu_torch/data/)."""
    port = pathlib.Path(REPO) / "grtcode_tpu_torch"
    bad = []
    for path in sorted(port.rglob("*.py")):
        for s in _code_strings(path):
            parts = s.replace(os.sep, "/").split("/")
            if "grtcode_tpu" in parts:
                bad.append(f"{path.relative_to(REPO)}: {s!r}")
    assert bad == []
    from grtcode_tpu_torch.apps import circ
    from grtcode_tpu_torch.gas_optics import tips
    for path in (circ.DATA, tips._PACKAGED_TABLE):
        assert os.path.commonpath([os.path.realpath(path), str(port)]) == \
            str(port), path
    assert isinstance(tips.default_tips(), tips.TabulatedTips)


@pytest.mark.parametrize("name", ["tips2017.npz", "circ1.npz"])
def test_port_data_is_a_copy_of_the_jax_data(name):
    with open(os.path.join(REPO, "grtcode_tpu", "data", name), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "grtcode_tpu_torch", "data", name),
              "rb") as f:
        assert f.read() == want


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import grtcode_tpu_torch\n"
        "for m in pkgutil.walk_packages(grtcode_tpu_torch.__path__,\n"
        "                               'grtcode_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'h5py' not in sys.modules, 'h5py was imported'\n"
        "assert not any(k.split('.')[0] == 'grtcode_tpu' for k in sys.modules)\n"
        "assert 'bench' not in sys.modules, 'bench.py was imported'\n"
        "for m in ('bindings.capi_impl', 'parallel.mesh', 'parallel.clear_sky',\n"
        "          'parallel.distributed', 'parallel.dryrun', 'native',\n"
        "          'utils.metrics', 'utils.debug', 'utils.segments',\n"
        "          'x64_validate'):\n"
        "    assert 'grtcode_tpu_torch.' + m in sys.modules, m\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group was started'\n"
        "from grtcode_tpu_torch import native\n"
        "assert native._lib is None and not native._tried, 'a library was built'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
