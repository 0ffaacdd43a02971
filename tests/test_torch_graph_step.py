"""The port's counterpart of the JAX package's compiled step, on the CPU.

On a CUDA device the driver and the bench run each step's first call
eagerly, capture it as a CUDA graph at the second call and replay it
after that (grtcode_tpu_torch/utils/graphs.py); the
graphs themselves run only on the card (tests/test_torch_gpu.py).  Here:

* day compaction pads the lit and night columns to JAX's power-of-two
  buckets: the sub-batches the port's driver runs equal the JAX driver's
  for every lit count 0..B, B in {1, 5, 8, 13}, and ``bucket_pad`` is the
  rule;
* the driver's fluxes equal JAX's within the driver golden's 1e-4 for lit
  fractions under a half (compaction), over a half (the masked full
  batch), all lit and all night; the night columns' shortwave is 0;
* the step cache runs a key's first call eagerly and captures at its
  second, and holds one entry per key and bucket (its capture stubbed to
  run the step eagerly); a run called once holds no graph; a step that
  runs out of memory while the cache holds graphs drops them and runs
  once more; ``clear_cache`` drops them on request; a replay adds the
  launches of every dispatcher registered with ``count_launches``;
* the device constants are built once: after a warm step, a second step
  creates no tensor from host data, on the line_sample, streamed
  bin-method, all-sky and DISORT paths;
* the line_sample limits check still raises its message, from
  ``GasOptics.optical_depth`` and from the driver before any step work;
* ``disable_jit`` and ``debug_mode`` switch the captured step off;
* the public ``cloudiness`` and ``interpolate_bins`` take array-likes.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from grtcode_tpu.framework.atmosphere import Atmosphere as JAtmosphere  # noqa: E402
from grtcode_tpu.framework.driver import RadiationDriver as JDriver  # noqa: E402
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics  # noqa: E402
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog  # noqa: E402
from grtcode_tpu.solvers.solar_flux import SolarFlux as JSolarFlux  # noqa: E402
from grtcode_tpu.spectral import SpectralGrid as JGrid  # noqa: E402
from grtcode_tpu_torch.convert import (atmosphere_from_jax,  # noqa: E402
                                       gas_optics_from_jax, solar_from_jax)
from grtcode_tpu_torch.framework import driver as driver_mod  # noqa: E402
from grtcode_tpu_torch.framework.driver import RadiationDriver  # noqa: E402
from grtcode_tpu_torch.utils import debug, graphs  # noqa: E402
from tests.test_torch_driver import FLUXES, TOLERANCE  # noqa: E402
from tests.test_torch_driver import _worst_rel as worst_rel  # noqa: E402
from tests.test_torch_driver_batching import _jax_model as allsky_model  # noqa: E402
from tests.test_torch_driver_batching import _port as allsky_port  # noqa: E402

B = 8
# Lit counts of the B = 8 batch: under a half (lit bucket 4, night bucket
# 8), over a half (the lit bucket is the batch: the masked full batch),
# all lit and all night.
LIT = {"under_half": 3, "over_half": 5, "all_lit": 8, "all_night": 0}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _gas(grid, method, mols):
    g = JGasOptics(grid, line_chunk=64, method=method, pallas="off")
    for mol, seed in mols:
        rng = np.random.default_rng(seed)
        n = 150
        vnn = np.sort(rng.uniform(grid.w0 - 15.0, grid.wn + 15.0, n))
        g.add_catalog(jcatalog(
            mol, vnn, 10.0 ** rng.uniform(-22.0, -19.0, n),
            yair=rng.uniform(0.02, 0.1, n), yself=rng.uniform(0.05, 0.4, n),
            en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
            d=rng.uniform(-0.01, 0.01, n)))
    return g


def _model(lw_method="line_sample", batch=B, mols=((1, 21), (2, 22))):
    """(JAX gas optics and solar, the port's, a JAX clear-sky atmosphere of
    ``batch`` columns all lit): LW 100-400 cm-1 at 0.1, SW 1,000-9,000
    cm-1 at 4.0, 8 layers."""
    lw_grid, sw_grid = JGrid(100.0, 400.0, 0.1), JGrid(1000.0, 9000.0, 4.0)
    jlw = _gas(lw_grid, lw_method, mols)
    jsw = _gas(sw_grid, "line_sample", ((1, 23),))
    jsol = JSolarFlux.from_samples(
        np.linspace(900.0, 9100.0, 64),
        1.0 + 0.5 * np.sin(np.linspace(0.0, 3.0, 64)), sw_grid)
    rng = np.random.default_rng(9)
    nlev = 9
    p = np.linspace(0.05, 1013.0, nlev)[None, :] * np.ones((batch, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + rng.uniform(
        -4, 4, (batch, nlev))
    jatm = JAtmosphere(
        level_pressure=p, level_temperature=t,
        surface_temperature=t[:, -1] + 1.0,
        ppmv={1: rng.uniform(10.0, 2e4, (batch, nlev)),
              2: np.full((batch, nlev), 400.0)},
        emissivity_grid=np.array([50.0, 500.0]),
        emissivity=rng.uniform(0.85, 1.0, (batch, 2)),
        cos_zenith=rng.uniform(0.1, 0.9, batch),
        total_solar_irradiance=np.full(batch, 1361.0),
        albedo_grid=np.array([500.0, 10000.0]),
        albedo=rng.uniform(0.05, 0.3, (batch, 2)))
    port = (gas_optics_from_jax(jlw, "cpu"), gas_optics_from_jax(jsw, "cpu"),
            solar_from_jax(jsol, "cpu"))
    return (jlw, jsw, jsol), port, jatm


def _lit(atm, n_lit, seed=3):
    """``atm`` with ``n_lit`` lit columns at random places, the others at
    cos zenith <= 0."""
    rng = np.random.default_rng(seed + n_lit)
    mu = -rng.uniform(0.0, 0.5, atm.batch)
    mu[rng.permutation(atm.batch)[:n_lit]] = rng.uniform(0.1, 0.9, n_lit)
    return dataclasses.replace(atm, cos_zenith=mu)


# -- the bucket rule ---------------------------------------------------------

def _jax_sub_batches(jdriver, jatm):
    """The (with_sw, columns) of each step the JAX driver runs on
    ``jatm``, its steps stubbed to return zeros."""
    calls = []

    def fake_step(clean, clear, integrated, mesh=None, with_sw=True,
                  spectral_chunks=1):
        def run(dev, cloud_args):
            b = dev["t_lev"].shape[0]
            calls.append((with_sw, b))
            z = jnp.zeros((b, dev["t_lev"].shape[1]))
            return {"csaf": {k: z for k in FLUXES}}
        return run

    jdriver._step = fake_step
    jdriver.run(jatm)
    return calls


def _port_sub_batches(driver, atm, monkeypatch):
    calls = []

    def fake_step(self, col, cloud_args, clean, clear, integrated, with_sw,
                  S, block=None):
        b = col["t_lev"].shape[0]
        calls.append((with_sw, b))
        z = torch.zeros((b, col["t_lev"].shape[1]))
        return {"csaf": {k: z for k in FLUXES}}

    monkeypatch.setattr(RadiationDriver, "_step", fake_step)
    driver.run(atm)
    return calls


@pytest.mark.parametrize("batch", [1, 5, 8, 13])
def test_bucket_rule_matches_jax(batch, monkeypatch):
    jobjs, port, jatm = _model(batch=batch, mols=((1, 21),))
    jdriver, driver = JDriver(*jobjs), RadiationDriver(*port)
    for n_lit in range(batch + 1):
        ja = _lit(jatm, n_lit)
        want = _jax_sub_batches(jdriver, ja)
        got = _port_sub_batches(driver, atmosphere_from_jax(ja), monkeypatch)
        assert got == want, (batch, n_lit)
        if 0 < n_lit < batch and len(got) == 2:
            lit = np.flatnonzero(ja.cos_zenith > 0)
            padded = driver_mod.bucket_pad(lit, batch)
            assert got[0] == (True, padded.size)
            assert (padded[:n_lit] == lit).all()
            assert (padded[n_lit:] == lit[0]).all()


# -- fluxes against JAX by lit fraction --------------------------------------

@pytest.fixture(scope="module")
def drivers():
    jobjs, port, jatm = _model()
    return JDriver(*jobjs), RadiationDriver(*port), jatm


@pytest.mark.parametrize("case", list(LIT))
def test_fluxes_match_jax_by_lit_fraction(drivers, case):
    jdriver, driver, jatm = drivers
    ja = _lit(jatm, LIT[case])
    want = jdriver.run(ja).tiers["csaf"]
    got = driver.run(atmosphere_from_jax(ja)).tiers["csaf"]
    night = ja.cos_zenith <= 0
    for var in FLUXES:
        g = got[var].numpy()
        assert g.shape == (B, 9) and np.isfinite(g).all()
        w = np.asarray(want[var])
        if not w.any():                       # all night: SW exactly 0
            assert not g.any(), var
            continue
        assert worst_rel(g, w) < TOLERANCE, var
        if var in ("rsu", "rsd"):
            assert not g[night].any(), var
    assert (got["rsd"].numpy()[~night, 0] > 0).all()


# -- the step cache ----------------------------------------------------------

class _EagerCapture:
    """CapturedStep's stand-in on the CPU: records each capture and runs
    the step eagerly."""

    made = []   # the captured steps' column counts

    def __init__(self, fn, inputs, *, pool=None, label="step", times=None):
        self.fn = fn
        first = inputs[0]
        _EagerCapture.made.append(first["t_lev"].shape[0]
                                  if isinstance(first, dict) else None)

    def __call__(self, inputs):
        return self.fn(inputs)


def _stub_capture(monkeypatch, pool="pool"):
    """Graphs on the CPU: every step goes through the cache, and a
    capture is an _EagerCapture."""
    monkeypatch.setattr(graphs, "CapturedStep", _EagerCapture)
    monkeypatch.setattr(graphs.StepCache, "eager",
                        staticmethod(lambda inputs: False))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: pool)
    _EagerCapture.made = []


def test_one_cache_entry_per_key_and_bucket(drivers, monkeypatch):
    _, driver, jatm = drivers
    driver = RadiationDriver(driver.lw_gas, driver.sw_gas, driver.solar)
    _stub_capture(monkeypatch)
    entries = driver._step_cache.entries

    def run(n_lit, **kw):
        """Two runs: a key's first call is its eager warm-up, the second
        captures it."""
        atm = atmosphere_from_jax(_lit(jatm, n_lit))
        driver.run(atm, **kw)
        return driver.run(atm, **kw)

    # (n_lit, entries after): lit 3 -> lit bucket 4 + night bucket 8;
    # lit 2 -> a new lit bucket 2; lit 4 -> lit 4 again, night bucket 4;
    # lit 3 again and lit 1 -> night bucket 8 again, lit bucket 1 new;
    # all lit and over a half -> the full batch with SW, once.
    for n_lit, n_entries in ((3, 2), (2, 3), (4, 4), (3, 4), (1, 5),
                             (8, 6), (5, 6), (0, 6)):
        res = run(n_lit).tiers["csaf"]
        assert len(entries) == n_entries, n_lit
        assert np.isfinite(res["rlu"].numpy()).all()
    assert len(_EagerCapture.made) == 6
    assert driver._step_cache.pool == "pool"
    # Another key: the streamed step, and spectral output.
    run(8, spectral_chunks=2)
    run(8, integrated=False)
    assert len(entries) == 8
    # A column_chunk tail is a second shape, so a second graph.
    run(8, column_chunk=5)
    assert len(entries) == 10
    assert sorted(set(_EagerCapture.made)) == [1, 2, 3, 4, 5, 8]
    # clear_cache drops the graphs, and each key warms up again.
    driver.clear_cache()
    assert not entries and not driver._step_cache.seen
    driver.run(atmosphere_from_jax(_lit(jatm, 3)))
    assert not entries


def test_a_run_called_once_holds_no_graph(drivers, monkeypatch):
    _, driver, jatm = drivers
    driver = RadiationDriver(driver.lw_gas, driver.sw_gas, driver.solar)
    _stub_capture(monkeypatch)
    res = driver.run(atmosphere_from_jax(_lit(jatm, 3))).tiers["csaf"]
    assert np.isfinite(res["rlu"].numpy()).all()
    # The lit and the night bucket ran their eager warm-up, nothing more.
    assert len(driver._step_cache.seen) == 2
    assert not driver._step_cache.entries and not _EagerCapture.made
    assert driver._step_cache.pool is None


def _oom(*_, **__):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")


@pytest.mark.parametrize("where", ["warm-up", "capture"])
def test_out_of_memory_drops_the_graphs_and_runs_again(where, monkeypatch):
    _stub_capture(monkeypatch)
    cache = graphs.StepCache()
    x, y = torch.arange(3.0), torch.arange(5.0)

    def step(inputs):
        return (inputs[0] * 2.0,)

    for _ in range(2):                                   # warm-up, capture
        cache(("a",), step, (x,))
    assert len(cache.entries) == 1
    fails = [True]               # the first call of `failing` runs out
    if where == "capture":
        cache(("b",), step, (y,))                        # b's warm-up

        def failing(fn, inputs, **kw):
            if fails and fails.pop():
                raise graphs.CaptureError("capture failed",
                                          torch.cuda.OutOfMemoryError("oom"))
            return _EagerCapture(fn, inputs, **kw)

        monkeypatch.setattr(graphs, "CapturedStep", failing)
        out = cache(("b",), step, (y,))                  # b's capture
    else:
        def failing(inputs):
            if fails and fails.pop():
                _oom()
            return step(inputs)

        out = cache(("b",), failing, (y,))               # b's warm-up
    assert not fails and torch.equal(out[0], y * 2.0)
    # a's graph went; b was captured at its second try, or warmed up.
    assert list(cache.entries) == ([("b", graphs.signature((y,)))]
                                   if where == "capture" else [])
    # Without graphs to drop, out of memory is raised, as is any other
    # error.
    cache.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache(("c",), _oom, (x,))
    for _ in range(2):
        cache(("a",), step, (x,))
    with pytest.raises(ValueError):
        cache(("d",), lambda inputs: float("x"), (x,))
    assert len(cache.entries) == 1


def test_step_cache_counts_each_call(monkeypatch):
    """A key's first, second and third calls: eager / captures / replays /
    dropped 1/0/0/0, 1/1/1/0, 1/1/2/0, each call under its span; then an
    out-of-memory warm-up drops the one graph; eager steps count too."""
    from torch.profiler import ProfilerActivity, profile

    from grtcode_tpu_torch.utils import metrics

    _stub_capture(monkeypatch)
    cache = graphs.StepCache()
    x = torch.arange(3.0)

    def step(inputs):
        return (inputs[0] * 2.0,)

    spans = {}
    for want in ((1, 0, 0, 0), (1, 1, 1, 0), (1, 1, 2, 0)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cache(("a",), step, (x,))
        got = cache.stats()
        assert tuple(got[k] for k in ("eager", "captures", "replays",
                                      "dropped")) == want
        assert (got["timed"], got["untimed"], got["layer_ms"]) == (0, 0, {})
        spans[want] = sorted(e.name for e in prof.events()
                             if e.name in metrics.SPANS)
    assert list(spans.values()) == [
        [metrics.STEP_EAGER], [metrics.STEP_CAPTURE, metrics.STEP_REPLAY],
        [metrics.STEP_REPLAY]]
    fails = [True]

    def failing(inputs):
        if fails and fails.pop():
            _oom()
        return step(inputs)

    cache(("b",), failing, (x,))         # out of memory, drops a's graph
    assert cache.counts == {"eager": 2, "captures": 1, "replays": 2,
                            "dropped": 1}
    assert not cache.entries
    monkeypatch.setattr(graphs.StepCache, "eager",
                        staticmethod(lambda inputs: True))
    cache(("a",), step, (x,))
    assert cache.counts["eager"] == 3 and not cache.entries


@pytest.mark.parametrize("conf", [None, "expandable_segments:False",
                                  "max_split_size_mb:64"])
def test_first_capture_sets_expandable_segments(conf, monkeypatch):
    _stub_capture(monkeypatch)
    set_to = []
    monkeypatch.setattr(torch.cuda.memory, "_set_allocator_settings",
                        set_to.append)
    monkeypatch.setattr(graphs, "_allocator_set", False)
    monkeypatch.delenv("PYTORCH_ALLOC_CONF", raising=False)
    if conf is None:
        monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    else:
        monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    cache = graphs.StepCache()
    x = torch.arange(3.0)
    for i in range(3):                        # warm-up, capture, replay
        cache(("a",), lambda inputs: (inputs[0] + 1.0,), (x,))
        cache(("b",), lambda inputs: (inputs[0] + 1.0,), (x,))
        assert set_to == ([] if i == 0 or conf == "expandable_segments:False"
                          else ["expandable_segments:True"])


def test_replay_adds_every_registered_dispatchers_launches():
    from grtcode_tpu_torch.gas_optics import bins_kernel as bk
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    assert vk.accumulate_voigt in graphs._counted
    assert bk.accumulate_bins_kernel in graphs._counted
    assert vk.voigt_line_sample_reference not in graphs._counted

    @graphs.count_launches
    def dispatcher():
        dispatcher.launches += 1

    try:
        assert dispatcher.launches == 0
        # A replay of a captured step that holds 3 of its launches.
        entry = graphs.CapturedStep.__new__(graphs.CapturedStep)
        entry.label, entry.signature = "step", graphs.signature(())
        entry._inputs, entry.static_outputs = [], ()
        entry.launches = {dispatcher: 3}
        entry.graph = type("G", (), {"replay": lambda self: None})()
        for i in range(2):
            entry(())
            assert dispatcher.launches == 3 * (i + 1)
    finally:
        graphs._counted.remove(dispatcher)


def test_public_functions_take_array_likes():
    from grtcode_tpu_torch.clouds.stochastic import cloudiness
    from grtcode_tpu_torch.gas_optics.bins import interpolate_bins
    from grtcode_tpu_torch.utils import prng

    keys = prng.split(prng.prng_key(3, "cpu"), 4)
    overlap = np.linspace(0.2, 0.8, 5)
    assert torch.equal(cloudiness(keys, overlap, 6),
                       cloudiness(keys, torch.as_tensor(overlap), 6))
    rng = np.random.default_rng(0)
    bins_tau = torch.as_tensor(rng.random((2, 3, 3)), dtype=torch.float32)
    bin_l = np.array([0, 4, 8])
    bin_w_rel = np.array([[0.0, 2.0, 4.0], [4.0, 6.0, 8.0],
                          [8.0, 10.0, 12.0]])
    kw = dict(ppb=4, last_ppb=4, do_interp=True, do_last_interp=True,
              num_wpoints=12)
    want = interpolate_bins(bins_tau, torch.as_tensor(bin_l),
                            torch.as_tensor(bin_w_rel), **kw,
                            tau=torch.zeros(2, 12))
    got = interpolate_bins(bins_tau, bin_l, bin_w_rel, **kw,
                           tau=torch.zeros(2, 12))
    assert want.abs().sum() > 0
    assert torch.equal(got, want)


def test_cached_step_equals_eager_step(drivers, monkeypatch):
    _, driver, jatm = drivers
    atm = atmosphere_from_jax(_lit(jatm, 3))
    want = driver.run(atm).tiers["csaf"]
    cached = RadiationDriver(driver.lw_gas, driver.sw_gas, driver.solar)
    _stub_capture(monkeypatch, pool=None)
    for _ in range(3):                  # warm-up, capture, replay
        got = cached.run(atm).tiers["csaf"]
        for var in FLUXES:
            assert torch.equal(got[var], want[var]), var


# -- device constants built once ---------------------------------------------

def _path(name):
    """(driver, atmosphere, run kwargs) of a path a step captures."""
    if name == "allsky":
        jdriver, jatm = allsky_model()
        return allsky_port(jdriver), atmosphere_from_jax(jatm), {}
    _, port, jatm = _model("wavenumber_sweep" if name == "streamed_bins"
                           else "line_sample")
    atm = atmosphere_from_jax(jatm)
    if name == "disort":
        return RadiationDriver(*port, sw_solver="disort",
                               disort_streams=8), atm, {}
    kw = dict(spectral_chunks=3) if name == "streamed_bins" else {}
    return RadiationDriver(*port), atm, kw


@pytest.mark.parametrize("path", ["line_sample", "streamed_bins", "allsky",
                                  "disort"])
def test_second_step_copies_nothing_from_the_host(path, monkeypatch):
    driver, atm, kw = _path(path)
    driver.run(atm, **kw)                    # the warm step
    made = []
    body = RadiationDriver._step_body
    real_tensor, real_as_tensor = torch.tensor, torch.as_tensor

    def counting(real):
        def wrapped(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                made.append((real.__name__, repr(data)[:60]))
            return real(data, *a, **k)
        return wrapped

    def watched(self, *a, **k):
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", counting(real_tensor))
            m.setattr(torch, "as_tensor", counting(real_as_tensor))
            return body(self, *a, **k)

    monkeypatch.setattr(RadiationDriver, "_step_body", watched)
    res = driver.run(atm, **kw)
    assert made == []
    assert np.isfinite(res.tiers["csaf"]["rlu"].numpy()).all()


# -- the limits check --------------------------------------------------------

def test_limits_check_raises_before_the_step(drivers, monkeypatch):
    _, driver, jatm = drivers
    hot = atmosphere_from_jax(dataclasses.replace(
        jatm, level_temperature=jatm.level_temperature + 300.0))
    message = "beyond the line_sample tables' limits"
    col, _ = driver._inputs(hot, np.arange(B))
    with pytest.raises(ValueError, match=message):
        driver.lw_gas.optical_depth(col["p_lev"], col["t_lev"],
                                    col["vmr_lw"])
    with pytest.raises(ValueError, match='method="scatter" computes'):
        driver.lw_gas.check_limits(col["p_lev"], col["t_lev"])

    def no_work(*a, **k):
        raise AssertionError("the step ran before the limits check")

    monkeypatch.setattr(RadiationDriver, "_step_body", no_work)
    with pytest.raises(ValueError, match=message):
        driver.run(hot)
    # Inside the limits the check passes and the step runs.
    with pytest.raises(AssertionError, match="before the limits check"):
        driver.run(atmosphere_from_jax(jatm))


# -- the eager switch --------------------------------------------------------

def test_disable_jit_and_debug_mode_run_eagerly():
    x = torch.zeros(2, device="cpu")
    assert not debug.jit_disabled()
    with debug.disable_jit():
        assert debug.jit_disabled()
        with debug.disable_jit():
            assert debug.jit_disabled()
        assert debug.jit_disabled()
    assert not debug.jit_disabled()
    with debug.debug_mode():
        assert debug.jit_disabled()
    assert not debug.jit_disabled()
    # On the CPU a step is always eager.
    assert graphs.StepCache.eager((x,))


def test_device_constant_is_built_once():
    a = graphs.device_constant(0.1, "cpu")
    assert graphs.device_constant(0.1, torch.device("cpu")) is a
    assert a.dtype == torch.float32 and float(a) == np.float32(0.1)
    t = graphs.device_constant((1.0, 2.5), "cpu", torch.float64)
    assert t.dtype == torch.float64 and t.tolist() == [1.0, 2.5]
