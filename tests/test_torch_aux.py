"""The port's auxiliary modules, its module tree and the all-sky cell's
ice table.

* ``utils.metrics``: phase timers and points/s (``grid_points``), a
  ``profiler_trace`` written as a Chrome trace, None a no-op;
* ``utils.debug``: ``validate_atmosphere`` raises where the JAX package's
  does, with its message (the cases of tests/test_aux.py:51-75);
  ``debug_mode`` raises FloatingPointError at the op that first produces
  a NaN or an Inf, also at a kernel dispatcher's output, and nowhere on
  a clean driver step; it flags the DISORT NaN of the old synthetic ice
  table; ``checked`` returns (error, value) and ``error.throw()``
  re-raises;
* ``utils.verbosity``: levels, the bounded error buffer with file:line
  context and ``errstr``, as tests/test_aux.py holds the JAX one;
* ``utils.segments``: the manifest's resume plan, as in JAX;
* every module of ``grtcode_tpu/`` has a counterpart in
  ``grtcode_tpu_torch/``;
* the all-sky cell's ice table is physical: 0 <= ssa <= 1 and |g| < 1 at
  every band and every radius the cell can evaluate, where the old
  synthetic table was not.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from grtcode_tpu.framework import Atmosphere as JAtmosphere
from grtcode_tpu.utils import debug as jdebug
from grtcode_tpu_torch import examples
from grtcode_tpu_torch.framework.atmosphere import Atmosphere
from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
from grtcode_tpu_torch.utils import debug, metrics, verbosity as vb
from grtcode_tpu_torch.utils.segments import SegmentManifest, run_segments

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def test_metrics_phase_and_throughput():
    m = metrics.Metrics()
    pts = metrics.grid_points(4, 10, 1000)
    assert pts == 40000
    with m.phase("gas_optics", points=pts) as box:
        box["result"] = {"rlu": torch.ones(4, 10) * 2.0}
    with m.phase("gas_optics", points=pts, sync=torch.zeros(3)):
        pass
    st = m.phases["gas_optics"]
    assert st.calls == 2 and st.points == 2 * pts and st.seconds > 0
    assert m.points_per_second("gas_optics") == st.points / st.seconds
    assert "gas_optics" in m.report()


def test_profiler_trace(tmp_path):
    with metrics.profiler_trace(None):
        pass
    with metrics.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def _tiny(cls, **over):
    base = dict(
        level_pressure=np.linspace(1.0, 1000.0, 11)[None],
        level_temperature=np.linspace(210.0, 290.0, 11)[None],
        layer_temperature=np.linspace(212.0, 288.0, 10)[None],
        surface_temperature=[290.0],
        ppmv={1: np.full((1, 11), 5000.0)})
    base.update(over)
    return cls(**base)


CLOUDY = dict(cloud_fraction=np.full((1, 10), 1.5),
              liquid_water_content=np.zeros((1, 10)),
              ice_water_content=np.zeros((1, 10)),
              layer_thickness=np.full((1, 10), 100.0), clear=False)


@pytest.mark.parametrize("over,match", [
    ({}, None),
    (dict(level_temperature=np.full((1, 11), 600.0)), "temperature"),
    (dict(level_pressure=np.linspace(1.0, 1000.0, 250)[None],
          level_temperature=np.full((1, 250), 250.0),
          layer_temperature=np.full((1, 249), 250.0),
          ppmv={1: np.full((1, 250), 5000.0)}), "layers"),
    (CLOUDY, "cloud_fraction"),
    (dict(cos_zenith=np.array([1.5])), "cos_zenith"),
    (dict(ppmv={1: np.full((1, 11), -1.0)}), "ppmv"),
], ids=["good", "temperature", "layers", "cloud_fraction", "cos_zenith",
        "ppmv"])
def test_validate_atmosphere_matches_jax(over, match):
    if match is None:
        debug.validate_atmosphere(_tiny(Atmosphere, **over))
        jdebug.validate_atmosphere(_tiny(JAtmosphere, **over))
        return
    with pytest.raises(ValueError, match=match) as got:
        debug.validate_atmosphere(_tiny(Atmosphere, **over))
    with pytest.raises(ValueError) as want:
        jdebug.validate_atmosphere(_tiny(JAtmosphere, **over))
    assert str(got.value) == str(want.value)


def test_debug_mode_traps_at_the_op():
    x = torch.tensor([-1.0, 4.0])
    with pytest.raises(FloatingPointError, match="NaN produced by log"):
        with debug.debug_mode():
            torch.log(x)
    with pytest.raises(FloatingPointError, match="Inf produced by"):
        with debug.debug_mode():
            torch.tensor([1.0]) / torch.tensor([0.0])
    with debug.debug_mode(infs=False):
        torch.tensor([1.0]) / torch.tensor([0.0])
    # Restored: NaNs flow silently again outside the context.
    assert torch.isnan(torch.log(x)).any()


def test_debug_mode_checks_kernel_outputs():
    """The ctypes kernel launches bypass torch ops: their dispatchers
    check the output tensor instead (here the CPU plain version's)."""
    tau = torch.tensor([[1.0, float("nan")]])
    debug.check_kernel_output("voigt_line_sample", tau)   # off: no-op
    with pytest.raises(FloatingPointError, match="voigt_line_sample"):
        with debug.debug_mode():
            debug.check_kernel_output("voigt_line_sample", tau)


def test_debug_mode_passes_a_clean_step_and_traps_a_nan_temperature():
    """The dryrun's three-tier case runs clean under debug_mode; one NaN
    level temperature traps."""
    import dataclasses
    from grtcode_tpu_torch.parallel.dryrun import build_driver_case

    driver, atm = build_driver_case(B=2)
    before = vk.voigt_line_sample_reference.launches
    with debug.debug_mode():
        res = driver.run(atm)
    assert vk.voigt_line_sample_reference.launches > before
    assert all(torch.isfinite(v).all() for fx in res.tiers.values()
               for v in fx.values())
    t = atm.level_temperature.copy()
    t[1, 3] = np.nan
    with pytest.raises(FloatingPointError):
        with debug.debug_mode():
            driver.run(dataclasses.replace(atm, level_temperature=t))


def _cirrus_optics(table):
    """(ssa, g, tau) of ``table`` on the smoke all-sky cell's first
    column, with its cirrus and its layer thicknesses."""
    from grtcode_tpu_torch.clouds.lib import ice_particle_size

    _, atm = examples.allsky_like(smoke=True, device="cpu")
    f32 = torch.float32
    r = ice_particle_size(torch.as_tensor(atm.layer_temperature[0],
                                          dtype=f32)) / 2.0
    ext, ssa, g = table.evaluate(
        torch.as_tensor(atm.ice_water_content[0], dtype=f32), r)
    thick = torch.as_tensor(atm.layer_thickness[0], dtype=f32)[:, None]
    return ssa, g, ext * thick + 0.01


def test_debug_mode_flags_disort_on_the_old_ice_table():
    """The NaN DISORT gave on the all-sky cell with the old synthetic ice
    table (ssa up to 1.86 and g up to 2.58 at the cell's cirrus radii) is
    trapped; the cell's physical table runs clean."""
    from grtcode_tpu_torch.clouds.pade import synthetic_pade_table
    from grtcode_tpu_torch.solvers.disort import disort_shortwave

    old = synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=1,
                               device="cpu")
    for table, traps in ((old, True),
                         (examples.ice_pade_table(device="cpu"), False)):
        ssa, g, tau = _cirrus_optics(table)
        nw = ssa.shape[-1]
        args = (tau, ssa, g, torch.tensor(0.5), torch.full((nw,), 0.1),
                torch.tensor(1361.0), torch.full((nw,), 1.0))
        up, _ = disort_shortwave(*args, nstr=4)
        assert bool(torch.isfinite(up).all()) != traps
        err, value = debug.checked(disort_shortwave)(*args, nstr=4)
        assert (err.get() is not None) == traps
        if traps:
            assert value is None
            with pytest.raises(FloatingPointError):
                err.throw()
        else:
            err.throw()
            assert torch.equal(value[0], up)


def test_checked_user_check():
    def f(x):
        debug.check(x > 0, "x must be positive")
        return torch.sqrt(x)

    err, val = debug.checked(f)(torch.tensor(4.0))
    err.throw()
    assert float(val) == 2.0
    err, val = debug.checked(f)(torch.tensor(-4.0))
    assert val is None and "positive" in err.get()
    with pytest.raises(debug.CheckError, match="positive"):
        err.throw()


def test_verbosity_levels_and_error_buffer(capsys):
    """utilities/src/verbosity.c:28-83 equivalents."""
    vb.clear_error_buffer()
    vb.set_verbosity(vb.GRTCODE_NONE)
    vb.log_info("hidden %d", 1)
    vb.log_warn("hidden")
    assert capsys.readouterr().err == ""
    vb.set_verbosity(vb.GRTCODE_WARN)
    vb.log_warn("warned")
    vb.log_info("hidden")
    assert "warned" in capsys.readouterr().err
    vb.set_verbosity(vb.GRTCODE_INFO)
    vb.log_info("shown %s", "x")
    assert "shown x" in capsys.readouterr().err
    vb.append_to_error_buffer("first failure")
    vb.append_to_error_buffer("second failure")
    s = vb.errstr()
    assert "first failure" in s and "second failure" in s
    assert "test_torch_aux.py" in s
    for _ in range(200):
        vb.append_to_error_buffer("x" * 100)
    assert len(vb.errstr()) <= 4096
    vb.clear_error_buffer()
    assert vb.errstr() == ""
    with pytest.raises(ValueError):
        vb.set_verbosity(7)
    vb.set_verbosity(vb.GRTCODE_NONE)


def test_segment_manifest_resume(tmp_path):
    man = SegmentManifest(str(tmp_path))
    segs = {f"lon{i}": {"x": i} for i in range(4)}
    ran = run_segments(man, segs, lambda sid, a: tmp_path / f"{sid}.nc")
    assert ran == list(segs) and man.pending(list(segs)) == []
    man.clear("lon2")
    assert run_segments(man, segs,
                        lambda sid, a: tmp_path / f"{sid}.nc") == ["lon2"]
    rec = man.record("lon2")
    assert rec["segment"] == "lon2" and rec["finished_at"] > 0


# JAX modules whose work the port does under another name: the two Pallas
# kernels' modules (their CUDA counterparts and dispatchers).
COVERED_BY = {
    "gas_optics/pallas_kernels.py": "gas_optics/voigt_kernel.py",
    "gas_optics/bins_pallas.py": "gas_optics/bins_kernel.py",
}


def test_every_jax_module_has_a_counterpart():
    jax_root, port_root = REPO / "grtcode_tpu", REPO / "grtcode_tpu_torch"
    modules = sorted(str(p.relative_to(jax_root))
                     for p in jax_root.rglob("*.py"))
    assert len(modules) > 50
    missing = [m for m in modules
               if not (port_root / COVERED_BY.get(m, m)).exists()]
    assert missing == []
    assert (port_root / "csrc" / "voigt_line_sample.cu").exists()
    assert (port_root / "csrc" / "voigt_bins.cu").exists()


def test_allsky_ice_table_is_physical():
    """Every band at every radius the cell can evaluate: the effective
    radius is half of one of the eight ice sizes (clouds/lib.py) and the
    table's regimes span 2-90 microns."""
    from grtcode_tpu_torch.clouds.lib import _ICE_SIZES
    from grtcode_tpu_torch.clouds.pade import synthetic_pade_table

    table = examples.ice_pade_table(device="cpu")
    radii = torch.cat([torch.tensor(_ICE_SIZES) / 2.0,
                       torch.linspace(2.0, 90.0, 2000)])
    ext, ssa, g = table.evaluate(torch.ones_like(radii), radii)
    assert ssa.shape == (radii.numel(), 16)
    assert float(ssa.min()) >= 0.0 and float(ssa.max()) <= 1.0
    assert float(g.abs().max()) < 1.0 and float(ext.min()) > 0.0
    # The cell uses it (and still the synthetic liquid table of seed 0).
    driver, _ = examples.allsky_like(smoke=True, device="cpu")
    ssa_cell, g_cell, _ = _cirrus_optics(table)
    assert float(ssa_cell.max()) <= 1.0 and float(g_cell.abs().max()) < 1.0
    old_ssa, old_g, _ = _cirrus_optics(
        synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=1,
                             device="cpu"))
    assert float(old_ssa.max()) > 1.0 and float(old_g.max()) > 1.0
    assert driver.cloud_optics is not None
