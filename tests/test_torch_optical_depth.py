"""The port's scatter method == the JAX package's, and K1's paths == it.

* ``optical_depth.accumulate_line_sample`` against JAX's on the same
  prepared lines (rtol 1e-6 / atol 1e-12): the full grid, a ragged line
  count, a block with ``start`` and ``num_global``, a nonzero ``tau0``, a
  block past the grid end and lines centred off the grid.  Not bit for
  bit: ``voigt_line_shape`` differs from XLA's in the last bits
  (tests/test_torch_voigt.py holds it at 2e-6);
* ``GasOptics(method="scatter")`` against JAX's on tests/test_tiled.py's
  case, full grid and blocks, also at T + 300 K and p x 2, where the
  line_sample tables refuse the rows and name ``method="scatter"``;
* the port's "tiled" (K1's plain version on the CPU) against its "scatter"
  at 1e-6, full grid and three blocks (tests/test_tiled.py's
  counterparts); both against the reference-C golden
  tests/data/gasoptics_golden.txt at rtol 5e-4
  (tests/test_gasoptics_pipeline.py); both bin methods within 2 % of
  scatter in each layer's integrated tau (tests/test_bins.py:79);
* ``convert.gas_optics_from_jax`` of a JAX scatter gas, a driver step
  with both bands on scatter against JAX's driver at 1e-4, and the CPU
  sum's independence of the line chunk and the samples per step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtcode_tpu import constants as jconst
from grtcode_tpu.framework.driver import RadiationDriver as JDriver
from grtcode_tpu.gas_optics import optical_depth as jod
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.spectral import SpectralGrid as JGrid
from grtcode_tpu_torch.convert import (atmosphere_from_jax,
                                       gas_optics_from_jax, solar_from_jax)
from grtcode_tpu_torch.framework.driver import RadiationDriver
from grtcode_tpu_torch.gas_optics import lines
from grtcode_tpu_torch.gas_optics import optical_depth as od
from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.spectral import SpectralGrid
from grtcode_tpu_torch.utils import curtis_godson as cg
from test_gasoptics_pipeline import NUM_LEVELS, _lcg_params  # noqa: E402
from test_torch_driver import _mini_model  # noqa: E402

RTOL, ATOL = 1e-6, 1e-12          # tests/test_tiled.py
GOLDEN_RTOL = 5e-4                # tests/test_gasoptics_pipeline.py:87
FLUX_TOL = 1e-4                   # tests/test_driver_golden.py:40
GRID = (100.0, 400.0, 0.1)        # 3,001 points; the tile is 64


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _catalog(fn, n_lines=300, seed=3):
    """tests/test_tiled.py's lines: 80-420 cm-1, so some centres lie off
    the 100-400 grid."""
    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(80.0, 420.0, n_lines))
    return fn(1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
              yair=rng.uniform(0.02, 0.1, n_lines),
              yself=rng.uniform(0.05, 0.4, n_lines),
              en=rng.uniform(0.0, 2000.0, n_lines),
              n=rng.uniform(0.4, 0.8, n_lines),
              d=rng.uniform(-0.02, 0.02, n_lines))


def _atmos(hot=False):
    """tests/test_tiled.py's column; ``hot``: T + 300 K and p x 2 (layers
    up to ~580 K and ~1.9 atm)."""
    rng = np.random.default_rng(11)
    nlev = 9
    p = np.linspace(0.01, 1013.0, nlev)
    t = np.linspace(215.0, 288.0, nlev) + rng.uniform(-3, 3, nlev)
    x = rng.uniform(1e-5, 1e-2, nlev)
    if hot:
        p, t = p * 2.0, t + 300.0
    return tuple(np.asarray(a, np.float32) for a in (p, t, x))


def _jax_tau(gas, atmos, **block):
    p, t, x = (jnp.asarray(a) for a in atmos)
    return np.asarray(gas.optical_depth(p, t, {1: x}, **block))


def _port_tau(gas, atmos, **block):
    p, t, x = atmos
    return gas.optical_depth(p, t, {1: x}, **block).numpy()


def _port_gas(method, **kw):
    gas = GasOptics(SpectralGrid(*GRID), line_chunk=64, method=method,
                    device="cpu", **kw)
    gas.add_catalog(_catalog(synthetic_catalog))
    return gas


@pytest.fixture(scope="module")
def jax_scatter():
    gas = JGasOptics(JGrid(*GRID), line_chunk=64, method="scatter",
                     tile_lchunk=32)
    gas.add_catalog(_catalog(jcatalog))
    return gas


@pytest.fixture(scope="module")
def port_gases():
    return {m: _port_gas(m) for m in ("scatter", "tiled")}


# -- accumulate_line_sample ------------------------------------------------

@pytest.fixture(scope="module")
def prepared():
    """The unpadded catalog (300 lines) prepared by the port at test_tiled's
    8 layers, as numpy arrays both packages take."""
    gas = _port_gas("scatter")
    p, t, x = (torch.as_tensor(a) for a in _atmos())
    p2 = p[None] * jconst.MB_TO_ATM
    n2d = cg.number_densities(p2)
    pavg, tavg = cg.layer_pressures_temperatures(p2, t[None])
    psavg, ns = cg.partial_pressures_and_densities(p2, x[None], n2d)
    prep = lines.prepare(gas._raw_bounds[1], gas.grid, pavg[0], tavg[0],
                         psavg[0], tips=gas.tips)
    arrays = tuple(a.numpy() for a in (
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns[0]))
    return arrays, gas.grid.n, gas._fsteps


# name -> (line selection, start, block width or None for the grid,
#          chunk, nonzero tau0)
CASES = {
    "full_grid": (slice(None), 0, None, 100, False),
    "ragged_chunks": (slice(None), 0, None, 64, False),
    "block": (slice(None), 512, 512, 64, False),
    "tau0": (slice(None), 0, None, 64, True),
    "past_grid_end": (slice(None), 2944, 128, 64, False),
    "off_grid_centres": ("off", 0, None, 64, False),
}


@pytest.mark.parametrize("case", CASES)
def test_accumulate_line_sample_matches_jax(prepared, case):
    arrays, n, fsteps = prepared
    sel, start, nw, chunk, with_tau0 = CASES[case]
    cidx = arrays[0]
    assert (cidx < 0).any() and (cidx >= n).any()
    if sel == "off":
        sel = ((cidx < 0) | (cidx >= n)).all(axis=0)
        assert 10 < sel.sum() < cidx.shape[1]
    arrays = tuple(a[:, sel] for a in arrays[:5]) + arrays[5:]
    nw = n if nw is None else nw
    kw = dict(num_wpoints=nw, dw=GRID[2], fsteps=fsteps, chunk=chunk,
              start=start, num_global=n)
    tau0 = None
    if with_tau0:
        tau0 = np.random.default_rng(1).uniform(
            0.0, 50.0, (cidx.shape[0], nw)).astype(np.float32)
    if case in ("full_grid", "ragged_chunks"):
        assert (arrays[0].shape[1] % chunk == 0) == (case == "full_grid")
    want = np.asarray(jod.accumulate_line_sample(
        *(jnp.asarray(a) for a in arrays), **kw,
        tau0=None if tau0 is None else jnp.asarray(tau0)))
    tau0_t = None if tau0 is None else torch.as_tensor(tau0).clone()
    got = od.accumulate_line_sample(
        *(torch.as_tensor(a) for a in arrays), **kw, tau0=tau0_t)
    assert tau0_t is None or got is tau0_t          # added in place
    assert got.shape == want.shape == (cidx.shape[0], nw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if case == "off_grid_centres":
        assert not want.any()            # kernels.c:433: no valid centre
    else:
        assert want.max() > 1.0
    if case == "past_grid_end":
        assert want[:, n - start:].max() > 0   # lines reach past the end


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_sum_does_not_depend_on_chunking(prepared, monkeypatch, dtype):
    """On the CPU index_add_ adds in line order, so neither the chunk nor
    the samples per step change a bit of the result, in f32 or with a
    float64 tau0, which sums the same samples in float64."""
    arrays, n, fsteps = prepared
    args = tuple(torch.as_tensor(a) for a in arrays)
    kw = dict(num_wpoints=n, dw=GRID[2], fsteps=fsteps)
    rows, width = args[0].shape[0], 2 * fsteps + 1

    def tau(chunk):
        return od.accumulate_line_sample(
            *args, **kw, chunk=chunk,
            tau0=torch.zeros((rows, n), dtype=dtype))

    want = tau(1024)
    assert want.dtype == dtype
    for chunk, lines_per_step in ((64, 1), (100, 7), (1024, 300), (17, 5)):
        monkeypatch.setattr(od, "SAMPLES_PER_STEP",
                            rows * width * lines_per_step)
        assert od.lines_per_step(rows, fsteps, chunk) == min(
            chunk, lines_per_step)
        assert torch.equal(tau(chunk), want), (chunk, lines_per_step)
    if dtype == torch.float64:
        single = od.accumulate_line_sample(*args, **kw)
        np.testing.assert_allclose(single.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


# -- GasOptics(method="scatter") ------------------------------------------

@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("block", [None, (512, 512), (2944, 128)])
def test_scatter_gas_optics_matches_jax(jax_scatter, port_gases, hot,
                                        block):
    atmos = _atmos(hot)
    kw = {} if block is None else dict(block_start=block[0],
                                       block_size=block[1])
    want = _jax_tau(jax_scatter, atmos, **kw)
    got = _port_tau(port_gases["scatter"], atmos, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all() and got.max() > 1.0


def test_line_sample_refuses_hot_rows_and_names_scatter(port_gases):
    p, t, x = _atmos(hot=True)
    with pytest.raises(ValueError, match='method="scatter"'):
        port_gases["tiled"].optical_depth(p, t, {1: x})
    # JAX's scatter takes these rows (layers up to ~580 K and ~1.9 atm).
    assert float(t.max()) > 500.0
    assert float(p.max()) * jconst.MB_TO_ATM > 1.5


def test_tiled_matches_scatter_full_grid(port_gases):
    atmos = _atmos()
    np.testing.assert_allclose(_port_tau(port_gases["tiled"], atmos),
                               _port_tau(port_gases["scatter"], atmos),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_tiled_matches_scatter_blocks(port_gases, b):
    """tests/test_tiled.py's three tile-aligned blocks; the last reaches
    past the grid end."""
    atmos = _atmos()
    gas_ti = port_gases["tiled"]
    full = _port_tau(port_gases["scatter"], atmos)
    n, tile = gas_ti.grid.n, gas_ti.tile
    block = -(-(-(-n // 3)) // tile) * tile
    got = _port_tau(gas_ti, atmos, block_start=b * block, block_size=block)
    m = min(block, n - b * block)
    np.testing.assert_allclose(got[:, :m], full[:, b * block:b * block + m],
                               rtol=RTOL, atol=ATOL)


def test_scatter_block_quantum_and_state_match_jax(jax_scatter, port_gases):
    """Registration builds JAX's state for scatter too; the block quantum
    stays the tile."""
    port = port_gases["scatter"]
    assert port.block_quantum == jax_scatter.block_quantum == port.tile
    assert port._fsteps == jax_scatter._fsteps
    for f in ("c0", "frac0", "vnn", "snn"):
        assert np.array_equal(getattr(port.molecules[1], f),
                              np.asarray(getattr(jax_scatter.molecules[1],
                                                 f)))
    assert port.near_steps == jax_scatter.near_steps
    assert np.array_equal(port.chunk_ranges[1].lo,
                          jax_scatter.chunk_ranges[1].lo)


def test_converted_scatter_gas_gives_equal_tau(jax_scatter, port_gases):
    conv = gas_optics_from_jax(jax_scatter, "cpu")
    assert conv.method == "scatter"
    for hot in (False, True):
        atmos = _atmos(hot)
        assert np.array_equal(_port_tau(conv, atmos),
                              _port_tau(port_gases["scatter"], atmos))


# -- the reference-C golden and the bin methods ----------------------------

def _golden_gas(method, d_zero=False):
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    gas = GasOptics(SpectralGrid(*GRID), line_chunk=64, method=method,
                    device="cpu")
    gas.add_catalog(synthetic_catalog(
        1, v0, s0, yair=yair, yself=yself, en=en, n=nexp,
        d=np.zeros_like(d) if d_zero else d, iso=iso))
    i = np.arange(NUM_LEVELS)
    p_atm = 1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)
    t = 215.0 + (288.0 - 215.0) * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    return gas.optical_depth(
        np.asarray(p_atm / jconst.MB_TO_ATM, np.float32),
        np.asarray(t, np.float32), {1: np.asarray(x, np.float32)}).numpy()


@pytest.mark.parametrize("method", ["tiled", "scatter"])
def test_matches_reference_gasoptics_golden(method):
    golden = np.loadtxt("tests/data/gasoptics_golden.txt").reshape(
        NUM_LEVELS - 1, 3001)
    np.testing.assert_allclose(_golden_gas(method), golden,
                               rtol=GOLDEN_RTOL, atol=ATOL)
    assert golden.max() > 100.0 and (golden > 0).sum() > 15000


@pytest.mark.parametrize("method", ["wavenumber_sweep", "line_sweep"])
def test_bin_methods_approximate_scatter(method):
    """tests/test_bins.py:79: integrated tau per layer within 2 %."""
    exact = _golden_gas("scatter", d_zero=True)
    approx = _golden_gas(method, d_zero=True)
    num = np.abs(approx.sum(-1) - exact.sum(-1))
    assert (num <= 0.02 * exact.sum(-1)).all()
    assert exact.sum() > 0


# -- the driver --------------------------------------------------------------

def _worst_rel(ours, ref):
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


def test_driver_with_scatter_bands_matches_jax():
    """tests/test_torch_driver.py's two-band model (LW 100-400 cm-1 at 0.1,
    two molecules; SW 1,000-9,000 at 4.0, one; 2 columns of 8 layers) with
    both bands on scatter, JAX's gases converted, against JAX's driver."""
    (jlw, jsw, jsol), _, jatm = _mini_model("scatter")
    jsw.method = "scatter"             # registered for line_sample
    port = RadiationDriver(gas_optics_from_jax(jlw, "cpu"),
                           gas_optics_from_jax(jsw, "cpu"),
                           solar_from_jax(jsol, "cpu"))
    assert port.lw_gas.method == port.sw_gas.method == "scatter"
    got = port.run(atmosphere_from_jax(jatm)).tiers["csaf"]
    want = JDriver(jlw, jsw, jsol).run(jatm, integrated=True).tiers["csaf"]
    for var in ("rlu", "rld", "rsu", "rsd"):
        g, w = got[var].numpy(), np.asarray(want[var])
        assert g.shape == w.shape == (2, 9) and np.isfinite(g).all()
        assert _worst_rel(g, w) < FLUX_TOL, var
    assert float(got["rlu"][0, 0]) > 0 and float(got["rsd"][0, 0]) > 0
