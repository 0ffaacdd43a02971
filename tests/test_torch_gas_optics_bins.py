"""The port's bin-method GasOptics == the JAX package's and the reference C.

* ``GasOptics(method="wavenumber_sweep" | "line_sweep")`` registers the
  JAX state (unpadded bound lines, bins, per-bin ranges) and its optical
  depth matches the JAX ``GasOptics`` with the jnp path
  (``pallas="off"``) and with the Pallas bin kernel in interpret mode, at
  rtol 3e-5 / atol 3e-6 x max (tests/test_bins_pallas.py:122-151), on the
  full band and on bin-group-aligned blocks, one of them past the grid
  end;
* the registered and the ``convert.py``-converted objects give the same
  tau;
* both methods match the reference-C bins golden
  (tests/data/bins_golden.txt) at rtol 2e-3 / atol 1e-7
  (tests/test_bins.py:53-60);
* a spectral block preps only the window of lines that its bins read
  (``BinRanges.window``): its optical depth, and the fluxes of
  ``RadiationDriver.run(spectral_chunks=S)``, are bit for bit those of
  the whole catalog's prep, on the first and the last block and on a
  block with no line centres; ``GasOptics.line_prep`` counts the lines
  prepped against the catalog lines once per step run.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtcode_tpu import constants as jconst
from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.spectral import SpectralGrid as JGrid
from grtcode_tpu_torch.convert import gas_optics_from_jax
from grtcode_tpu_torch.framework.atmosphere import Atmosphere
from grtcode_tpu_torch.framework.driver import RadiationDriver
from grtcode_tpu_torch.gas_optics import bins
from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.spectral import SpectralGrid
from test_gasoptics_pipeline import NUM_LEVELS, _lcg_params  # noqa: E402

HERE = os.path.dirname(__file__)
METHODS = ("wavenumber_sweep", "line_sweep")
# Against the JAX GasOptics (jnp path and interpret-mode bin kernel).
RTOL, ATOL = 3e-5, 3e-6
GRID = (100.0, 180.0, 0.1)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _catalog(fn):
    rng = np.random.default_rng(5)
    n = 120
    vnn = np.sort(rng.uniform(GRID[0] - 10.0, GRID[1] + 10.0, n))
    return fn(1, vnn, rng.uniform(1e-22, 1e-19, n),
              yair=rng.uniform(0.02, 0.1, n), yself=rng.uniform(0.05, 0.4, n),
              en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
              d=rng.uniform(-0.02, 0.02, n))


def _state():
    rng = np.random.default_rng(7)
    nlev, B = 7, 2
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-3, (B, nlev))
    return p, t, {1: x}


def _jax_tau(gas, state, **block):
    p, t, vmr = state
    f = jnp.float32
    return np.asarray(gas.optical_depth(
        jnp.asarray(p, f), jnp.asarray(t, f),
        {k: jnp.asarray(v, f) for k, v in vmr.items()}, **block))


def _port_tau(gas, state, **block):
    p, t, vmr = state
    return gas.optical_depth(p, t, vmr, **block).numpy()


@pytest.fixture(scope="module", params=METHODS)
def gases(request):
    method = request.param
    jax_gas = {}
    for pallas in ("off", "interpret"):
        g = JGasOptics(JGrid(*GRID), line_chunk=64, method=method,
                       pallas=pallas)
        g.add_catalog(_catalog(jcatalog))
        jax_gas[pallas] = g
    own = GasOptics(SpectralGrid(*GRID), line_chunk=64, method=method,
                    device="cpu")
    own.add_catalog(_catalog(synthetic_catalog))
    return method, jax_gas, own, gas_optics_from_jax(jax_gas["off"], "cpu")


def test_registration_builds_the_jax_bin_state(gases):
    _, jax_gas, own, conv = gases
    jg = jax_gas["interpret"]
    for port in (own, conv):
        assert port.block_quantum == jg.block_quantum == 11 * 8
        assert port.bins.n == jg.bins.n and port.bins.ppb == jg.bins.ppb
        for f in ("c0", "frac0", "vnn", "snn", "d"):
            assert np.array_equal(getattr(port._raw_bounds[1], f),
                                  np.asarray(getattr(jg._raw_bounds[1], f)))
        pr, jr = port._get_bin_ranges(1), jg._get_bin_ranges(1)
        for f in ("local_lo", "local_cnt", "rem_lo", "rem_cnt_l",
                  "rem_hi_start", "rem_cnt_r"):
            assert np.array_equal(getattr(pr, f), getattr(jr, f)), f


def test_optical_depth_matches_jax(gases):
    _, jax_gas, own, conv = gases
    state = _state()
    got = _port_tau(own, state)
    assert got.shape == (2, 6, SpectralGrid(*GRID).n)
    for pallas, jg in jax_gas.items():
        want = _jax_tau(jg, state)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max(),
                                   err_msg=pallas)
    assert np.array_equal(_port_tau(conv, state), got)
    assert np.isfinite(got).all() and got.max() > 0


@pytest.mark.parametrize("block", [0, 4, 9])
def test_block_matches_jax(gases, block):
    """Blocks of 88 points (8 bins of 11): the 10th reaches past the grid
    end (801 points, 73 bins)."""
    _, jax_gas, own, _ = gases
    state = _state()
    q = own.block_quantum
    kw = dict(block_start=block * q, block_size=q)
    got = _port_tau(own, state, **kw)
    n = min(q, SpectralGrid(*GRID).n - block * q)
    full = _jax_tau(jax_gas["off"], state)
    want = full[..., block * q:block * q + n]
    np.testing.assert_allclose(got[..., :n], want, rtol=RTOL,
                               atol=ATOL * np.abs(full).max())
    # Past the grid end the JAX kernel adds the short last bin's local
    # lines at its missing points, the port drops them: both carry weight
    # 0 in every flux integral.
    np.testing.assert_allclose(
        got[..., :n], _jax_tau(jax_gas["interpret"], state, **kw)[..., :n],
        rtol=RTOL, atol=ATOL * np.abs(full).max())


def test_block_must_be_whole_bin_groups(gases):
    own = gases[2]
    p, t, vmr = _state()
    with pytest.raises(ValueError, match="block_quantum"):
        own.optical_depth(p, t, vmr, block_start=0,
                          block_size=own.block_quantum + 11)
    with pytest.raises(ValueError, match="block_start"):
        own.optical_depth(p, t, vmr, block_start=own.bins.ppb,
                          block_size=own.block_quantum)


@pytest.fixture(scope="module")
def bins_golden():
    data = np.loadtxt(os.path.join(HERE, "data", "bins_golden.txt"))
    return dict(zip(METHODS, data.reshape(2, NUM_LEVELS - 1, 3001)))


@pytest.mark.parametrize("method", METHODS)
def test_matches_reference_bins_golden(bins_golden, method):
    """tests/test_bins.py's case: the harness's LCG line list with d = 0
    on 100-400 cm-1 at 0.1, 8 layers."""
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    gas = GasOptics(SpectralGrid(100.0, 400.0, 0.1), line_chunk=64,
                    method=method, device="cpu")
    gas.add_catalog(synthetic_catalog(1, v0, s0, yair=yair, yself=yself,
                                      en=en, n=nexp, d=np.zeros_like(d),
                                      iso=iso))
    i = np.arange(NUM_LEVELS)
    p_atm = 1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)
    t = 215.0 + (288.0 - 215.0) * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    tau = gas.optical_depth(p_atm / jconst.MB_TO_ATM, t, {1: x}).numpy()
    golden = bins_golden[method]
    np.testing.assert_allclose(tau, golden, rtol=2e-3, atol=1e-7)
    assert golden.max() > 100.0 and (golden > 0).sum() > 15000


# ---------------------------------------------------------------------------
# Line prep by spectral block
# ---------------------------------------------------------------------------

# 3,520 points in 320 bins of 11: S = 3 and S = 10 split the band into
# blocks of 1,232 and 352 points (123.2 and 35.2 cm-1).
WIDE = (100.0, 451.9, 0.1)
# No line centres here: S = 10's block 5, [276.0, 311.2) cm-1, holds none.
GAP = (262.0, 322.0)


def _wide_gas(method, n=600, gap=True, grid=WIDE, mols=(1, 2)):
    """A bin-method GasOptics on ``grid`` with ``n`` lines a molecule
    drawn uniformly over the band and 10 cm-1 beyond it."""
    gas = GasOptics(SpectralGrid(*grid), line_chunk=64, method=method,
                    device="cpu")
    for mol in mols:
        rng = np.random.default_rng(30 + mol)
        vnn = rng.uniform(grid[0] - 10.0, grid[1] + 10.0, n)
        if gap:
            vnn = vnn[(vnn < GAP[0]) | (vnn >= GAP[1])]
        vnn, k = np.sort(vnn), vnn.size
        gas.add_catalog(synthetic_catalog(
            mol, vnn, 10.0 ** rng.uniform(-22.0, -19.0, k),
            yair=rng.uniform(0.02, 0.1, k), yself=rng.uniform(0.05, 0.4, k),
            en=rng.uniform(0.0, 2000.0, k), n=rng.uniform(0.4, 0.8, k),
            d=rng.uniform(-0.02, 0.02, k)))
    return gas


def _whole_catalog(monkeypatch):
    """Every block preps the whole catalog with the band's ranges: the
    line prep as it was before blocks were windowed."""
    monkeypatch.setattr(
        GasOptics, "_line_window", lambda self, mol_id, start_bin, nbins: (
            0, self.molecules[mol_id].num_lines,
            self._get_bin_ranges(mol_id)))


def test_window_holds_every_range_the_block_reads():
    rng = np.random.default_rng(3)
    nb, L = 40, 640
    begin = np.sort(rng.integers(0, 500, (3, nb)), axis=1)
    cnt = rng.integers(0, 60, (3, nb))
    cnt[:, 10:20] = 0                      # bins 10-19 read no line
    ranges = bins.BinRanges(begin[0], cnt[0], begin[1], cnt[1], begin[2],
                            cnt[2], lmax_local=64, lmax_remote=64)
    bnd = ranges.bounds().astype(np.int64)
    for start_bin, nbins in ((0, nb), (4, 8), (12, 6), (30, 16)):
        lo, hi, shifted = ranges.window(start_bin, nbins, L)
        got = shifted.bounds().astype(np.int64)
        assert lo % bins.LINE_ALIGN == 0 and lo < hi <= L
        assert (hi % bins.LINE_ALIGN == 0) or hi == L
        assert (shifted.lmax_local, shifted.lmax_remote) == (64, 64)
        inside = np.zeros(nb, bool)
        inside[start_bin:start_bin + nbins] = True
        for r in range(3):
            used = (bnd[2 * r + 1] > bnd[2 * r]) & inside
            assert (bnd[2 * r][used] >= lo).all()
            assert (bnd[2 * r + 1][used] <= hi).all()
            assert np.array_equal(got[2 * r][used] + lo, bnd[2 * r][used])
            assert np.array_equal(got[2 * r + 1][used] + lo,
                                  bnd[2 * r + 1][used])
            assert not got[2 * r:2 * r + 2, ~used].any()
        if (start_bin, nbins) == (12, 6):      # no range at all
            assert (lo, hi) == (0, bins.LINE_ALIGN)
    whole = ranges.window(0, nb, int(bnd[1::2].max()))
    assert whole[:2] == (0, int(bnd[1::2].max())) and whole[2] is ranges


@pytest.mark.parametrize("S,block", [(1, 0), (3, 0), (3, 2), (10, 0),
                                     (10, 9), (10, 5)],
                         ids=["S1", "S3-first", "S3-last", "S10-first",
                              "S10-last", "S10-no-centres"])
@pytest.mark.parametrize("method", METHODS)
def test_windowed_block_equals_whole_catalog_prep(method, S, block,
                                                  monkeypatch):
    gas = _wide_gas(method)
    p, t, vmr = _state()
    vmr = {1: vmr[1], 2: vmr[1] * 0.3}
    kw = {}
    if S > 1:
        size, starts = RadiationDriver._blocks(gas, S)
        kw = dict(block_start=starts[block], block_size=size)
        assert starts[-1] < gas.grid.n
    got = gas.optical_depth(p, t, vmr, **kw)
    share = gas.line_prep.share
    if S == 1:
        assert share == 1.0
    else:
        assert share < 1.0                             # the window engaged
    if (S, block) == (10, 5):
        c = gas.molecules[1].c0
        w = gas.grid.w0 + gas.grid.dw * c[(c >= starts[5])
                                          & (c < starts[5] + size)]
        assert w.size == 0
    _whole_catalog(monkeypatch)
    want = gas.optical_depth(p, t, vmr, **kw)
    assert torch.equal(got, want)
    assert got.max() > 0


@pytest.mark.parametrize("S", [1, 3, 10])
@pytest.mark.parametrize("method", METHODS)
def test_streamed_fluxes_equal_whole_catalog_prep(method, S, monkeypatch):
    gas = _wide_gas(method)
    rng = np.random.default_rng(9)
    B, nlev = 2, 9
    p = np.linspace(0.05, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + rng.uniform(-4, 4,
                                                               (B, nlev))
    atm = Atmosphere(level_pressure=p, level_temperature=t,
                     surface_temperature=t[:, -1] + 1.0,
                     ppmv={1: rng.uniform(10.0, 2e4, (B, nlev)),
                           2: np.full((B, nlev), 400.0)},
                     emissivity_grid=np.array([50.0, 500.0]),
                     emissivity=np.array([[0.95, 0.9], [1.0, 0.85]]))
    got = RadiationDriver(gas).run(atm, spectral_chunks=S).tiers["csaf"]
    assert (gas.line_prep.share == 1.0) == (S == 1)
    _whole_catalog(monkeypatch)
    want = RadiationDriver(gas).run(atm, spectral_chunks=S).tiers["csaf"]
    for var in ("rlu", "rld"):
        assert torch.equal(got[var], want[var]), var
        assert got[var].abs().max() > 0


@pytest.mark.parametrize("method", METHODS)
def test_line_prep_counter_once_per_step(method):
    """Unstreamed, the band preps every line its bins read: the whole
    catalog in line_sweep (share 1.0), all but the lines off the grid in
    wavenumber_sweep, whose bins read none.  At S = 10 on a uniform
    catalog over 900 cm-1 the share is under 0.2.  Each eager step adds
    its blocks' counts again."""
    gas = _wide_gas(method, n=6000, gap=False, grid=(100.0, 999.9, 0.1),
                    mols=(1,))
    L = gas.molecules[1].num_lines
    lo, hi, _ = gas._line_window(1, 0, gas.bins.n)
    assert (hi - lo == L) == (method == "line_sweep")
    assert hi - lo > 0.97 * L
    p, t, vmr = _state()
    atm = Atmosphere(level_pressure=p, level_temperature=t,
                     surface_temperature=t[:, -1] + 1.0,
                     ppmv={1: vmr[1] * 1e6})
    driver = RadiationDriver(gas)
    for calls in (1, 2):
        driver.run(atm)
        assert (gas.line_prep.prepped, gas.line_prep.catalog) == \
            (calls * (hi - lo), calls * L)
    assert driver.step_stats()["line_prep"] == dict(prepped=2 * (hi - lo),
                                                    catalog=2 * L)
    before = gas.line_prep.prepped
    driver.run(atm, spectral_chunks=10)
    once = gas.line_prep.prepped - before
    assert gas.line_prep.catalog == 12 * L and once < 0.2 * 10 * L
    driver.run(atm, spectral_chunks=10)
    assert gas.line_prep.prepped - before == 2 * once
    assert driver.step_stats()["eager"] == 4
