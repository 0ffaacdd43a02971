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
  (tests/test_bins.py:53-60).
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
