"""The port's cloud physics (grtcode_tpu_torch/clouds) against the JAX
package's on the same numpy inputs.

JAX's float32 ``betainc`` (a continued fraction stopped when every element
of the array has converged) is up to ~3e-6 off the exact I_x(6, 5), and
its value for one element depends on the others in the array.  The port
evaluates the exact binomial sum, so:

* ``beta_value`` is held within 1e-7 of the exact value everywhere and
  within 2e-6 of JAX's wherever JAX is within 1e-6 of the exact value;
* the transforms downstream of it (``sample_condensate``, the driver
  callback) are held against the JAX functions with JAX's ``betainc``
  replaced by the exact one (the ``exact_jax_betainc`` fixture), so the
  comparison measures the transforms, not JAX's betainc error.

The draws themselves (``cloudiness``) are bit-identical with no
replacement.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.special import betainc as exact_betainc

from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu.clouds import hu_stamnes as jhs
from grtcode_tpu.clouds import lib as jlib
from grtcode_tpu.clouds import pade as jpade
from grtcode_tpu.clouds import stochastic as jstoch
from grtcode_tpu_torch.clouds import beta, hu_stamnes, lib, pade, stochastic
from grtcode_tpu_torch.convert import (cloud_lib_from_jax,
                                       hu_stamnes_from_jax, pade_from_jax)
from grtcode_tpu_torch.utils import prng

BETA_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def exact_jax_betainc(monkeypatch):
    """JAX's clouds with the exact I_x(p, q) (the port's, through a host
    callback) in place of jax.scipy.special.betainc."""
    def betainc(a, b, x):
        def host(av, bv, xv):
            p, q = int(np.asarray(av).flat[0]), int(np.asarray(bv).flat[0])
            return beta.beta_value(p, q, torch.as_tensor(
                np.array(xv, np.float32))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(jnp.shape(x), jnp.float32), a, b, x,
            vmap_method="broadcast_all")

    monkeypatch.setattr(jbeta, "betainc", betainc)


def _t(a):
    return torch.as_tensor(np.array(a))


def _x_samples():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.linspace(0.0, 1.0, 1001), rng.uniform(0.0, 1.0, 4000),
        rng.uniform(0.0, 0.02, 500), rng.uniform(0.98, 1.0, 500),
        [-0.5, 1.5]]).astype(np.float32)


@pytest.mark.parametrize("p,q", [(5, 5), (6, 5)])
def test_beta_value_matches_exact_and_jax(p, q):
    x = _x_samples()
    got = beta.beta_value(p, q, _t(x)).numpy()
    assert got.dtype == np.float32
    exact = exact_betainc(p, q, np.clip(x, 0.0, 1.0).astype(np.float64))
    assert np.abs(got - exact).max() <= 1e-7
    want = np.asarray(jbeta.beta_value(p, q, x), np.float64)
    trusted = np.abs(want - exact) <= 1e-6
    assert trusted.mean() > 0.9
    assert np.abs(got - want)[trusted].max() <= BETA_ATOL


@pytest.mark.parametrize("p,q", [(5, 5), (6, 5)])
def test_beta_inverse_matches_jax(p, q):
    y = np.concatenate([np.linspace(0.0, 1.0, 401),
                        np.random.default_rng(1).uniform(0, 1, 2000)])
    y = y.astype(np.float32)
    got = beta.beta_inverse(p, q, _t(y)).numpy()
    want = np.asarray(jbeta.beta_inverse(p, q, y))
    np.testing.assert_allclose(got, want, rtol=0, atol=BETA_ATOL)
    # And it inverts the exact CDF.
    np.testing.assert_allclose(exact_betainc(p, q, got.astype(np.float64)),
                               y, atol=2e-6)


@pytest.mark.parametrize("p,q", [(5.5, 5), (5, 0)])
def test_beta_needs_integer_shape_parameters(p, q):
    with pytest.raises(ValueError, match="integer"):
        beta.beta_value(p, q, torch.tensor([0.5]))
    with pytest.raises(ValueError, match="integer"):
        beta.beta_inverse(p, q, torch.tensor([0.5]))


def test_overlap_parameter_matches_jax():
    z = np.random.default_rng(2).uniform(0.0, 40.0, (3, 12)).astype(
        np.float32)
    got = stochastic.overlap_parameter(_t(z), 2.0).numpy()
    want = np.asarray(jstoch.overlap_parameter(z, 2.0))
    assert got.shape == (3, 11)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _column_keys(seed, ids):
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.asarray(ids, jnp.int32))
    keys = prng.fold_in(prng.prng_key(seed), _t(ids))
    return jkeys, keys


@pytest.mark.parametrize("seed,nlay", [(0, 2), (3, 20), (77, 54)])
def test_cloudiness_is_bit_identical(seed, nlay):
    ids = np.array([0, 5, 9, 31])
    ov = np.random.default_rng(seed).uniform(0.0, 1.0, (ids.size, nlay - 1))
    ov = ov.astype(np.float32)
    jkeys, keys = _column_keys(seed, ids)
    want = np.asarray(jax.vmap(lambda k, o: jstoch.cloudiness(k, o, nlay))(
        jkeys, ov))
    got = stochastic.cloudiness(keys, _t(ov), nlay).numpy()
    assert got.shape == (ids.size, nlay)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cloudiness_rank_copy_limits():
    """Overlap ~1: every layer copies layer 0; overlap 0: independent."""
    n = 20
    key = prng.prng_key(0)
    x1 = stochastic.cloudiness(key, torch.full((n - 1,), 0.999999), n)
    assert torch.all(x1 == x1[0])
    x0 = stochastic.cloudiness(key, torch.zeros(n - 1), n)
    assert len(np.unique(np.round(x0.numpy(), 8))) > n // 2


def _cloud_state(B, nlay, seed):
    rng = np.random.default_rng(seed)
    cf = rng.uniform(0.0, 1.0, (B, nlay))
    cf[:, ::5] = 0.0
    cf[:, 1::7] = 1.0
    lwc = rng.uniform(0.0, 0.3, (B, nlay))
    iwc = rng.uniform(0.0, 0.02, (B, nlay))
    iwc[:, ::3] = 0.0
    lwc[:, ::4] = 0.0
    ov = rng.uniform(0.0, 1.0, (B, nlay - 1))
    return [a.astype(np.float32) for a in (cf, lwc, iwc, ov)]


def test_sample_condensate_matches_jax(exact_jax_betainc):
    B, nlay = 16, 30
    cf, lwc, iwc, ov = _cloud_state(B, nlay, 4)
    ids = np.arange(100, 100 + B)
    jkeys, keys = _column_keys(11, ids)
    want = jax.vmap(jstoch.sample_condensate)(jkeys, cf, lwc, iwc, ov)
    got = stochastic.sample_condensate(keys, _t(cf), _t(lwc), _t(iwc),
                                       _t(ov))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (B, nlay) and float(np.abs(w).max()) > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


def test_condensate_from_injected_uniforms():
    """The transform alone, on given cloudiness: clear where x <= 1 - cf,
    the liquid share of the total exact, and the same as the sampled
    condensate of the draws it was given."""
    B, nlay = 4, 12
    cf, lwc, iwc, ov = _cloud_state(B, nlay, 5)
    keys = prng.split(prng.prng_key(5), B)
    x = stochastic.cloudiness(keys, _t(ov), nlay)
    ql, qi = stochastic.condensate_from_cloudiness(x, _t(cf), _t(lwc),
                                                   _t(iwc))
    sql, sqi = stochastic.sample_condensate(keys, _t(cf), _t(lwc), _t(iwc),
                                            _t(ov))
    assert torch.equal(ql, sql) and torch.equal(qi, sqi)
    clear = x.numpy() <= 1.0 - cf
    assert not ql.numpy()[clear].any() and not qi.numpy()[clear].any()
    tot = (ql + qi).numpy()
    cloudy = tot > 0
    share = np.divide(lwc, lwc + iwc, out=np.zeros_like(lwc),
                      where=lwc + iwc > 0)
    np.testing.assert_allclose((ql.numpy() / np.maximum(tot, 1e-30))[cloudy],
                               share[cloudy], rtol=1e-5)


def test_sample_condensate_mean_preserved():
    """Over many subcolumns the cloudy share is the cloud fraction and the
    mean condensate the prescribed lwc + iwc."""
    n = 4000
    keys = prng.split(prng.prng_key(1), n)
    cf = torch.full((n, 4), 0.6)
    ql, qi = stochastic.sample_condensate(
        keys, cf, torch.full((n, 4), 0.2), torch.full((n, 4), 0.1),
        torch.zeros((n, 3)))
    ql, qi = ql.numpy(), qi.numpy()
    assert (ql >= 0).all() and (qi >= 0).all()
    np.testing.assert_allclose((ql + qi > 0).mean(axis=0), 0.6, atol=0.05)
    np.testing.assert_allclose((ql + qi).mean(axis=0), 0.3, rtol=0.1)


def test_ice_particle_size_matches_jax():
    t = np.concatenate([np.linspace(180.0, 300.0, 241),
                        jlib._TFREEZE - np.array([55.0, 50.0, 45.0, 40.0,
                                                  35.0, 30.0, 25.0])])
    t = t.astype(np.float32)
    got = lib.ice_particle_size(_t(t)).numpy()
    want = np.asarray(jlib.ice_particle_size(t))
    assert np.array_equal(got, want)


def _grid_points(w0, wn, dw):
    n = int(np.ceil((wn - w0) / dw)) + 1
    idx = np.arange(n, dtype=np.int32).astype(np.float32)
    return np.float32(w0) + np.float32(dw) * idx


@pytest.mark.parametrize("table", ["pade", "hu_stamnes"])
def test_band_to_grid_matches_jax(table):
    if table == "pade":
        lims = np.asarray(jpade.synthetic_pade_table(
            nbnd=8, w0=100.0, wn=900.0).band_lims)
    else:
        # A gap between bands 0 and 1, and points past both ends.
        lims = np.array([[100.0, 350.0, 600.0], [300.0, 600.0, 900.0]])
    w = _grid_points(50.0, 1000.0, 0.5)
    vals = np.random.default_rng(6).uniform(0.1, 1.0,
                                            (3, 5, lims.shape[1]))
    vals = vals.astype(np.float32)
    got = lib.band_to_grid(_t(vals), _t(lims), _t(w)).numpy()
    want = np.asarray(jlib.band_to_grid(vals, lims, w))
    assert got.shape == (3, 5, w.size)
    assert np.array_equal(got, want)
    assert not got[..., 0].any() and not got[..., -1].any()
    if table == "hu_stamnes":
        assert not got[..., (w > 300.0) & (w < 350.0)].any()


def test_synthetic_pade_table_equals_jax():
    jt = jpade.synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=1)
    for t in (pade.synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0,
                                        seed=1, device="cpu"),
              pade_from_jax(jt, "cpu")):
        for f in ("band_lims", "sizereg_bounds", "sizereg_ref", "ext_p",
                  "ext_q", "ssa_p", "ssa_q", "asy_p", "asy_q"):
            assert np.array_equal(getattr(t, f).numpy(),
                                  np.asarray(getattr(jt, f))), f


def test_pade_evaluate_matches_jax():
    jt = jpade.synthetic_pade_table(nbnd=8, w0=100.0, wn=900.0, seed=3)
    t = pade_from_jax(jt, "cpu")
    rng = np.random.default_rng(7)
    content = rng.uniform(0.0, 0.5, (4, 9)).astype(np.float32)
    content[:, 0] = 0.0
    # Regime edges (2, 20, 90: 20 is in both, the first wins), outside.
    radius = np.tile(np.array([1.0, 2.0, 10.0, 19.99, 20.0, 20.01, 55.0,
                               90.0, 500.0], np.float32), (4, 1))
    got = t.evaluate(_t(content), _t(radius))
    want = jt.evaluate(content, radius)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (4, 9, 8)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    assert not got[0][:, 0].any() and not got[0][:, -1].any()


def _hu_stamnes_tables():
    rng = np.random.default_rng(7)
    nbins, nbands = 4, 3
    radii = np.array([2.5, 10.0, 20.0, 40.0, 60.0])
    band_lims = np.array([[1.0, 1000.0, 2000.0], [1000.0, 2000.0, 3000.0]])
    a = rng.uniform(0.1, 2.0, (3, nbins, nbands))
    b = rng.uniform(-1.5, -0.2, (3, nbins, nbands))
    c = rng.uniform(0.0, 0.1, (3, nbins, nbands))
    return (jhs.HuStamnesLiquidOptics.from_arrays(radii, band_lims, a, b, c),
            hu_stamnes.HuStamnesLiquidOptics.from_arrays(radii, band_lims, a,
                                                         b, c, device="cpu"))


def test_hu_stamnes_evaluate_matches_jax():
    jt, t = _hu_stamnes_tables()
    wc = np.array([[0.05, 0.3, 1.2, 0.7, 0.0, 0.2]], np.float32)
    r = np.array([[1.0, 12.0, 35.0, 80.0, 10.0, 20.0]], np.float32)
    want = jt.evaluate(wc, r)
    for got in (t.evaluate(_t(wc), _t(r)),
                hu_stamnes_from_jax(jt, "cpu").evaluate(_t(wc), _t(r))):
        for g, w in zip(got, want):
            assert g.shape == (1, 6, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("liquid", ["pade", "hu_stamnes"])
def test_driver_callback_matches_jax(exact_jax_betainc, liquid):
    """The callback on a batch of columns with global ids, on an LW and an
    SW block of w: (B, nlayers, nw) liquid and ice optics as JAX's."""
    B, nlay = 5, 10
    cf, lwc, iwc, _ = _cloud_state(B, nlay, 8)
    rng = np.random.default_rng(9)
    args = {
        "col_index": np.array([3, 17, 4, 40, 1]),
        "cloud_fraction": cf, "liquid_water_content": lwc,
        "ice_water_content": iwc,
        "t_lay": rng.uniform(200.0, 290.0, (B, nlay)).astype(np.float32),
        "layer_pressure": np.sort(rng.uniform(100.0, 1000.0, (B, nlay)),
                                  axis=1).astype(np.float32),
        "layer_thickness": rng.uniform(100.0, 900.0, (B, nlay)).astype(
            np.float32),
    }
    jliq = (_hu_stamnes_tables()[0] if liquid == "hu_stamnes" else
            jpade.synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0))
    jcl = jlib.CloudOpticsLib(
        liquid=jliq,
        ice=jpade.synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=1))
    w_lw = _grid_points(500.0, 3250.0, 0.5)
    w_sw = _grid_points(2000.0, 20000.0, 4.0)
    want = jcl.driver_callback()(
        {k: jnp.asarray(v) for k, v in args.items()},
        jax.random.PRNGKey(4), jnp.asarray(w_lw), jnp.asarray(w_sw))
    port = cloud_lib_from_jax(jcl, "cpu")
    got = port.driver_callback()({k: _t(v) for k, v in args.items()},
                                 prng.prng_key(4), _t(w_lw), _t(w_sw))
    nonzero = 0
    for g, w, nw in zip(got, want, (w_lw.size, w_lw.size, w_sw.size,
                                    w_sw.size)):
        for f in ("tau", "omega", "g"):
            gv, wv = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            assert gv.shape == (B, nlay, nw)
            np.testing.assert_allclose(gv, wv, rtol=1e-5,
                                       atol=1e-6 * np.abs(wv).max(),
                                       err_msg=f)
            nonzero += int(np.count_nonzero(gv))
    assert nonzero > 0
    lw_only = port.driver_callback()({k: _t(v) for k, v in args.items()},
                                     prng.prng_key(4), _t(w_lw), None)
    assert lw_only[2] is None and lw_only[3] is None
    assert torch.equal(lw_only[0].tau, got[0].tau)


def test_jax_betainc_is_off_the_exact_value():
    """Why the cloudy tests patch the exact beta into JAX: JAX's float32
    I_x(6, 5) is 2e-6 to 5e-6 off the exact value near x = 0.54, and its
    value for one element depends on the others in the array."""
    x = _x_samples()
    exact = exact_betainc(6, 5, np.clip(x, 0.0, 1.0).astype(np.float64))
    err = np.abs(np.asarray(jbeta.beta_value(6, 5, x), np.float64) - exact)
    assert 2e-6 < err.max() < 5e-6
    assert 0.4 < float(x[err.argmax()]) < 0.7
    alone = np.array([float(jbeta.beta_value(6, 5, v)) for v in x[:200]])
    assert not np.array_equal(alone, np.asarray(jbeta.beta_value(6, 5,
                                                                 x[:200])))


def test_condensate_without_the_exact_beta_in_jax():
    """With JAX's own betainc, its condensate is off the port's by more
    than the 1e-5 bar (and less than 1e-3): the error is JAX's beta."""
    B, nlay = 16, 30
    cf, lwc, iwc, ov = _cloud_state(B, nlay, 4)
    jkeys, keys = _column_keys(11, np.arange(100, 100 + B))
    want = jax.vmap(jstoch.sample_condensate)(jkeys, cf, lwc, iwc, ov)
    got = stochastic.sample_condensate(keys, _t(cf), _t(lwc), _t(iwc),
                                       _t(ov))
    w, g = np.asarray(want[0], np.float64), got[0].numpy()
    big = np.abs(w) > 1e-3 * np.abs(w).max()
    rel = (np.abs(g - w)[big] / np.abs(w)[big]).max()
    assert 1e-5 < rel < 1e-3
