"""The port's discrete-ordinates solver (float32,
``grtcode_tpu_torch.solvers.disort``) against the benchmark's float64
discrete-ordinates reference (``rtbench/reference/sw_disort.py``), an
eigen-solution with the adding method written apart from the port's
doubling, and the reference against the analytic cases of
tests/test_torch_disort.py.

Tolerances, as a share of each wavenumber's largest flux over the
levels: the port starts its doubling from a single-scattering layer of
optical depth <= 1e-5, whose error is of first order in that depth over
the smallest stream cosine, so it is the method that sets the gap, not
its float32 rounding (a float64 copy of the port's doubling reads the
same gaps).  On these inputs the port reads at most 3.2e-4 up and 1.1e-4
down; the reference computed in bfloat16 reads at least 2.6e-2 up and
7.2e-3 down.  UP_TOL and DOWN_TOL lie three to five times over the first
and fourteen to twenty-six times under the second.
"""
import numpy as np
import pytest
import torch

from grtcode_tpu_torch.solvers.disort import disort_shortwave
from rtbench.reference import sw_disort
from tests.test_disort import _chandrasekhar_H

UP_TOL = 1e-3
DOWN_TOL = 5e-4
TSI = 1361.0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _layers(seed, nlayers=12, nw=64):
    """Seeded random layers: tau log-uniform over 1e-4-1e3, omega in [0,
    0.999], g in [0, 0.9], albedo in [0, 1], a solar spectrum."""
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-4, 3, (nlayers, nw)),
            rng.uniform(0.0, 0.999, (nlayers, nw)),
            rng.uniform(0.0, 0.9, (nlayers, nw)), rng.uniform(0.0, 1.0, nw),
            rng.uniform(0.5, 1.5, nw))


def _reference(tau, omega, g, albedo, solar, mu0, nstr,
               dtype=torch.float64, quadrature="gauss"):
    t = [torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
         for a in (tau, omega, g, albedo, TSI, solar)]
    return sw_disort.fluxes(*t[:3], mu0, *t[3:],
                            config={"disort_streams": nstr},
                            quadrature=quadrature)


def _gap(got, want):
    """The largest gap over levels and wavenumbers, each wavenumber's as
    a share of its largest flux over the levels."""
    got, want = got.double().numpy(), want.double().numpy()
    return float(np.max(np.abs(got - want)
                        / np.abs(want).max(axis=0, keepdims=True)))


@pytest.mark.parametrize("mu0", [0.2, 0.6707, 0.95])
@pytest.mark.parametrize("nstr", [16, 4])
def test_the_port_holds_to_the_float64_reference(nstr, mu0):
    for seed in (1, 2):
        tau, omega, g, alb, sol = _layers(seed)
        want = _reference(tau, omega, g, alb, sol, mu0, nstr)
        f32 = [torch.as_tensor(a, dtype=torch.float32)
               for a in (tau, omega, g, alb, sol)]
        got = disort_shortwave(*f32[:3], torch.tensor(mu0), f32[3],
                               torch.tensor(TSI), f32[4], nstr=nstr)
        assert _gap(got[0], want[0]) < UP_TOL
        assert _gap(got[1], want[1]) < DOWN_TOL


@pytest.mark.parametrize("nstr", [16, 4])
def test_the_reference_in_bfloat16_fails_the_tolerances(nstr):
    tau, omega, g, alb, sol = _layers(3)
    want = _reference(tau, omega, g, alb, sol, 0.6707, nstr)
    low = _reference(tau, omega, g, alb, sol, 0.6707, nstr,
                     dtype=torch.bfloat16)
    assert torch.isfinite(low[0]).all() and torch.isfinite(low[1]).all()
    assert _gap(low[0], want[0]) > UP_TOL or _gap(low[1], want[1]) > \
        DOWN_TOL


def _uniform(tau, omega, g, albedo, mu0, nlayers=4, nw=3, nstr=16,
             quadrature="gauss"):
    full = np.ones((nlayers, nw))
    up, down = _reference(tau * full, omega * full, g * full,
                          np.full(nw, albedo), np.ones(nw), mu0, nstr,
                          quadrature=quadrature)
    return up.numpy()[:, 0] / TSI, down.numpy()[:, 0] / TSI


QUADRATURES = ["gauss", "double_gauss"]


@pytest.mark.parametrize("quadrature", QUADRATURES)
def test_the_rules_integrate_each_hemisphere(quadrature):
    """Both rules give h ascending cosines in (0, 1), weights summing to
    1.  cdisort's double-Gauss rule integrates mu^k over (0, 1) exactly
    to degree 2h - 1; the positive half of the full-range rule, the
    port's, does not (mu^3 is off by 4e-5 at 16 streams)."""
    mu, w = sw_disort.streams(16, quadrature)
    assert mu.size == 8 and np.all(np.diff(mu) > 0)
    assert 0.0 < mu[0] and mu[-1] < 1.0
    assert np.sum(w) == pytest.approx(1.0, rel=1e-13)
    moments = np.array([np.sum(w * mu ** k) * (k + 1) for k in range(16)])
    if quadrature == "double_gauss":
        np.testing.assert_allclose(moments, 1.0, rtol=1e-13)
    else:
        assert abs(moments[3] - 1.0) > 1e-5


def test_the_two_rules_are_different_answers():
    """On the random layers the rules differ by more than the port's
    tolerance: the reference has to take the port's rule to hold its
    solve, and the rule is the configuration's to state."""
    tau, omega, g, alb, sol = _layers(1)
    half = _reference(tau, omega, g, alb, sol, 0.6707, 16)
    double = _reference(tau, omega, g, alb, sol, 0.6707, 16,
                        quadrature="double_gauss")
    assert _gap(double[0], half[0]) > UP_TOL


@pytest.mark.parametrize("quadrature", QUADRATURES)
def test_transparent(quadrature):
    up, down = _uniform(0.0, 0.0, 0.0, 0.3, 0.6, quadrature=quadrature)
    np.testing.assert_allclose(down, 0.6, rtol=1e-14)
    np.testing.assert_allclose(up, 0.3 * 0.6, rtol=1e-14)


@pytest.mark.parametrize("quadrature", QUADRATURES)
def test_absorption_only_analytic(quadrature):
    mu0, tau1, nlayers, albedo = 0.6, 0.3, 4, 0.25
    up, down = _uniform(tau1, 0.0, 0.0, albedo, mu0, nlayers=nlayers,
                        quadrature=quadrature)
    taus = tau1 * np.arange(nlayers + 1)
    np.testing.assert_allclose(down, mu0 * np.exp(-taus / mu0), rtol=1e-12)
    mu, w = sw_disort.streams(16, quadrature)
    surface = albedo * mu0 * np.exp(-taus[-1] / mu0)
    expect = surface * np.array(
        [np.sum(w * mu * np.exp(-(taus[-1] - t) / mu)) / np.sum(w * mu)
         for t in taus])
    np.testing.assert_allclose(up, expect, rtol=1e-12)


@pytest.mark.parametrize("quadrature", QUADRATURES)
def test_conservative_scattering_conserves_flux(quadrature):
    """omega = 1 over a black surface: the net flux is the same at every
    level but for the dithered omega's absorption."""
    up, down = _uniform(1.0, 1.0, 0.7, 0.0, 0.6, quadrature=quadrature)
    net = down - up
    np.testing.assert_allclose(net, net[0], rtol=1e-7)
    assert 0.05 < up[0] / down[0] < 0.95


@pytest.mark.parametrize("quadrature", QUADRATURES)
@pytest.mark.parametrize("omega,mu0", [(0.6, 0.5), (0.9, 0.8),
                                       (0.99, 0.4)])
def test_semi_infinite_plane_albedo_vs_chandrasekhar(omega, mu0,
                                                     quadrature):
    """Isotropic scattering over ~400 optical depths in thickening
    layers: the plane albedo is 1 - H(mu0) sqrt(1 - omega), within the
    16-stream quadrature's error."""
    exact = 1.0 - _chandrasekhar_H(omega, mu0) * np.sqrt(1.0 - omega)
    nlayers, nw = 60, 2
    tau = np.repeat((0.08 * 1.16 ** np.arange(nlayers))[:, None], nw, 1)
    up, _ = _reference(tau, np.full((nlayers, nw), omega),
                       np.zeros((nlayers, nw)), np.zeros(nw), np.ones(nw),
                       mu0, 16, quadrature=quadrature)
    got = float(up[0, 0]) / (TSI * mu0)
    assert abs(got - exact) < 5e-3 * max(exact, 0.05), (got, exact)


def test_a_split_layer_and_wavenumber_blocks_change_nothing(monkeypatch):
    """One layer of tau 50 and the same as two of 25 agree at the top and
    the bottom; solving in blocks of 5 wavenumbers agrees with one
    block."""
    one = _uniform(50.0, 0.95, 0.6, 0.2, 0.6, nlayers=1)
    two = _uniform(25.0, 0.95, 0.6, 0.2, 0.6, nlayers=2)
    for a, b in zip(one, two):
        np.testing.assert_allclose(a[[0, -1]], b[[0, -1]], rtol=1e-12,
                                   atol=1e-15)
    tau, omega, g, alb, sol = _layers(4, nlayers=5, nw=12)
    whole = _reference(tau, omega, g, alb, sol, 0.5, 8)
    monkeypatch.setattr(sw_disort, "BLOCK", 5)
    blocks = _reference(tau, omega, g, alb, sol, 0.5, 8)
    for a, b in zip(blocks, whole):
        assert _gap(a, b) < 1e-12
