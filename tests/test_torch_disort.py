"""The port's discrete-ordinates shortwave solver
(``grtcode_tpu_torch.solvers.disort``).

* Every case of tests/test_disort.py on the port, at that file's bars:
  the transparent column, the absorption-only analytic fluxes, flux
  conservation under conservative scattering, layer-split invariance,
  agreement with the two-stream solver within its band, the extreme
  optical depths and the Chandrasekhar plane albedo.
* The port against ``grtcode_tpu.solvers.disort.disort_shortwave`` on the
  same inputs (4, 8 and 16 streams, delta-M on and off, ``wchunk``
  smaller than nw with a short last block, layers at tau 0, 1e-12, on
  power-of-two multiples of 1e-5 and 1e12): within JAX_TOL of each
  level's largest flux.  The worst found is 1.4e-6; no looser than 1e-4.
* Column-batched calls equal per-column calls bit for bit on the CPU; the
  block size changes the result by no more than 1e-6 of the level's
  largest flux.
* The solver refuses reduced-precision float32 matmuls.
* Running each element only to its own doubling count is exact: the
  masked steps past it change no bit of the fluxes.  On CPU tensors the
  doubling is the plain loop; the card kernel's argument checks.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grtcode_tpu.solvers.disort import disort_shortwave as jdisort
from grtcode_tpu_torch.solvers import disort as disort_mod
from grtcode_tpu_torch.solvers.disort import disort_shortwave, gauss_streams
from grtcode_tpu_torch.solvers.shortwave import shortwave_fluxes
from tests.test_disort import _chandrasekhar_H

MU0 = 0.6
TSI = 1361.0
JAX_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _full(v, *shape):
    return torch.full(shape, v, dtype=torch.float32)


def _run(tau, omega, g, albedo=0.2, nw=6, nstr=8, nlayers=4):
    return disort_shortwave(
        _full(tau, nlayers, nw), _full(omega, nlayers, nw),
        _full(g, nlayers, nw), torch.tensor(MU0), _full(albedo, nw),
        torch.tensor(TSI), _full(1.0, nw), nstr=nstr, wchunk=8)


def test_transparent():
    fup, fdn = _run(0.0, 0.0, 0.0, albedo=0.3)
    np.testing.assert_allclose(fdn.numpy(), TSI * MU0, rtol=1e-5)
    np.testing.assert_allclose(fup.numpy(), TSI * MU0 * 0.3, rtol=1e-5)


def test_absorption_only_analytic():
    tau1, nlayers = 0.3, 4
    fup, fdn = _run(tau1, 0.0, 0.0, albedo=0.25, nlayers=nlayers, nstr=16)
    fdn, fup = fdn.numpy()[:, 0], fup.numpy()[:, 0]
    taus = tau1 * np.arange(nlayers + 1)
    np.testing.assert_allclose(fdn, TSI * MU0 * np.exp(-taus / MU0),
                               rtol=1e-5)
    mu, w = gauss_streams(16)
    f_sfc = 0.25 * TSI * MU0 * np.exp(-taus[-1] / MU0)
    np.testing.assert_allclose(fup[-1], f_sfc, rtol=1e-5)
    swmu = np.sum(w * mu)
    expect = f_sfc * np.array(
        [np.sum(w * mu * np.exp(-(taus[-1] - t) / mu)) / swmu
         for t in taus])
    np.testing.assert_allclose(fup, expect, rtol=1e-4)


def test_conservative_scattering_flux_conservation():
    fup, fdn = _run(1.0, 1.0, 0.7, albedo=0.0, nstr=16)
    net = (fdn - fup).numpy()[:, 0]
    np.testing.assert_allclose(net, net[0], rtol=5e-4)
    r = float(fup[0, 0] / fdn[0, 0])
    assert 0.05 < r < 0.95


def test_layer_split_invariance():
    common = dict(albedo=0.15, nw=4, nstr=8)
    f1 = _run(1.0, 0.8, 0.5, nlayers=1, **common)
    f2 = _run(0.5, 0.8, 0.5, nlayers=2, **common)
    for a, b in zip(f1, f2):
        np.testing.assert_allclose(a.numpy()[[0, -1]], b.numpy()[[0, -1]],
                                   rtol=2e-5)


def test_matches_two_stream_moderate():
    nw, nlayers = 4, 6
    tau, omega, g = (_full(v, nlayers, nw) for v in (0.5, 0.9, 0.6))
    alb, solar = _full(0.1, nw), _full(1.0, nw)
    mu0, tsi = torch.tensor(MU0), torch.tensor(TSI)
    fup16, fdn16 = disort_shortwave(tau, omega, g, mu0, alb, tsi, solar,
                                    nstr=16, wchunk=4)
    fup2, fdn2 = shortwave_fluxes(tau, omega, g, mu0, mu0, alb, alb, tsi,
                                  solar)
    for a, b in ((fup16, fup2), (fdn16, fdn2)):
        a, b = a.numpy()[:, 0], b.numpy()[:, 0]
        assert np.all(np.abs(a - b) <= 0.12 * np.abs(b).max() + 1e-3)
        assert np.all(np.sign(np.diff(a)) == np.sign(np.diff(b)))


@pytest.mark.parametrize("tau", [1e-12, 1.0, 1e12])
def test_robustness_extremes(tau):
    fup, fdn = (f.numpy() for f in _run(tau, 0.5, 0.3, nstr=8))
    assert np.isfinite(fup).all() and np.isfinite(fdn).all()
    assert (fup >= -1e-3).all() and (fdn >= -1e-3).all()
    assert fdn[0, 0] == pytest.approx(TSI * MU0, rel=1e-5)
    if tau > 1e6:
        assert abs(fdn[-1, 0]) < 1e-3 and abs(fup[-1, 0]) < 1e-3


@pytest.mark.parametrize("omega,mu0", [(0.6, 0.5), (0.9, 0.8),
                                       (0.99, 0.4)])
def test_semi_infinite_plane_albedo_vs_chandrasekhar(omega, mu0):
    A_exact = 1.0 - _chandrasekhar_H(omega, mu0) * np.sqrt(1.0 - omega)
    nlayers, nw = 60, 2
    dtau = 0.08 * 1.16 ** np.arange(nlayers)
    tau = torch.tensor(np.repeat(dtau[:, None], nw, 1), dtype=torch.float32)
    fup, _ = disort_shortwave(
        tau, _full(omega, nlayers, nw), _full(0.0, nlayers, nw),
        torch.tensor(mu0), _full(0.0, nw), torch.tensor(TSI),
        _full(1.0, nw), nstr=16, deltam=False, wchunk=2)
    A_got = float(fup[0, 0]) / (TSI * mu0)
    assert abs(A_got - A_exact) < 5e-3 * max(A_exact, 0.05), \
        (A_got, A_exact)


def _inputs(seed=1, nlayers=6, nw=50):
    """Random layers plus the doubling count's edge cases: tau 0, 1e-12,
    1e12 and f32 power-of-two multiples of 1e-5 (where one ulp of the
    log2 moves the count)."""
    rng = np.random.default_rng(seed)
    tau = (10.0 ** rng.uniform(-6, 2, (nlayers, nw))).astype(np.float32)
    tau[0, :5] = [0.0, 1e-12, 1e12, 1e-5 * 2 ** 3, 1e-5 * 2 ** 10]
    tau[1, :40] = np.float32(1e-5) * np.float32(2.0) ** np.arange(-2, 38)
    omega = rng.uniform(0, 1, (nlayers, nw)).astype(np.float32)
    omega[2, :3] = [0.0, 1.0, 1.0]
    g = rng.uniform(-0.2, 0.9, (nlayers, nw)).astype(np.float32)
    alb = rng.uniform(0, 0.5, nw).astype(np.float32)
    sol = rng.uniform(0.5, 1.5, nw).astype(np.float32)
    return tau, omega, g, alb, sol


@pytest.mark.parametrize("deltam", [True, False])
@pytest.mark.parametrize("nstr", [4, 8, 16])
def test_matches_jax(nstr, deltam):
    tau, omega, g, alb, sol = _inputs()
    kw = dict(nstr=nstr, deltam=deltam, wchunk=16)   # blocks 16, 16, 16, 2
    want = jdisort(*(jnp.asarray(a) for a in (tau, omega, g)),
                   jnp.float32(MU0), jnp.asarray(alb), jnp.float32(TSI),
                   jnp.asarray(sol), **kw)
    got = disort_shortwave(*(torch.as_tensor(a) for a in (tau, omega, g)),
                           torch.tensor(MU0), torch.as_tensor(alb),
                           torch.tensor(TSI), torch.as_tensor(sol), **kw)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (7, 50) and np.isfinite(a).all()
        scale = np.abs(b).max(axis=1, keepdims=True)
        assert float((np.abs(a - b) / scale).max()) < JAX_TOL


@pytest.mark.parametrize("nstr", [4, 16])
def test_running_only_the_needed_doublings_is_exact(nstr, monkeypatch):
    """A masked step past an element's count changes nothing: with
    _DOUBLINGS cut to the inputs' largest count, the plain loop's fluxes
    equal the 37-step run's bit for bit.  So the card's kernel, which runs
    each element to its own count, computes the same mathematics."""
    tau, omega, g, alb, sol = (torch.as_tensor(a) for a in _inputs())
    tau = torch.clamp(tau, max=2.0)
    kmax = int(disort_mod.sublayers(tau, omega, g, nstr)[3].max())
    assert 10 < kmax < disort_mod._DOUBLINGS
    args = (tau, omega, g, torch.tensor(MU0), alb, torch.tensor(TSI), sol)
    want = disort_shortwave(*args, nstr=nstr, wchunk=16)
    monkeypatch.setattr(disort_mod, "_DOUBLINGS", kmax)
    got = disort_shortwave(*args, nstr=nstr, wchunk=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_layer_operators_take_the_plain_loop_on_the_cpu():
    """On CPU tensors the dispatcher is the plain loop, bit for bit, and
    launches nothing; the kernel's argument checks refuse what it does not
    take."""
    tau, omega, g = (torch.as_tensor(a)[None] for a in _inputs()[:3])
    sub = disort_mod.sublayers(tau, omega, g, 8)
    beams = disort_mod.beam_vectors(torch.tensor([MU0]), 8)
    launches = disort_mod.layer_operators.launches
    got = disort_mod.layer_operators(*sub, torch.tensor([MU0]), *beams)
    want = disort_mod.layer_operators_plain(*sub, torch.tensor([MU0]),
                                            *beams)
    assert disort_mod.layer_operators.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t.shape for t in got] == [(1, 6, 50, 4, 4), (1, 6, 50, 4, 4),
                                      (1, 6, 50, 4), (1, 6, 50, 4),
                                      (1, 6, 50)]
    named = dict(zip(("dtau", "omega", "chi", "k"), sub),
                 mu0=torch.tensor([MU0]), beam_p=beams[0], beam_m=beams[1])
    disort_mod._check_cuda_args(named, 1, 6, 50, 4)
    for name, bad, match in (
            ("k", sub[3].double(), "dtype"),
            ("chi", sub[2][..., :-1].contiguous(), "shape"),
            ("omega", sub[1].transpose(1, 2).contiguous().transpose(1, 2),
             "contiguous")):
        with pytest.raises(ValueError, match=match):
            disort_mod._check_cuda_args(dict(named, **{name: bad}), 1, 6,
                                        50, 4)


def test_batched_equals_per_column_calls():
    rng = np.random.default_rng(2)
    B, nl, nw = 3, 5, 37

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    tau = f32(10.0 ** rng.uniform(-6, 2, (B, nl, nw)))
    omega, g = f32(rng.uniform(0, 1, (B, nl, nw))), \
        f32(rng.uniform(0, 0.9, (B, nl, nw)))
    alb = f32(rng.uniform(0, 0.5, (B, nw)))
    mu, tsi = f32([0.3, 0.6, 0.9]), f32([1361.0, 1300.0, 1200.0])
    sol = f32(rng.uniform(0.5, 1.5, nw))
    for nstr in (4, 16):
        up, dn = disort_shortwave(tau, omega, g, mu, alb, tsi, sol,
                                  nstr=nstr, wchunk=16)
        assert up.shape == dn.shape == (B, nl + 1, nw)
        for b in range(B):
            u, d = disort_shortwave(tau[b], omega[b], g[b], mu[b], alb[b],
                                    tsi[b], sol, nstr=nstr, wchunk=16)
            assert torch.equal(u, up[b]) and torch.equal(d, dn[b])
        # One block instead of three: the same math, but the CPU's matmul
        # may pick another kernel for the larger batch (1e-8 found).
        whole = disort_shortwave(tau, omega, g, mu, alb, tsi, sol,
                                 nstr=nstr, wchunk=2048)
        for a, b in zip(whole, (up, dn)):
            scale = b.abs().amax(-1, keepdim=True)
            assert float(((a - b).abs() / scale).max()) < 1e-6


def test_refuses_reduced_precision_matmuls():
    tau, omega, g, alb, sol = (torch.as_tensor(a) for a in _inputs())
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(ValueError, match="highest"):
            disort_shortwave(tau, omega, g, MU0, alb, TSI, sol, nstr=4)
    finally:
        torch.set_float32_matmul_precision(before)
    assert disort_shortwave(tau, omega, g, MU0, alb, TSI, sol,
                            nstr=4)[0].shape == (7, 50)


@pytest.mark.parametrize("nstr", [0, 3, 7])
def test_gauss_streams_needs_even_count(nstr):
    with pytest.raises(ValueError, match="even"):
        disort_mod.gauss_streams(nstr)
