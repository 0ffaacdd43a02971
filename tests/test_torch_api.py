"""The port's public library surface against the JAX package's, on the
same numpy inputs:

* ``SpectralGrid.point_index`` (its range check, rounding, dw*1e-5
  tolerance and errors), equality and hash on (w0, wn, dw);
* ``Optics``: ``zeros``, ``from_tau``, ``num_layers``, ``+``, ``update``
  and ``sample`` with their errors, ``combine`` carrying the grid and
  refusing mismatched grids; ``convert.optics_from_jax`` carries the grid;
* ``rayleigh_optics`` and the C ABI's Rayleigh call through it;
* ``cfc_optical_depth``, ``cia_optical_depth``,
  ``OzoneContinuum.optical_depth``;
* ``LineCatalog.window``, ``q_ratio`` / ``q296`` of both TIPS providers;
* ``CloudOpticsLib.column_optics``;
* the four package ``__init__`` files' exports, and an API-surface walk:
  every module, class, function and method that JAX makes public has a
  counterpart of the same name in the port, but for the short list
  ``SURFACE_EXCLUDED``.

The mirrored JAX tests are tests/test_aux.py:165-180 (update),
tests/test_optics.py (combine, +, sample, zeros), tests/test_spectral.py
(point_index), tests/test_clouds.py:95-110,180-200 (band_to_grid at a
point_index, column_optics with Hu & Stamnes) and
tests/test_hitran.py:65-75 (window).  Elementwise f32 arithmetic in the
same order is held exactly; the cloud optics at the cloud tests' 1e-5.
"""
import ast
import importlib
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtcode_tpu
import grtcode_tpu_torch
from grtcode_tpu import optics as joptics
from grtcode_tpu import spectral as jspectral
from grtcode_tpu.bindings import capi_impl as jcapi
from grtcode_tpu.clouds import beta as jbeta
from grtcode_tpu.clouds import hu_stamnes as jhs
from grtcode_tpu.clouds import lib as jlib
from grtcode_tpu.clouds import pade as jpade
from grtcode_tpu.gas_optics import continua as jcontinua
from grtcode_tpu.gas_optics import hitran as jhitran
from grtcode_tpu.gas_optics import tips as jtips
from grtcode_tpu.gas_optics import xsec as jxsec
from grtcode_tpu.solvers import rayleigh as jrayleigh
from grtcode_tpu_torch import convert, optics, spectral
from grtcode_tpu_torch.bindings import capi_impl
from grtcode_tpu_torch.clouds import beta
from grtcode_tpu_torch.gas_optics import continua, hitran, tips, xsec
from grtcode_tpu_torch.solvers import rayleigh
from grtcode_tpu_torch.utils import prng

REPO = pathlib.Path(__file__).resolve().parents[1]

# JAX public names with no same-named counterpart, and why.
SURFACE_EXCLUDED = {
    # The TPU kernels' modules: their counterparts are
    # gas_optics/voigt_kernel.py and gas_optics/bins_kernel.py.
    "gas_optics/pallas_kernels.py": "module",
    "gas_optics/bins_pallas.py": "module",
    # The TPU tile layout, which K1's zone tables replace.
    "gas_optics/optical_depth.py:accumulate_tiled": "name",
    "gas_optics/optical_depth.py:accumulate_near_pointwise": "name",
    "gas_optics/lines.py:LineTiles": "name",
    "gas_optics/lines.py:PointRanges": "name",
    "gas_optics/lines.py:build_tiles": "name",
    "gas_optics/lines.py:build_point_ranges": "name",
    # The JAX pytree protocol.
    "optics.py:Optics.tree_flatten": "name",
    "optics.py:Optics.tree_unflatten": "name",
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _same(got, want):
    """Exact equality of a port tensor and a JAX array, dtype included."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _raises_alike(port_call, jax_call):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


# -- 1. spectral ------------------------------------------------------------

GRIDS = [(1.0, 100.0, 0.1), (1.0, 3250.0, 0.5), (1.0, 101.0, 2.5),
         (500.0, 600.3, 0.7)]


@pytest.mark.parametrize("w0,wn,dw", GRIDS)
def test_point_index_matches_jax(w0, wn, dw):
    grid, jgrid = spectral.SpectralGrid(w0, wn, dw), \
        jspectral.SpectralGrid(w0, wn, dw)
    rng = np.random.default_rng(0)
    on = w0 + dw * rng.integers(0, grid.n, 200)
    near = on + dw * rng.choice([-2e-6, 2e-6, 5e-6, -5e-6], 200)
    off = on + dw * rng.uniform(-0.49, 0.49, 200)
    for w in [w0, wn, grid.last, *on, *near, *off, w0 - 1e-3, wn + 1e-3,
              2 * wn]:
        w = float(w)
        try:
            want = jgrid.point_index(w)
        except ValueError:
            _raises_alike(lambda: grid.point_index(w),
                          lambda: jgrid.point_index(w))
            continue
        assert grid.point_index(w) == want


def test_point_index_tolerance():
    """tests/test_spectral.py::test_point_index_tolerance on the port."""
    g = spectral.SpectralGrid(1.0, 100.0, 0.1)
    assert g.point_index(1.0) == 0
    assert g.point_index(50.0) == 490
    with pytest.raises(ValueError, match="not located on grid"):
        g.point_index(50.04)
    with pytest.raises(ValueError, match="outside grid"):
        g.point_index(200.0)


def test_grid_equality_and_hash_match_jax():
    a, b, c = (spectral.SpectralGrid(*p) for p in
               ((1.0, 10.0, 0.5), (1.0, 10.0, 0.5), (1.0, 10.0, 0.25)))
    ja, jb, jc = (jspectral.SpectralGrid(*p) for p in
                  ((1.0, 10.0, 0.5), (1.0, 10.0, 0.5), (1.0, 10.0, 0.25)))
    assert (a == b, a == c, a != c) == (ja == jb, ja == jc, ja != jc)
    assert hash(a) == hash(ja) == hash((1.0, 10.0, 0.5))
    assert len({a, b, c}) == len({ja, jb, jc}) == 2
    assert a != (1.0, 10.0, 0.5)


# -- 2. optics --------------------------------------------------------------

def _random_optics(rng, shape):
    return [rng.uniform(lo, hi, shape).astype(np.float32)
            for lo, hi in ((0.0, 2.0), (0.0, 1.0), (-1.0, 1.0))]


def test_combine_and_add_match_jax():
    rng = np.random.default_rng(1)
    grid, jgrid = spectral.SpectralGrid(1.0, 8.0, 1.0), \
        jspectral.SpectralGrid(1.0, 8.0, 1.0)
    fields = [_random_optics(rng, (2, 3, grid.n)) for _ in range(3)]
    # A zero-tau and a zero-omega point exercise both zero denominators.
    for f in fields:
        f[0][0, 0, 0] = 0.0
        f[1][1, 2, 3] = 0.0
    got = optics.combine([optics.Optics(*map(_t, f), grid=grid)
                          for f in fields])
    want = joptics.combine([joptics.Optics(*map(jnp.asarray, f), grid=jgrid)
                            for f in fields])
    for name in ("tau", "omega", "g"):
        _same(getattr(got, name), getattr(want, name))
    assert got.grid == grid
    added = optics.Optics(*map(_t, fields[0]), grid=grid) + \
        optics.Optics(*map(_t, fields[1]))
    jadded = joptics.Optics(*map(jnp.asarray, fields[0]), grid=jgrid) + \
        joptics.Optics(*map(jnp.asarray, fields[1]))
    for name in ("tau", "omega", "g"):
        _same(getattr(added, name), getattr(jadded, name))
    assert added.grid == grid


def test_combine_refuses_mismatched_grids():
    z = np.zeros((2, 10), np.float32)
    a = (spectral.SpectralGrid(1.0, 10.0, 1.0),
         jspectral.SpectralGrid(1.0, 10.0, 1.0))
    b = (spectral.SpectralGrid(2.0, 11.0, 1.0),
         jspectral.SpectralGrid(2.0, 11.0, 1.0))

    def pair(mod, i):
        return [mod.Optics(*(3 * [conv(z)]), grid=g[i])
                for g, conv in ((a, _t if mod is optics else jnp.asarray),
                                (b, _t if mod is optics else jnp.asarray))]

    _raises_alike(lambda: optics.combine(pair(optics, 0)),
                  lambda: joptics.combine(pair(joptics, 1)))
    _raises_alike(lambda: optics.combine([]), lambda: joptics.combine([]))
    # No grid on either side combines, as in JAX; + goes through combine.
    with pytest.raises(ValueError, match="incompatible spectral grids"):
        pair(optics, 0)[0] + pair(optics, 0)[1]
    ungridded = optics.Optics(_t(z), _t(z), _t(z))
    assert optics.combine([ungridded, pair(optics, 0)[1]]).grid is None


def test_zeros_from_tau_and_num_layers():
    """tests/test_optics.py::test_zeros_constructor_batched on the port,
    and from_tau against JAX's."""
    g = spectral.SpectralGrid(1.0, 10.0, 1.0)
    o = optics.Optics.zeros(4, g, batch_shape=(3,), device="cpu")
    jo = joptics.Optics.zeros(4, jspectral.SpectralGrid(1.0, 10.0, 1.0),
                              batch_shape=(3,))
    assert o.tau.shape == jo.tau.shape == (3, 4, g.n)
    assert o.num_layers == jo.num_layers == 4 and o.grid == g
    _same(o.omega, jo.omega)
    assert optics.Optics.zeros(2, g, torch.float64,
                               device="cpu").g.dtype == torch.float64
    tau = np.random.default_rng(2).uniform(0, 1, (5, g.n)).astype(np.float32)
    f = optics.Optics.from_tau(_t(tau), g)
    jf = joptics.Optics.from_tau(jnp.asarray(tau), jo.grid)
    for name in ("tau", "omega", "g"):
        _same(getattr(f, name), getattr(jf, name))
    assert f.grid == g and f.num_layers == 5
    assert optics.Optics.from_tau(_t(tau)).grid is None


def test_update_matches_jax():
    """tests/test_aux.py::test_optics_update on the port, with JAX's
    shape check and message."""
    grid = spectral.SpectralGrid(1.0, 2.0, 0.5)
    jgrid = jspectral.SpectralGrid(1.0, 2.0, 0.5)
    o = optics.Optics.zeros(2, grid, device="cpu")
    jo = joptics.Optics.zeros(2, jgrid)
    o2 = o.update(tau=torch.ones((2, grid.n)))
    jo2 = jo.update(tau=jnp.ones((2, grid.n)))
    for name in ("tau", "omega", "g"):
        _same(getattr(o2, name), getattr(jo2, name))
    assert o2.grid == grid and o2.omega is o.omega
    for name in ("tau", "omega", "g"):
        _raises_alike(lambda: o.update(**{name: torch.ones((3, grid.n))}),
                      lambda: jo.update(**{name: jnp.ones((3, grid.n))}))


def test_sample_matches_jax():
    """tests/test_optics.py::test_sample_strided_subgrid on the port, a
    window of it, and a wider case against JAX."""
    src, dst = spectral.SpectralGrid(1.0, 101.0, 0.5), \
        spectral.SpectralGrid(1.0, 101.0, 2.5)
    jsrc, jdst = jspectral.SpectralGrid(1.0, 101.0, 0.5), \
        jspectral.SpectralGrid(1.0, 101.0, 2.5)
    rng = np.random.default_rng(3)
    fields = _random_optics(rng, (3, 2, src.n))
    fields[0] = np.broadcast_to(np.arange(src.n, dtype=np.float32),
                                (3, 2, src.n)).copy()
    o = optics.Optics(*map(_t, fields), grid=src)
    jo = joptics.Optics(*map(jnp.asarray, fields), grid=jsrc)
    for kw in ({}, dict(w0=11.0, wn=51.0), dict(w0=11.0)):
        s, js = o.sample(dst, **kw), jo.sample(jdst, **kw)
        assert s.grid == dst
        for name in ("tau", "omega", "g"):
            _same(getattr(s, name), getattr(js, name))
            # Views of the source: striding, no averaging.
            assert getattr(s, name)._base is getattr(o, name)
    s = o.sample(dst)
    assert s.tau.shape == (3, 2, dst.n)
    np.testing.assert_array_equal(s.tau[0, 0].numpy(),
                                  np.arange(dst.n, dtype=np.float32) * 5.0)


def test_sample_errors_match_jax():
    src, jsrc = spectral.SpectralGrid(1.0, 101.0, 0.5), \
        jspectral.SpectralGrid(1.0, 101.0, 0.5)
    z = np.zeros((2, src.n), np.float32)
    o = optics.Optics(_t(z), _t(z), _t(z), grid=src)
    jo = joptics.Optics(*(3 * [jnp.asarray(z)]), grid=jsrc)
    cases = [
        (1.0, 101.0, 0.3),     # not a strided subdomain (3 points of 5)
        (1.0, 101.0, 0.25),    # finer than the source
        (1.3, 101.0, 2.5),     # destination start off the source grid
    ]
    for w0, wn, dw in cases:
        _raises_alike(
            lambda: o.sample(spectral.SpectralGrid(w0, wn, dw)),
            lambda: jo.sample(jspectral.SpectralGrid(w0, wn, dw)))
    _raises_alike(lambda: o.sample(src, w0=1.7),
                  lambda: jo.sample(jsrc, w0=1.7))
    bare = optics.Optics(_t(z), _t(z), _t(z))
    jbare = joptics.Optics(*(3 * [jnp.asarray(z)]))
    _raises_alike(lambda: bare.sample(src), lambda: jbare.sample(jsrc))


# -- 3. convert -------------------------------------------------------------

def test_optics_from_jax_carries_the_grid():
    jgrid = jspectral.SpectralGrid(10.0, 20.0, 0.5)
    fields = _random_optics(np.random.default_rng(4), (3, jgrid.n))
    jo = joptics.Optics(*map(jnp.asarray, fields), grid=jgrid)
    o = convert.optics_from_jax(jo, "cpu")
    assert isinstance(o, optics.Optics)
    assert o.grid == spectral.SpectralGrid(10.0, 20.0, 0.5)
    assert isinstance(o.grid, spectral.SpectralGrid)
    for name in ("tau", "omega", "g"):
        _same(getattr(o, name), getattr(jo, name))
    assert convert.optics_from_jax(
        joptics.Optics(*map(jnp.asarray, fields)), "cpu").grid is None


# -- 4. rayleigh ------------------------------------------------------------

def test_rayleigh_optics_matches_jax():
    grid, jgrid = spectral.SpectralGrid(1.0, 50000.0, 10.0), \
        jspectral.SpectralGrid(1.0, 50000.0, 10.0)
    rng = np.random.default_rng(5)
    p = np.sort(rng.uniform(0.01, 1013.0, (3, 12)), axis=1)
    got = rayleigh.rayleigh_optics(p, grid, device="cpu")
    want = jrayleigh.rayleigh_optics(p, jgrid)
    assert got.grid == grid and got.tau.shape == (3, 11, grid.n)
    tau = np.asarray(want.tau)
    # XLA flushes the f32 subnormal intermediate at w -> 1 cm-1 to zero,
    # PyTorch keeps it (tests/test_torch_solvers.py).
    np.testing.assert_allclose(got.tau.numpy(), tau, rtol=1e-5,
                               atol=1e-12 * tau.max())
    _same(got.omega, want.omega)
    _same(got.g, want.g)
    # A tensor input gives the same optics; float64 computes in float64.
    same = rayleigh.rayleigh_optics(torch.as_tensor(p, dtype=torch.float32),
                                    grid, device="cpu")
    assert torch.equal(same.tau, got.tau)
    f64 = rayleigh.rayleigh_optics(p, grid, torch.float64, device="cpu")
    assert f64.tau.dtype == torch.float64
    np.testing.assert_allclose(f64.tau.numpy(), tau, rtol=1e-5,
                               atol=1e-12 * tau.max())


def test_abi_rayleigh_is_rayleigh_optics():
    """The C ABI's grt_rayleigh_scattering goes through rayleigh_optics:
    its optics object holds the same numbers, widened to float64."""
    saved = capi_impl._default_device
    capi_impl._default_device = torch.device("cpu")
    try:
        h = capi_impl.create_spectral_grid(1.0, 30000.0, 10.0)
        p = np.linspace(0.01, 1013.0, 9)
        o = capi_impl.create_optics(8, h)
        assert capi_impl.rayleigh_scattering(o, memoryview(p)) == 0
        want = rayleigh.rayleigh_optics(p, capi_impl._get(h),
                                        device="cpu")
        got = capi_impl._get(o)
        for name in ("tau", "omega", "g"):
            assert got[name].dtype == np.float64
            np.testing.assert_array_equal(
                got[name], getattr(want, name).numpy().astype(np.float64))
        # The numbers of the ABI's former inline body: unchanged.
        from grtcode_tpu_torch import constants
        from grtcode_tpu_torch.utils.curtis_godson import number_densities
        p_atm = torch.as_tensor(p, dtype=torch.float32) * \
            constants.MB_TO_ATM
        before = rayleigh.rayleigh_tau(number_densities(p_atm),
                                       capi_impl._get(h).wavenumbers("cpu"))
        np.testing.assert_array_equal(got["tau"],
                                      before.numpy().astype(np.float64))
        jh = jcapi.create_spectral_grid(1.0, 30000.0, 10.0)
        jo = jcapi.create_optics(8, jh)
        assert jcapi.rayleigh_scattering(jo, memoryview(p)) == 0
        jtau = jcapi._get(jo)["tau"]
        np.testing.assert_allclose(got["tau"], jtau, rtol=1e-5,
                                   atol=1e-12 * jtau.max())
    finally:
        capi_impl._default_device = saved


# -- 5-6. CFC, CIA and ozone adds --------------------------------------------

def _tables(rng, nw):
    sig = rng.uniform(0.0, 1e-18, nw).astype(np.float32)
    jt = jxsec.CrossSectionTable(id=0, name="t",
                                 cross_section=jnp.asarray(sig))
    return sig, jt, xsec.CrossSectionTable(id=0, name="t",
                                           cross_section=_t(sig))


def test_cfc_and_cia_optical_depth_match_jax():
    rng = np.random.default_rng(6)
    nlev, nw = 9, 37
    sig, jt, t = _tables(rng, nw)
    n = rng.uniform(1e22, 1e24, nlev - 1)
    x = rng.uniform(1e-10, 1e-9, nlev)
    _same(xsec.cfc_optical_depth(t, n, x),
          jxsec.cfc_optical_depth(jt, n, x))
    p = np.sort(rng.uniform(0.001, 1.0, nlev))[::-1].copy()
    tavg = rng.uniform(200.0, 300.0, nlev - 1)
    x1, x2 = rng.uniform(0.7, 0.8, nlev), rng.uniform(0.2, 0.21, nlev)
    _same(xsec.cia_optical_depth(t, p, tavg, x1, x2),
          jxsec.cia_optical_depth(jt, p, tavg, x1, x2))
    # A spectral-block slice in place of the table; tensors as inputs.
    xs = sig[5:20]
    _same(xsec.cfc_optical_depth(t, _t(n), _t(x), xs=_t(xs)),
          jxsec.cfc_optical_depth(jt, n, x, xs=jnp.asarray(xs)))
    _same(xsec.cia_optical_depth(t, _t(p), _t(tavg), _t(x1), _t(x2),
                                 xs=_t(xs)),
          jxsec.cia_optical_depth(jt, p, tavg, x1, x2, xs=jnp.asarray(xs)))
    # Batched columns: each column is the one-column call.
    nb = rng.uniform(1e22, 1e24, (3, nlev - 1))
    xb = rng.uniform(1e-10, 1e-9, (3, nlev))
    batched = xsec.cfc_optical_depth(t, nb, xb)
    for b in range(3):
        _same(batched[b], jxsec.cfc_optical_depth(jt, nb[b], xb[b]))


def test_ozone_optical_depth_matches_jax():
    rng = np.random.default_rng(7)
    sig = rng.uniform(0.0, 1e-21, 40).astype(np.float32)
    ns = rng.uniform(1e17, 1e19, 6)
    got = continua.OzoneContinuum(cross_section=_t(sig)).optical_depth(ns)
    want = jcontinua.OzoneContinuum(
        cross_section=jnp.asarray(sig)).optical_depth(ns)
    _same(got, want)
    assert torch.equal(continua.OzoneContinuum(
        cross_section=_t(sig)).optical_depth(_t(ns)), got)


# -- 7. HITRAN window -------------------------------------------------------

def _record(mol, iso_ch, vnn, snn, yair, yself, en, n, d):
    """One 160-char HITRAN2012 record (tests/test_hitran.py::_record)."""
    rec = (f"{mol:2d}{iso_ch}{vnn:12.6f}{snn:10.3E}" + " " * 10 +
           f"{yair:5.4f}"[:5] + f"{yself:5.3f}"[:5] +
           f"{en:10.4f}" + f"{n:4.2f}" + f"{d:8.6f}"[:8])
    return rec + " " * (160 - len(rec))


def test_window_matches_jax(tmp_path):
    """tests/test_hitran.py:65-75 on the port: the parse filter and
    LineCatalog.window keep inclusive bounds."""
    path = tmp_path / "test.par"
    path.write_text("\n".join([
        _record(1, "1", 1000.123456, 1.5e-20, 0.06, 0.3, 100.0, 0.5, 0.001),
        _record(2, "1", 1500.0, 2.0e-20, 0.07, 0.1, 50.0, 0.6, -0.002),
        _record(1, "A", 2000.5, 3.0e-21, 0.05, 0.2, 200.0, 0.7, 0.0),
        _record(1, "2", 3000.0, 4.0e-22, 0.04, 0.4, 300.0, 0.4, 0.003),
    ]) + "\n")
    cat = hitran.parse_par_file(str(path), 1, tips=tips.PowerLawTips())
    jcat = jhitran.parse_par_file(str(path), 1, tips=jtips.PowerLawTips())
    cat_w = hitran.parse_par_file(str(path), 1, w0=1000.123456, wn=2500.0,
                                  tips=tips.PowerLawTips())
    assert cat_w.num_lines == 2
    assert cat.window(1500.0, 3500.0).num_lines == 2
    for lo, hi in ((1500.0, 3500.0), (1000.123456, 2000.5), (0.0, 1e5),
                   (2000.6, 2999.9), (3000.0, 3000.0)):
        got, want = cat.window(lo, hi), jcat.window(lo, hi)
        assert isinstance(got, hitran.LineCatalog)
        assert got.mol_id == want.mol_id == 1
        for f in ("iso", "vnn", "snn", "yair", "yself", "en", "n", "d"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# -- 8. TIPS ---------------------------------------------------------------

def test_q_ratio_and_q296_match_jax(tmp_path):
    """Both providers, the packaged table, and JAX's fallback rules: an
    isotopologue the table lacks takes the principal one's table, a
    molecule it lacks the power law."""
    t = np.array([150.0, 200.0, 250.5, 296.0, 310.25, 400.0])
    path = tmp_path / "tips.npz"
    tgrid = np.linspace(60.0, 500.0, 45)
    np.savez(path, T=tgrid, Q_1_1=150.0 + tgrid ** 1.5 / 10.0,
             Q_1_2=140.0 + tgrid ** 1.4 / 9.0, Q_2_1=200.0 + tgrid)
    pairs = [(tips.TabulatedTips(str(path)), jtips.TabulatedTips(str(path))),
             (tips.PowerLawTips(q296={(7, 2): 3.5}),
              jtips.PowerLawTips(q296={(7, 2): 3.5})),
             (tips.default_tips(), jtips.default_tips())]
    assert isinstance(pairs[2][0], tips.TabulatedTips)
    for port, jax_tips in pairs:
        for mol, iso in ((1, 1), (1, 2), (1, 3), (2, 1), (2, 4), (3, 1),
                         (7, 1), (7, 2), (21, 1), (47, 1)):
            np.testing.assert_array_equal(port.q_ratio(mol, t, iso),
                                          jax_tips.q_ratio(mol, t, iso))
            assert port.q296(mol, iso) == jax_tips.q296(mol, iso)
            np.testing.assert_array_equal(port.q(mol, t, iso),
                                          jax_tips.q(mol, t, iso))


# -- 9. cloud column optics --------------------------------------------------

@pytest.fixture
def exact_jax_betainc(monkeypatch):
    """JAX's clouds with the exact I_x(p, q) (the port's, through a host
    callback) in place of jax.scipy.special.betainc, whose f32 value is
    up to 3e-6 off (tests/test_torch_clouds.py)."""
    def betainc(a, b, x):
        def host(av, bv, xv):
            p, q = int(np.asarray(av).flat[0]), int(np.asarray(bv).flat[0])
            return beta.beta_value(p, q, torch.as_tensor(
                np.array(xv, np.float32))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(jnp.shape(x), jnp.float32), a, b, x,
            vmap_method="broadcast_all")

    monkeypatch.setattr(jbeta, "betainc", betainc)


def _hu_stamnes():
    """The Hu & Stamnes liquid table of tests/test_clouds.py's fixture."""
    rng = np.random.default_rng(7)
    nbins, nbands = 4, 3
    radii = np.array([2.5, 10.0, 20.0, 40.0, 60.0])
    band_lims = np.array([[1.0, 1000.0, 2000.0], [1000.0, 2000.0, 3000.0]])
    a = rng.uniform(0.1, 2.0, (3, nbins, nbands))
    b = rng.uniform(-1.5, -0.2, (3, nbins, nbands))
    c = rng.uniform(0.0, 0.1, (3, nbins, nbands))
    return jhs.HuStamnesLiquidOptics.from_arrays(radii, band_lims, a, b, c)


@pytest.mark.parametrize("liquid", ["pade", "hu_stamnes"])
def test_column_optics_matches_jax(exact_jax_betainc, liquid):
    """One subcolumn and one key on two grids: (liquid, ice) per grid,
    each tagged with its grid, as JAX's; the cloudy layers (the draws)
    are the same layers, the optics within the cloud tests' 1e-5."""
    jliq = (_hu_stamnes() if liquid == "hu_stamnes" else
            jpade.synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0))
    jcl = jlib.CloudOpticsLib(liquid=jliq, ice=jpade.synthetic_pade_table(
        nbnd=16, w0=1.0, wn=50000.0, seed=1))
    port = convert.cloud_lib_from_jax(jcl, "cpu")
    nlay = 12
    rng = np.random.default_rng(12)
    state = dict(
        cloud_fraction=rng.uniform(0.0, 1.0, nlay).astype(np.float32),
        lwc=rng.uniform(0.0, 0.3, nlay).astype(np.float32),
        iwc=rng.uniform(0.0, 0.05, nlay).astype(np.float32),
        t_lay=np.linspace(210.0, 285.0, nlay).astype(np.float32),
        layer_pressure_mb=np.linspace(150.0, 950.0, nlay).astype(np.float32),
        layer_thickness=np.full(nlay, 400.0, np.float32))
    grids = [(500.0, 1500.0, 10.0), (2000.0, 20000.0, 10.0)]
    for seed in (0, 5, 123):
        want = jcl.column_optics(
            jax.random.PRNGKey(seed),
            **{k: jnp.asarray(v) for k, v in state.items()},
            grids=tuple(jspectral.SpectralGrid(*g) for g in grids))
        got = port.column_optics(
            prng.prng_key(seed), **state,
            grids=tuple(spectral.SpectralGrid(*g) for g in grids))
        assert len(got) == len(want) == 2
        for g, pair, jpair in zip(grids, got, want):
            for o, jo in zip(pair, jpair):
                assert o.grid == spectral.SpectralGrid(*g)
                assert jo.grid == jspectral.SpectralGrid(*g)
                wtau = np.asarray(jo.tau)
                assert o.tau.shape == wtau.shape == (
                    nlay, spectral.SpectralGrid(*g).n)
                assert np.array_equal(o.tau.numpy() > 0, wtau > 0)
                for f in ("tau", "omega", "g"):
                    gv, wv = getattr(o, f).numpy(), np.asarray(getattr(jo, f))
                    np.testing.assert_allclose(
                        gv, wv, rtol=1e-5, atol=1e-6 * np.abs(wv).max(),
                        err_msg=f)


def test_column_optics_band_lookup_at_point_index():
    """tests/test_clouds.py:95-110 on the port: a point inside band 3
    (found with point_index) carries band 3's value."""
    from grtcode_tpu_torch.clouds.lib import band_to_grid
    from grtcode_tpu_torch.clouds.pade import synthetic_pade_table

    table = synthetic_pade_table(nbnd=8, w0=100.0, wn=900.0, device="cpu")
    ext, _, _ = table.evaluate(torch.tensor([0.0, 0.3, 0.5]),
                               torch.tensor([10.0, 15.0, 500.0]))
    grid = spectral.SpectralGrid(50.0, 1000.0, 1.0)
    mapped = band_to_grid(ext[1], table.band_lims, grid.wavenumbers("cpu"))
    assert mapped.shape == (grid.n,)
    assert float(mapped[0]) == 0.0 and float(mapped[-1]) == 0.0
    i = grid.point_index(450.0)
    np.testing.assert_allclose(float(mapped[i]), float(ext[1, 3]), rtol=1e-6)


# -- 10. exports and the API surface ----------------------------------------

def _jax_exports(module_file):
    """The names a JAX ``__init__.py`` binds with ``from ... import``."""
    tree = ast.parse((REPO / "grtcode_tpu" / module_file).read_text())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("package", ["", "gas_optics", "solvers",
                                     "framework", "clouds", "utils",
                                     "parallel"])
def test_package_exports_match_jax(package):
    names = _jax_exports(os.path.join(package, "__init__.py"))
    mod = importlib.import_module(
        "grtcode_tpu_torch" + (f".{package}" if package else ""))
    jmod = importlib.import_module(
        "grtcode_tpu" + (f".{package}" if package else ""))
    assert names
    assert [n for n in names if not hasattr(mod, n)] == []
    assert getattr(jmod, "__all__", None) is None or \
        sorted(getattr(mod, "__all__", [])) == sorted(jmod.__all__)
    if package == "gas_optics":
        from grtcode_tpu_torch.gas_optics import GasOptics  # noqa: F401


def _is_public(name):
    return not name.startswith("_") or (
        name.startswith("__") and name.endswith("__")
        and name not in ("__init__", "__post_init__"))


def _jax_surface():
    """(module file, name) for every public class, function and method
    that a module of grtcode_tpu/ defines, and the modules themselves."""
    out = []
    root = REPO / "grtcode_tpu"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        out.append((rel, None))
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                    node.name.startswith("_"):
                continue
            out.append((rel, node.name))
            if isinstance(node, ast.ClassDef):
                out += [(rel, f"{node.name}.{m.name}") for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and _is_public(m.name)]
    return out


def _port_has(rel, name):
    module = "grtcode_tpu_torch." + rel[:-3].replace("/", ".")
    module = module.removesuffix(".__init__")
    try:
        obj = importlib.import_module(module)
    except ModuleNotFoundError:
        return False
    if name is None:
        return True
    head, _, method = name.partition(".")
    if not hasattr(obj, head):
        return False
    obj = getattr(obj, head)
    # A method must be defined on the class (or a base of the port's own),
    # not inherited from object.
    return not method or any(method in vars(k) for k in obj.__mro__
                             if k is not object)


def test_api_surface_matches_jax():
    surface = _jax_surface()
    assert len(surface) > 250
    missing = []
    for rel, name in surface:
        # An excluded class takes its methods with it.
        if SURFACE_EXCLUDED.get(rel) == "module" or any(
                SURFACE_EXCLUDED.get(f"{rel}:{n}") == "name"
                for n in (name, name and name.partition(".")[0])):
            continue
        if not _port_has(rel, name):
            missing.append(rel if name is None else f"{rel}:{name}")
    assert missing == []
    # Every exclusion still names something JAX has and the port lacks.
    for key, kind in SURFACE_EXCLUDED.items():
        rel, _, name = key.partition(":")
        assert (rel, name or None) in surface, key
        assert not _port_has(rel, name or None), key


def test_top_level_exports():
    assert grtcode_tpu_torch.Optics is optics.Optics
    assert grtcode_tpu_torch.combine is optics.combine
    assert grtcode_tpu_torch.SpectralGrid is spectral.SpectralGrid
    assert {"SpectralGrid", "Optics", "combine"} <= set(dir(grtcode_tpu))
