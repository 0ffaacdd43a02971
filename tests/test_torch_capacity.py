"""The port's host tables at the reference's capacity ceilings: 600,000 lines
per molecule (gas-optics/src/gas_optics.c:46) and 200 layers, the port's
counterpart of tests/test_capacity.py.

* K1's zone tables (``voigt_kernel.build_chunk_ranges``) byte-identical to
  the JAX package's ``pallas_kernels.build_chunk_ranges`` at the same
  arguments, every range of ``zones()`` ordered and inside [lo, hi), no
  int32 wrap;
* K2's bin ranges (``bins.build_bin_ranges``, both modes) byte-identical
  to JAX's, and the kernel's ``bins_kernel.device_tables`` bounds inside
  [0, 600,000] with no int32 wrap;
* ``lines.prepare`` on the catalog's first 4,096 lines at 200 layers (the
  JAX test's slice): finite widths, |frac| <= 0.5 + 1e-6, the center drift
  within ``shift_margin``, and JAX's ``prepare`` outputs on the same
  inputs at tests/test_torch_lines.py's rtol, the strength of the lines
  below ~60 cm-1 with the f32 cancellation of its factor 1 - exp(c2 v / T)
  added.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtcode_tpu.gas_optics import bins as jbins
from grtcode_tpu.gas_optics import lines as jlines
from grtcode_tpu.gas_optics import pallas_kernels as jpk
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.spectral import SpectralGrid as JGrid
from grtcode_tpu_torch import constants
from grtcode_tpu_torch.gas_optics import bins, bins_kernel, lines
from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.spectral import SpectralGrid

L = 600_000          # gas_optics.c:46 MAX_NUM_LINES-equivalent
NLAYERS = 200        # grtcode_config.h level ceiling
GRID = (1.0, 3250.0, 0.1)
SUB = 4096           # tests/test_capacity.py's prep slice
# tests/test_torch_lines.py: f32 device math, torch against XLA.
RTOL = 2e-6
_ARRAYS = ("c0", "frac0", "vnn", "snn", "yair", "yself", "en", "n", "d",
           "iso0")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bound():
    """(JAX GridLines, port GridLines) of tests/test_capacity.py's 600,000
    line catalog on the 1-3250 cm-1 grid at 0.1."""
    rng = np.random.default_rng(0)
    vnn = np.sort(rng.uniform(GRID[0], JGrid(*GRID).last, L))
    s0 = 10.0 ** rng.uniform(-23.5, -19.5, L)
    kw = dict(yair=rng.uniform(0.02, 0.11, L), yself=rng.uniform(0.05, 0.4, L),
              en=rng.uniform(0.0, 2800.0, L), n=rng.uniform(0.35, 0.85, L),
              d=rng.uniform(-0.01, 0.01, L))
    jb = jlines.bind_to_grid(jcatalog(1, vnn, s0, **kw), JGrid(*GRID))
    tb = lines.bind_to_grid(synthetic_catalog(1, vnn, s0, **kw),
                            SpectralGrid(*GRID))
    return jb, tb


def test_catalog_binds_identically(bound):
    jb, tb = bound
    assert tb.num_lines == L
    for name in _ARRAYS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_line_sample_zone_tables_at_600k(bound):
    jb, tb = bound
    grid = SpectralGrid(*GRID)
    fsteps, tile, ch = 250, 64, 32
    margin = lines.shift_margin(tb, grid.dw)
    assert margin == jlines.shift_margin(jb, grid.dw)
    kw = dict(shift_margin=margin, near_hw=20,
              region0_hw=lines.region0_halfwidth(tb, grid.dw))
    want = jpk.build_chunk_ranges(jb.c0, grid.n, fsteps, tile, ch, **kw)
    got = vk.build_chunk_ranges(tb.c0, grid.n, fsteps, tile, ch, **kw)
    for f in dataclasses.fields(got):
        if f.name in ("tile", "ch", "hw", "shift_margin", "_on_device"):
            continue
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert want.lpad >= L

    ntiles = -(-grid.n // tile)
    zones = got.zones()
    assert zones.shape == (ntiles, 10) and zones.dtype == np.int32
    # The int64 arithmetic of zones(), without the int32 cast: no wrap.
    base = got.lo.astype(np.int64)
    wide = np.stack([base] + [base + ch * c.astype(np.int64) for c in (
        got.nchunks, got.cnl, got.cnh, got.m0l, got.m0h, got.fll, got.flh,
        got.frl, got.frh)], axis=1)
    assert np.array_equal(zones.astype(np.int64), wide)
    lo, hi = wide[:, 0], wide[:, 1]
    assert (lo >= 0).all() and (lo <= hi).all()
    assert int(hi.max()) <= -(-L // ch) * ch and int(hi.max()) >= L
    for a, b in ((2, 3), (4, 5), (6, 7), (8, 9)):
        start, end = wide[:, a], wide[:, b]
        assert ((lo <= start) & (start <= end) & (end <= hi)).all(), (a, b)


@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
def test_bin_tables_at_600k(bound, mode):
    jb, tb = bound
    grid = SpectralGrid(*GRID)
    jbn = jbins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    tbn = bins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    want = jbins.build_bin_ranges(jb, jbn, mode=mode)
    got = bins.build_bin_ranges(tb, tbn, mode=mode)
    for name in ("local_lo", "local_cnt", "rem_lo", "rem_cnt_l",
                 "rem_hi_start", "rem_cnt_r"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.lmax_local, got.lmax_remote) == \
        (want.lmax_local, want.lmax_remote)

    table, w_rel, reach = bins_kernel.device_tables(got, tbn, "cpu")
    assert table.dtype == torch.int32 and tuple(table.shape) == (6, tbn.n)
    t = table.numpy().astype(np.int64)
    wide = np.stack([got.local_lo, got.local_cnt, got.rem_lo, got.rem_cnt_l,
                     got.rem_hi_start, got.rem_cnt_r]).astype(np.int64)
    wide[1::2] += wide[0::2]
    assert np.array_equal(t, wide)     # no int32 wrap
    assert (t >= 0).all() and (t <= L).all()
    assert (t[0::2] <= t[1::2]).all()
    assert reach == int(t[1::2].max()) <= L
    if mode == "bin_sweep":
        # Every line is local to some bin (tests/test_capacity.py).
        assert int(t[1].max()) == L and int(got.local_lo.min()) == 0
    assert tuple(w_rel.shape) == (tbn.n, bins.NIP)


def test_prepare_200_layers(bound):
    jb, tb = bound

    def sub(gl, mod):
        return mod.GridLines(gl.mol_id, gl.mass_g, gl.num_iso,
                             *(getattr(gl, name)[:SUB] for name in _ARRAYS))

    jsub, tsub = sub(jb, jlines), sub(tb, lines)
    pavg = np.linspace(1e-4, 1.0, NLAYERS).astype(np.float32)
    tavg = np.linspace(200.0, 310.0, NLAYERS).astype(np.float32)
    psavg = (0.01 * pavg).astype(np.float32)
    want = jlines.prepare(jsub, JGrid(*GRID), jnp.asarray(pavg),
                          jnp.asarray(tavg), jnp.asarray(psavg))
    got = lines.prepare(tsub, SpectralGrid(*GRID), torch.as_tensor(pavg),
                        torch.as_tensor(tavg), torch.as_tensor(psavg))
    assert tuple(got.strength.shape) == (NLAYERS, SUB)
    ci, cf = got.center_idx.numpy(), got.center_frac.numpy()
    assert np.isfinite(got.doppler.numpy()).all()
    assert np.isfinite(got.lorentz.numpy()).all()
    assert (np.abs(cf) <= 0.5 + 1e-6).all()
    # Shift-margin contract: the rounded center never drifts farther than
    # the host margin used to size every range table.
    margin = lines.shift_margin(tsub, 0.1)
    assert int(np.abs(ci - tsub.c0[None, :]).max()) <= margin
    np.testing.assert_array_equal(ci, np.asarray(want.center_idx))
    for name in ("center_frac", "lorentz", "doppler"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12 *
                                   np.abs(b).max(), err_msg=name)
    # The strength's factor 1 - exp(c2 v / T) cancels at the band's low edge
    # (this slice starts at 1 cm-1): torch's and XLA's f32 exp may differ
    # by an ulp each, and the difference becomes kappa = exp(x) / |1 -
    # exp(x)| times as large relative to the strength (kappa ~ 214 at v = 1
    # cm-1, T = 308 K; < 1e-6 beyond ~60 cm-1).
    x = constants.LINE_STRENGTH_C2 * tsub.vnn.astype(np.float64)[None, :] / \
        tavg.astype(np.float64)[:, None]
    kappa = np.exp(x) / np.abs(np.expm1(x))
    a, b = got.strength.numpy(), np.asarray(want.strength)
    rel = np.abs(a - b) / np.abs(b)
    assert (rel <= RTOL + 2 * 2.0 ** -23 * kappa).all(), float(rel.max())
    assert (rel[:, tsub.vnn > 60.0] <= RTOL).all()
