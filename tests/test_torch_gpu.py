"""The port on an NVIDIA GPU: the CUDA line_sample and bin kernels against
their plain PyTorch versions, the clear-sky aerosol-free step on CUDA
tensors (line_sample, and the spectrally streamed bin-method step) and the
all-sky step against the same steps on CPU tensors, the cloud draws on
the card against the CPU's, the discrete-ordinates solver and the
all-sky step with it against the CPU, the CIRC app on the card against
the same app on the CPU, a (1 x 1) mesh in an NCCL group against the
unmeshed step and its all_gather, the native .par scanner, the C
ABI's device selection, its default (the current CUDA device) and
fluxes on the card, and the library surface on the card: Optics.sample
(views of the card's tensors, equal to striding) and rayleigh_optics
against the CPU, the library path's hand-built step equal to the
driver's, the float64 solver check on the card, the
scatter method: on the card against the CPU (also beyond the
line_sample tables' limits and on a block past the grid end), and K1
against it on the card, and the captured steps: each path's replayed
graph bit-identical to its eager step (line_sample, streamed bins,
all-sky, DISORT), the bin kernel and the streamed step on each block's
line window bit-identical to the whole catalog's prep, an eager step
with no host sync, a new lit count in the
same bucket replaying with no new capture, the launch counts advancing on
replay and a failing capture raising; and the
layers' device times read from a replay's timing events, against the
profiler's kernel times, and the driver's step counts.

Every test is marked ``gpu`` and skips without a GPU.  The file imports no
JAX, so it also runs where JAX is not installed; ``tests/conftest.py``
imports JAX, so run it there with the conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from grtcode_tpu_torch import constants, examples
from grtcode_tpu_torch.framework.driver import RadiationDriver
from grtcode_tpu_torch.gas_optics import bins as bm
from grtcode_tpu_torch.gas_optics import bins_kernel as bk
from grtcode_tpu_torch.gas_optics import lines, voigt_kernel as vk
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.kernel_bench import census_bins, census_line_sample
from grtcode_tpu_torch.solvers import disort
from grtcode_tpu_torch.spectral import SpectralGrid
from grtcode_tpu_torch.utils import curtis_godson as cg
from grtcode_tpu_torch.utils import metrics, prng

pytestmark = pytest.mark.gpu

TILE = 32
CH = 16
FSTEPS = 30
NEAR = 4
# The JAX kernel's own parity bar (tests/test_pallas.py:96).
RTOL, ATOL = 2e-6, 1e-12
# The JAX bin kernel's bar against accumulate_bins: rtol 2e-5, atol 2e-6
# of the largest value (tests/test_bins_pallas.py:88-93).
BIN_RTOL, BIN_ATOL = 2e-5, 2e-6
# Integrated fluxes, relative per level with the driver-golden floor (1 %
# of the variable's largest magnitude), the bar of
# tests/test_driver_golden.py:40.
FLUX_TOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _molecule(device, w0=100.0, wn=180.0, n_lines=120, seed=5):
    """tests/test_pallas.py's setup (grid 100-180 cm-1 at 0.1, 120 lines,
    3 x 6 rows), prepared on ``device`` by the port."""
    grid, bound, layers, ns = _molecule_rows(device, w0, wn, n_lines, seed)
    prep = lines.prepare(bound, grid, *layers)
    return grid, bound, prep, ns


def _molecule_rows(device, w0, wn, n_lines, seed):
    """:func:`_molecule`'s grid, bound catalog, (pavg, tavg, psavg) of
    its rows and column densities, before line prep."""
    grid = SpectralGrid(w0, wn, 0.1)
    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(w0 - 10.0, wn + 10.0, n_lines))
    cat = synthetic_catalog(
        1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))
    bound = lines.bind_to_grid(cat, grid)
    nlev, B = 7, 3
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    p_atm = f32(p) * constants.MB_TO_ATM
    n_air = cg.number_densities(p_atm)
    pavg, tavg = cg.layer_pressures_temperatures(p_atm, f32(t))
    psavg, ns = cg.partial_pressures_and_densities(p_atm, f32(x), n_air)
    rows = B * (nlev - 1)
    layers = (pavg.reshape(rows), tavg.reshape(rows), psavg.reshape(rows))
    return grid, bound, layers, ns.reshape(rows).contiguous()


@pytest.fixture(scope="module")
def molecule(cuda):
    grid, bound, prep, ns = _molecule(cuda)
    ranges = vk.build_chunk_ranges(bound.c0, grid.n, FSTEPS, TILE, CH,
                                   shift_margin=2)
    return grid, prep, ns, ranges


@pytest.mark.parametrize("start,nw", [(0, None), (4 * TILE, 4 * TILE),
                                      (20 * TILE, 6 * TILE)])
def test_kernel_matches_plain_version(molecule, start, nw):
    grid, prep, ns, ranges = molecule
    nw = -(-grid.n // TILE) * TILE if nw is None else nw
    kw = dict(num_wpoints=nw, dw=float(grid.dw), fsteps=FSTEPS, near=NEAR,
              num_global=grid.n, start=start)
    launches = vk.accumulate_voigt.launches
    got = vk.accumulate_voigt(prep, ns, ranges, **kw)
    again = vk.accumulate_voigt(prep, ns, ranges, **kw)
    want = vk.voigt_line_sample_reference(prep, ns, **kw)
    torch.cuda.synchronize()
    assert vk.accumulate_voigt.launches == launches + 2
    assert torch.equal(got, again)            # no atomics: bit-identical
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_kernel_adds_into_tau0_in_place(molecule):
    grid, prep, ns, ranges = molecule
    nw = 4 * TILE
    kw = dict(num_wpoints=nw, dw=float(grid.dw), fsteps=FSTEPS, near=NEAR,
              num_global=grid.n)
    tau0 = torch.ones((ns.shape[0], nw), device=ns.device)
    out = vk.accumulate_voigt(prep, ns, ranges, tau0=tau0, **kw)
    alone = vk.accumulate_voigt(prep, ns, ranges, **kw)
    torch.cuda.synchronize()
    assert out is tau0
    np.testing.assert_allclose((out - 1.0).cpu().numpy(),
                               alone.cpu().numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_raises_instead_of_falling_back(molecule):
    grid, prep, ns, ranges = molecule
    plain = vk.voigt_line_sample_reference.launches
    with pytest.raises(ValueError, match="multiple of the tile"):
        vk.accumulate_voigt(prep, ns, ranges, num_wpoints=4 * TILE,
                            dw=float(grid.dw), fsteps=FSTEPS, near=NEAR,
                            num_global=grid.n, start=TILE // 2)
    with pytest.raises(ValueError, match="dtype"):
        vk.accumulate_voigt(prep, ns.double(), ranges, num_wpoints=4 * TILE,
                            dw=float(grid.dw), fsteps=FSTEPS, near=NEAR,
                            num_global=grid.n)
    assert vk.voigt_line_sample_reference.launches == plain


@pytest.fixture(scope="module", params=["light", "heavy"])
def bin_molecule(cuda, request):
    """tests/test_bins_pallas.py's setups: the heavy molecule at 100-180
    cm-1, and the light one at 30,000-30,060 cm-1 whose remote lines fall
    inside Humlicek regions 1-4."""
    if request.param == "heavy":
        return _molecule(cuda)
    return _molecule(cuda, w0=30000.0, wn=30060.0, n_lines=60, seed=11)


def _bin_tables(grid, bound, mode):
    bins = bm.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    return bins, bm.build_bin_ranges(bound, bins, mode=mode)


@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
@pytest.mark.parametrize("start_bin,nbins", [(0, None), (8, 32), (40, 40)])
def test_bin_kernel_matches_plain_version(bin_molecule, mode, start_bin,
                                          nbins):
    grid, bound, prep, ns = bin_molecule
    bins, ranges = _bin_tables(grid, bound, mode)
    kw = dict(start_bin=start_bin, nbins=nbins)
    launches = bk.accumulate_bins_kernel.launches
    fine, coarse = bk.accumulate_bins_kernel(prep, ns, ranges, bins, **kw)
    again = bk.accumulate_bins_kernel(prep, ns, ranges, bins, **kw)
    want_f, want_c = bm.accumulate_bins(prep, ns, ranges, bins, **kw)
    torch.cuda.synchronize()
    assert bk.accumulate_bins_kernel.launches == launches + 2
    assert torch.equal(fine, again[0]) and torch.equal(coarse, again[1])
    for got, want in ((fine, want_f), (coarse, want_c)):
        want = want.cpu().numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=BIN_RTOL,
                                   atol=BIN_ATOL * np.abs(want).max())


def test_bin_kernel_adds_in_place(cuda):
    grid, bound, prep, ns = _molecule(cuda)
    bins, ranges = _bin_tables(grid, bound, "bin_sweep")
    nbins = 16
    fine0 = torch.ones((ns.shape[0], nbins * bins.ppb), device=cuda)
    coarse0 = torch.full((ns.shape[0], nbins, bm.NIP), 2.0, device=cuda)
    fine, coarse = bk.accumulate_bins_kernel(
        prep, ns, ranges, bins, start_bin=8, nbins=nbins, tau0=fine0,
        bins_tau0=coarse0)
    alone = bk.accumulate_bins_kernel(prep, ns, ranges, bins, start_bin=8,
                                      nbins=nbins)
    torch.cuda.synchronize()
    assert fine is fine0 and coarse is coarse0
    np.testing.assert_allclose((fine - 1.0).cpu().numpy(),
                               alone[0].cpu().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((coarse - 2.0).cpu().numpy(),
                               alone[1].cpu().numpy(), rtol=1e-6, atol=1e-6)


def test_bin_kernel_wrapper_raises_instead_of_falling_back(cuda):
    grid, bound, prep, ns = _molecule(cuda)
    bins, ranges = _bin_tables(grid, bound, "bin_sweep")
    plain = bm.accumulate_bins.launches
    with pytest.raises(ValueError, match="dtype"):
        bk.accumulate_bins_kernel(prep, ns.double(), ranges, bins)
    with pytest.raises(ValueError, match="shape"):
        bk.accumulate_bins_kernel(
            prep, ns, ranges, bins, nbins=4,
            tau0=torch.zeros((ns.shape[0], 3), device=cuda))
    assert bm.accumulate_bins.launches == plain


@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
def test_bin_kernel_on_a_block_line_window_is_bit_identical(cuda, mode):
    """K2 on the lines a block reads (the window's prep and the shifted
    ranges) equals K2 on the whole catalog's prep, bit for bit, on each
    of 10 blocks of a band of 3,000 uniform lines over 900 cm-1."""
    grid, bound, layers, ns = _molecule_rows(cuda, 100.0, 999.9, 3000, 7)
    padded = bound.pad_to(3072)
    whole = lines.prepare(padded, grid, *layers)
    bins, ranges = _bin_tables(grid, bound, mode)
    nbins = 88                                       # 10 blocks of 968
    prepped = 0
    for start_bin in range(0, bins.n, nbins):
        lo, hi, shifted = ranges.window(start_bin, nbins, 3072)
        prepped += hi - lo
        prep = lines.prepare(padded, grid, *layers, window=(lo, hi))
        for f in ("center_idx", "center_frac", "strength", "lorentz",
                  "doppler"):
            assert torch.equal(getattr(prep, f),
                               getattr(whole, f)[:, lo:hi]), f
        kw = dict(start_bin=start_bin, nbins=nbins)
        got = bk.accumulate_bins_kernel(prep, ns, shifted, bins, **kw)
        want = bk.accumulate_bins_kernel(whole, ns, ranges, bins, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert want[1].max() > 0
    assert prepped < 0.2 * 10 * 3072


def _fluxes(device, spectral_chunks=None, **model):
    lw, sw, solar, batch, _, _ = examples.rfmip_like(smoke=True,
                                                     device=device, **model)
    res = RadiationDriver(lw, sw, solar).run(examples.atmosphere(batch),
                                             spectral_chunks=spectral_chunks)
    return {k: v.cpu().numpy() for k, v in res.tiers["csaf"].items()}


@pytest.mark.parametrize("case", ["line_sample", "streamed_bins"])
def test_csaf_step_on_the_card_matches_the_cpu(cuda, case):
    model, S = {}, None
    if case == "streamed_bins":
        model, S = dict(lw_method="wavenumber_sweep", lw_res=0.01), 3
    k1, k2 = vk.accumulate_voigt.launches, bk.accumulate_bins_kernel.launches
    plain = (vk.voigt_line_sample_reference.launches,
             bm.accumulate_bins.launches)
    got = _fluxes(cuda, S, **model)
    torch.cuda.synchronize()
    if case == "line_sample":                             # 7 LW + 4 SW
        assert vk.accumulate_voigt.launches - k1 == 11
    else:                                      # 7 LW and 4 SW per block
        assert bk.accumulate_bins_kernel.launches - k2 == 7 * S
        assert vk.accumulate_voigt.launches - k1 == 4 * S
    assert (vk.voigt_line_sample_reference.launches,
            bm.accumulate_bins.launches) == plain
    want = _fluxes("cpu", S, **model)
    for var in ("rlu", "rld", "rsu", "rsd"):
        assert got[var].shape == want[var].shape == (4, 55)
        assert np.isfinite(got[var]).all()
        scale = np.maximum(np.abs(want[var]), 0.01 * np.abs(want[var]).max())
        assert float((np.abs(got[var] - want[var]) / scale).max()) < \
            FLUX_TOL, var


@pytest.mark.parametrize("seed", [0, 123456789])
def test_prng_draws_on_the_card_equal_the_cpu(cuda, seed):
    """Keys, splits, fold-ins over column ids and uniforms: the same bits
    on the card as on the CPU."""
    def draws(device):
        key = prng.split(prng.prng_key(seed, device), 3)[1]
        keys = prng.fold_in(key, torch.arange(0, 4000, 7, device=device))
        kx, kr = prng.split(keys, 2).unbind(-2)
        return keys, prng.uniform(kx, 54), prng.uniform(kr, 53)

    for got, want in zip(draws(cuda), draws("cpu")):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


def test_allsky_step_on_the_card_matches_the_cpu(cuda):
    """examples.allsky_like at smoke size (4 columns, 2 at night): 18 K1
    launches (7 LW + 4 SW lit, 7 LW night), no plain one, and every tier
    within the CSAF step's bar of the CPU run (CSAF rsu alone differs by
    2.1e-5 on an H100, so a 1e-5 bar would fail on the tier the CSAF test
    already holds at 1e-4)."""
    def fluxes(device):
        driver, atm = examples.allsky_like(smoke=True, device=device)
        res = driver.run(atm)
        return {t: {k: v.cpu().numpy() for k, v in fx.items()}
                for t, fx in res.tiers.items()}

    k1, plain = (vk.accumulate_voigt.launches,
                 vk.voigt_line_sample_reference.launches)
    got = fluxes(cuda)
    torch.cuda.synchronize()
    assert vk.accumulate_voigt.launches - k1 == 18
    assert vk.voigt_line_sample_reference.launches == plain
    want = fluxes("cpu")
    assert list(got) == list(want) == ["csaf", "cs", "af"]
    errs = {}
    for tier in want:
        for var in ("rlu", "rld", "rsu", "rsd"):
            g, w = got[tier][var], want[tier][var]
            assert g.shape == w.shape == (4, 55)
            assert np.isfinite(g).all()
            scale = np.maximum(np.abs(w), 0.01 * np.abs(w).max())
            errs[f"{tier} {var}"] = float((np.abs(g - w) / scale).max())
    assert max(errs.values()) < FLUX_TOL, errs
    assert not np.allclose(got["af"]["rlu"], got["csaf"]["rlu"])


# ---------------------------------------------------------------------------
# Lines placed on every zone boundary, every Humlicek region and both y
# limits (prepared lines built directly, so the cases are exact)
# ---------------------------------------------------------------------------

PLACED_Y = (0.0, 1e-7, 0.01, 0.5, 2.0, 5.0, 9.0, 70.6, 300.0)


def _placed_lines(device, c0, repwid_range, seed):
    """PreparedLines on len(PLACED_Y) rows for unshifted centers ``c0``:
    row r has y = PLACED_Y[r] (0 and 1e-7 below the tiny-y limit 1e-6;
    70.6 and 300 pure Lorentz), every line's per-row center is c0 - 1, c0
    or c0 + 1 in turn, and sqrt(ln2) / alpha_d is drawn log-uniformly from
    ``repwid_range``.  Column densities 1e20, so S n / 1e20 = S."""
    rng = np.random.default_rng(seed)
    rows, L = len(PLACED_Y), len(c0)
    shift = (np.arange(rows)[:, None] + np.arange(L)[None, :]) % 3 - 1
    repwid = np.exp(rng.uniform(*np.log(repwid_range), (rows, L)))
    y = np.asarray(PLACED_Y)[:, None] * np.ones((1, L))

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)

    prep = lines.PreparedLines(
        torch.as_tensor((c0[None, :] + shift).astype(np.int32),
                        device=device),
        f32(rng.uniform(-0.5, 0.5, (rows, L))),
        f32(rng.uniform(0.1, 1.0, (rows, L))),
        f32(y / repwid), f32(constants.SQRT_LN2 / repwid))
    return prep, torch.full((rows,), 1e20, device=device)


# K1 case: 640 points at 0.1, tile 32, chunks of 8, fsteps 100, near 3 and
# one line at every point from 3 below the grid to 3 above it.  With
# sqrt(ln2) / alpha_d >= 38, |x| >= (34 - 1/2) 0.1 * 38 > 124 beyond 33
# points: the region-0 half-width the tables are given.
ZONE_N, ZONE_TILE, ZONE_CH, ZONE_FSTEPS, ZONE_NEAR, ZONE_R0 = \
    640, 32, 8, 100, 3, 33


def placed_line_sample_case(device):
    c0 = np.arange(-3, ZONE_N + 3)
    prep, ns = _placed_lines(device, c0, (38.0, 60.0), seed=21)
    ranges = vk.build_chunk_ranges(c0, ZONE_N, ZONE_FSTEPS, ZONE_TILE,
                                   ZONE_CH, shift_margin=2,
                                   near_hw=ZONE_NEAR + 2, region0_hw=ZONE_R0)
    return prep, ns, ranges


def placed_bins_case(device):
    """K2 case: the same grid in bins of 11 points, a line every third
    point (and off both ends) with sqrt(ln2) / alpha_d in [2, 500], so fine
    and remote samples fall in every region and some lines' fine samples
    in a tile are all region 0."""
    c0 = np.arange(-4, ZONE_N + 4, 3)
    prep, ns = _placed_lines(device, c0, (2.0, 500.0), seed=22)
    zeros = np.zeros(len(c0), np.float32)
    bound = lines.GridLines(
        mol_id=1, mass_g=18.0, num_iso=1, c0=c0.astype(np.int32),
        frac0=zeros, vnn=zeros + 100.0, snn=zeros, yair=zeros, yself=zeros,
        en=zeros, n=zeros, d=zeros, iso0=np.zeros(len(c0), np.int32))
    bins = bm.create_spectral_bins(ZONE_N, 100.0, 0.1, 1.0)
    return prep, ns, bound, bins


@pytest.mark.parametrize("start,nw", [(0, ZONE_N), (5 * ZONE_TILE,
                                                    6 * ZONE_TILE)])
def test_kernel_on_zone_boundaries_and_y_limits(cuda, start, nw):
    """K1 with lines on every tile +- reach0 and +- near boundary, near =
    3, y <= 1e-6 and y >= 70.55 rows, samples in every Humlicek region, the
    interior, edge and core-adjacent zones all present, at block start 0
    and > 0: the plain version's values, and bit-identical reruns."""
    prep, ns, ranges = placed_line_sample_case(cuda)
    interior = (ranges.flh - ranges.fll) + (ranges.frh - ranges.frl)
    assert interior.sum() > 0 and (ranges.m0h > ranges.m0l).all()
    kw = dict(num_wpoints=nw, dw=0.1, fsteps=ZONE_FSTEPS, near=ZONE_NEAR,
              num_global=ZONE_N, start=start)
    got = vk.accumulate_voigt(prep, ns, ranges, **kw)
    again = vk.accumulate_voigt(prep, ns, ranges, **kw)
    want = vk.voigt_line_sample_reference(prep, ns, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    cen = census_line_sample(prep, ranges, **kw)
    assert all(cen["samples"][c] > 0 for c in (
        "region1", "region2", "region3", "region4a", "lorentz"))


@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
@pytest.mark.parametrize("start_bin,nbins", [(0, None), (8, 24)])
def test_bin_kernel_in_every_region_and_y_limit(cuda, mode, start_bin,
                                                nbins):
    """K2 with upper-atmosphere rows whose fine and remote samples fall in
    Humlicek regions 1-4, y <= 1e-6 and y >= 70.55 rows, lines off both
    grid ends, at start_bin 0 and > 0: the plain version's values within
    its bar, and bit-identical reruns."""
    prep, ns, bound, bins = placed_bins_case(cuda)
    ranges = bm.build_bin_ranges(bound, bins, mode=mode)
    kw = dict(start_bin=start_bin, nbins=nbins)
    got = bk.accumulate_bins_kernel(prep, ns, ranges, bins, **kw)
    again = bk.accumulate_bins_kernel(prep, ns, ranges, bins, **kw)
    want = bm.accumulate_bins(prep, ns, ranges, bins, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=BIN_RTOL,
                                   atol=BIN_ATOL * np.abs(w).max())
    cen = census_bins(prep, ranges, bins, start_bin=start_bin,
                      nbins=bins.n - start_bin if nbins is None else nbins)
    assert all(cen["fine_samples"][c] > 0 for c in (
        "region0", "region1", "region2", "region3", "region4a", "lorentz"))


# ---------------------------------------------------------------------------
# DISORT and the CIRC app
# ---------------------------------------------------------------------------

# Card against CPU for the discrete-ordinates solver: per level, of the
# level's largest flux (the bar the port holds against JAX on the CPU,
# tests/test_torch_disort.py, is 1e-5).
DISORT_TOL = 1e-5


def _disort_inputs(B, nlayers, nw, seed=3):
    rng = np.random.default_rng(seed)
    tau = 10.0 ** rng.uniform(-6, 2, (B, nlayers, nw))
    tau[:, 0, :4] = [0.0, 1e-12, 1e12, 1e-5 * 2 ** 7]
    return [torch.as_tensor(a, dtype=torch.float32) for a in (
        tau, rng.uniform(0, 1, (B, nlayers, nw)),
        rng.uniform(-0.2, 0.9, (B, nlayers, nw)),
        rng.uniform(0.05, 1.0, B), rng.uniform(0, 0.5, (B, nw)),
        rng.uniform(1000, 1400, B), rng.uniform(0.5, 1.5, nw))]


@pytest.mark.parametrize("nstr", [4, 16])
def test_disort_on_the_card_matches_the_cpu(cuda, nstr):
    from grtcode_tpu_torch.solvers.disort import disort_shortwave
    args = _disort_inputs(3, 12, 300)
    kw = dict(nstr=nstr, wchunk=128)                 # blocks 128, 128, 44
    got = disort_shortwave(*(a.to(cuda) for a in args), **kw)
    want = disort_shortwave(*args, **kw)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == w.shape == (3, 13, 300)
        g, w = g.cpu().numpy(), w.numpy()
        assert np.isfinite(g).all()
        scale = np.abs(w).max(axis=-1, keepdims=True)
        assert float((np.abs(g - w) / scale).max()) < DISORT_TOL


def _doubling_inputs(B, nlayers, nw, device, seed=11):
    """Layers whose doubling counts span 0-37: tau log-uniform over
    1e-9-0.3, at every 8th wavenumber over 0.3-1e7 in every layer, and in
    the first layer at 0, 1e-12, 1e-5, 2e-5, at the clamp (1e6) and
    beyond it (1e12).  omega stays under 0.99: a thick layer that scatters
    nearly conservatively is ill-conditioned in float32, and there the
    masked loop on the card and on the CPU differ by up to 0.6 of the
    layer's largest R entry, so no float32 version is a yardstick for
    another (tests/test_torch_disort.py holds conservative scattering)."""
    rng = np.random.default_rng(seed)
    tau = 10.0 ** rng.uniform(-9, -0.5, (B, nlayers, nw))
    tau[..., ::8] = 10.0 ** rng.uniform(-0.5, 7, tau[..., ::8].shape)
    omega = rng.uniform(0, 0.99, (B, nlayers, nw))
    g = rng.uniform(-0.2, 0.9, (B, nlayers, nw))
    tau[:, 0, :6] = [0.0, 1e-12, 1e-5, 2e-5, 1e6, 1e12]
    g[:, 0, 4:6] = 0.0
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (
        tau, omega, g, rng.uniform(0.05, 1.0, B), rng.uniform(0, 0.5, (B, nw)),
        rng.uniform(1000, 1400, B), rng.uniform(0.5, 1.5, nw))]


def _lockstep_run(k, nstr):
    """The element-steps the doubling kernel's warps run in lockstep:
    a warp holds 32 / h consecutive elements of ``k`` (one lane a row, h =
    nstr / 2 rows), and runs its largest count for each."""
    group = 32 // (nstr // 2)
    k = k.reshape(-1).astype(np.int64)
    return sum(int(k[s:s + group].max()) * k[s:s + group].size
               for s in range(0, k.size, group))


@pytest.mark.parametrize("nstr,B,nw", [(16, 1, 2048), (16, 1, 848),
                                       (16, 32, 2048), (8, 1, 2048),
                                       (4, 1, 848)])
def test_doubling_kernel_matches_the_plain_version(cuda, nstr, B, nw):
    """The doubling kernel against the plain masked loop on the card, on
    the CIRC cell's blocks (one column, 54 layers, 2,048 points and the
    848-point tail), chip_smoke.py's 32-column block and the other two
    stream counts: R, T, sr, st and d within DISORT_TOL of the layer's
    largest entry, one launch, the needed steps equal, the run steps the
    warps' lockstep steps."""
    tau, omega, g, mu0 = _doubling_inputs(B, 54, nw, cuda)[:4]
    sub = disort.sublayers(tau, omega, g, nstr)
    k = sub[3].cpu().numpy()
    assert k.min() == 0 and k.max() == 37
    beams = disort.beam_vectors(mu0, nstr)
    counts = metrics.DoublingCounts(cuda)
    plain_counts = metrics.DoublingCounts(cuda)
    launches = disort.layer_operators.launches
    got = disort.layer_operators(*sub, mu0, *beams, doublings=counts)
    want = disort.layer_operators_plain(*sub, mu0, *beams,
                                        doublings=plain_counts)
    torch.cuda.synchronize()
    assert disort.layer_operators.launches == launches + 1
    for name, a, b in zip(("R", "T", "sr", "st", "d"), got, want):
        assert a.shape == b.shape and a.device.type == "cuda", name
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), name
        axes = tuple(range(2, b.ndim))
        scale = np.abs(b).max(axis=axes, keepdims=True)
        err = np.abs(a - b) / np.maximum(scale, 1e-30)
        assert float(err.max()) < DISORT_TOL, (name, float(err.max()))
    got_counts, want_counts = counts.read(), plain_counts.read()
    assert got_counts["needed"] == want_counts["needed"] == int(k.sum())
    assert want_counts["run"] == 37 * k.size
    assert got_counts["run"] == _lockstep_run(k, nstr)


def test_disort_on_the_card_runs_the_kernel_not_the_loop(cuda, monkeypatch):
    """disort_shortwave on the CIRC cell's blocks (one column, 54 layers,
    a 2,048-point block and the 848-point tail): one kernel launch a
    block and no masked loop, fluxes within DISORT_TOL of the level's
    largest flux of the plain loop's on the card, the same needed steps;
    a stream count the kernel is not built for raises, naming those it
    is."""
    args = _doubling_inputs(1, 54, 2048 + 848, cuda)
    plain = disort.layer_operators_plain

    def no_loop(dtau, *a, **kw):
        assert dtau.device.type == "cpu", "the masked loop ran on the card"
        return plain(dtau, *a, **kw)
    monkeypatch.setattr(disort, "layer_operators_plain", no_loop)
    counts = metrics.DoublingCounts(cuda)
    launches = disort.layer_operators.launches
    got = disort.disort_shortwave(*args, doublings=counts)
    torch.cuda.synchronize()
    assert disort.layer_operators.launches == launches + 2
    with pytest.raises(ValueError, match="built for nstr 4, 8, 16"):
        disort.disort_shortwave(*args, nstr=6)
    monkeypatch.setattr(disort, "layer_operators", plain)
    plain_counts = metrics.DoublingCounts(cuda)
    want = disort.disort_shortwave(*args, doublings=plain_counts)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (1, 55, 2896)
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all()
        scale = np.abs(b).max(axis=-1, keepdims=True)
        assert float((np.abs(a - b) / scale).max()) < DISORT_TOL
    assert counts.read()["needed"] == plain_counts.read()["needed"]


def _cloud_layers(nstr, seed=17, nlayers=24, nw=256):
    """A column with a thick cloud that scatters almost without
    absorption, as the cs / af tiers' liquid and ice layers: 6 layers of
    tau log-uniform over 10-1e3, omega in [0.99, 1), g in [0.75, 0.9]
    (k 20-27), under and over clear layers (tau 1e-4-0.1, g under 0.3)."""
    rng = np.random.default_rng(seed + nstr)
    tau = 10.0 ** rng.uniform(-4, -1, (nlayers, nw))
    omega = rng.uniform(0.0, 1.0, (nlayers, nw))
    g = rng.uniform(0.0, 0.3, (nlayers, nw))
    cloud = slice(10, 16)
    tau[cloud] = 10.0 ** rng.uniform(1, 3, tau[cloud].shape)
    omega[cloud] = rng.uniform(0.99, 1.0, tau[cloud].shape)
    g[cloud] = rng.uniform(0.75, 0.9, tau[cloud].shape)
    return tau, omega, g, rng.uniform(0.0, 0.3, nw), rng.uniform(0.5, 1.5, nw)


def _gap_by_layer(got, want):
    """The largest |got - want| over the elements of ``want``'s
    (column, layer), as a share of that layer's largest |want| entry."""
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    assert np.isfinite(got).all()
    axes = tuple(range(2, want.ndim))
    scale = np.abs(want).max(axis=axes, keepdims=True)
    return float((np.abs(got - want) / np.maximum(scale, 1e-300)).max())


@pytest.mark.parametrize("nstr", [4, 16])
def test_doubling_kernel_on_clouds_against_the_float64_reference(
        cuda, monkeypatch, nstr):
    """Thick near-conservative cloud layers, where float32 doubling is
    ill-conditioned and no float32 version is a yardstick for another.
    (a) Each layer's R, T, sr, st and d by the kernel, by the masked loop
    on the card and by the masked loop on the CPU, against the masked
    loop in float64 on the same inputs (the same method's arithmetic):
    the kernel's gap, of each layer's largest entry, is at most twice the
    larger of the two float32 loops' (they round in other orders, with
    other exp, and differ from each other by up to 2.7x here; a kernel
    that pivots or accumulates wrongly reads orders of magnitude more).
    (b) The fluxes of the three
    against the benchmark's float64 discrete-ordinates reference
    (rtbench/reference/sw_disort.py), of each wavenumber's largest flux:
    the doubling's own method error is common to all three (a float64
    copy of the loop reads the same gap), and the kernel's gap exceeds
    the larger of the loops' by no more than DISORT_TOL."""
    from rtbench.reference import sw_disort
    mu0, tsi = 0.6707, 1361.0
    layers = _cloud_layers(nstr)
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in layers]
    mu0_t = torch.tensor([mu0])
    sub = disort.sublayers(*(t[None] for t in f32[:3]), nstr)
    args = (*sub, mu0_t, *disort.beam_vectors(mu0_t, nstr))
    witness = disort.layer_operators_plain(*(a.double() for a in args))
    operators = {
        "kernel": disort.layer_operators(*(a.to(cuda) for a in args)),
        "card_loop": disort.layer_operators_plain(
            *(a.to(cuda) for a in args)),
        "cpu_loop": disort.layer_operators_plain(*args)}
    gaps = {name: {way: _gap_by_layer(ops[i], witness[i])
                   for way, ops in operators.items()}
            for i, name in enumerate(("R", "T", "sr", "st", "d"))}
    for gap in gaps.values():
        assert gap["kernel"] <= 2 * max(gap["card_loop"], gap["cpu_loop"]), \
            gaps

    f64 = [torch.as_tensor(a, dtype=torch.float64) for a in layers]
    want = sw_disort.fluxes(*f64[:3], mu0, f64[3],
                            torch.tensor(tsi, dtype=torch.float64), f64[4],
                            config={"disort_streams": nstr})

    def flux_gaps(device):
        a = [t.to(device) for t in f32]
        got = disort.disort_shortwave(
            *a[:3], torch.tensor(mu0, device=device), a[3],
            torch.tensor(tsi, device=device), a[4], nstr=nstr)
        out = []
        for g, w in zip(got, want):
            g, w = g.cpu().double().numpy(), w.double().numpy()
            assert np.isfinite(g).all()
            out.append(float(np.max(np.abs(g - w) / np.abs(w).max(
                axis=0, keepdims=True))))
        return out

    launches = disort.layer_operators.launches
    kernel = flux_gaps(cuda)
    assert disort.layer_operators.launches == launches + 1
    cpu_loop = flux_gaps("cpu")
    monkeypatch.setattr(disort, "layer_operators",
                        disort.layer_operators_plain)
    card_loop = flux_gaps(cuda)
    for k, a, b in zip(kernel, card_loop, cpu_loop):
        assert k <= max(a, b) + DISORT_TOL, (kernel, card_loop, cpu_loop)


def test_allsky_disort_step_on_the_card_matches_the_cpu(cuda):
    """examples.allsky_like at smoke size with the 4-stream DISORT in
    place of the two-stream solver, liquid and ice clouds (the cell's
    physical ice table, examples.ice_pade_table): 18 K1 launches, no
    plain one, every tier finite and within FLUX_TOL of the CPU run."""
    import dataclasses

    def fluxes(device):
        driver, atm = examples.allsky_like(smoke=True, device=device)
        assert atm.ice_water_content.any()
        res = dataclasses.replace(driver, sw_solver="disort",
                                  disort_streams=4).run(atm)
        return {t: {k: v.cpu().numpy() for k, v in fx.items()}
                for t, fx in res.tiers.items()}

    k1, plain = (vk.accumulate_voigt.launches,
                 vk.voigt_line_sample_reference.launches)
    got = fluxes(cuda)
    torch.cuda.synchronize()
    assert vk.accumulate_voigt.launches - k1 == 18
    assert vk.voigt_line_sample_reference.launches == plain
    want = fluxes("cpu")
    for tier in ("csaf", "cs", "af"):
        for var in ("rlu", "rld", "rsu", "rsd"):
            g, w = got[tier][var], want[tier][var]
            assert g.shape == w.shape == (4, 55) and np.isfinite(g).all()
            scale = np.maximum(np.abs(w), 0.01 * np.abs(w).max())
            assert float((np.abs(g - w) / scale).max()) < FLUX_TOL, \
                (tier, var)


def test_circ_app_on_the_card_matches_the_cpu(cuda, tmp_path, capsys):
    """``apps.circ.main`` on the driver golden's input files at the CLI
    tests' coarse grids (LW at 4, SW at 10 cm-1) on ``cuda:0`` (the app's
    default device) and on the CPU: the app registers its 7 molecules in
    each band (CO and O2 have no lines in this file and launch on padding
    alone), so 14 K1 launches and no plain one; fluxes within FLUX_TOL."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch.apps import circ

    d = str(tmp_path)
    driver_inputs.write_inputs(d)
    argv = [os.path.join(d, "synthetic.par"), os.path.join(d, "solar.csv"),
            "-h2o-ctm", os.path.join(d, "h2o_ctm"), "-o3-ctm",
            os.path.join(d, "o3_ctm.csv"), "-CFC-11",
            os.path.join(d, "cfc11.csv"), "-N2-N2",
            os.path.join(d, "cia_n2n2.csv"), "-o", "", "-r-lw", "4.0",
            "-r-sw", "10.0"]
    k1, plain = (vk.accumulate_voigt.launches,
                 vk.voigt_line_sample_reference.launches)
    got = circ.main(argv)
    torch.cuda.synchronize()
    assert got.tiers["csaf"]["rlu"].device.type == "cuda"
    assert vk.accumulate_voigt.launches - k1 == 14
    assert vk.voigt_line_sample_reference.launches == plain
    want = circ.main(argv, device="cpu")
    assert "RSDTCSAF" in capsys.readouterr().out
    for var in ("rlu", "rld", "rsu", "rsd"):
        g = got.tiers["csaf"][var].cpu().numpy()
        w = want.tiers["csaf"][var].numpy()
        assert g.shape == w.shape == (1, 55) and np.isfinite(g).all()
        scale = np.maximum(np.abs(w), 0.01 * np.abs(w).max())
        assert float((np.abs(g - w) / scale).max()) < FLUX_TOL, var


def test_nccl_mesh_of_one_equals_the_unmeshed_step(cuda, tmp_path):
    """A world of one NCCL rank on cuda:0 and make_mesh(1, 1): the
    line_sample cell at smoke size, bit-identical to run() without a
    mesh; the mesh's all_gather of a CUDA tensor along each axis (NCCL,
    no host copy) returns it bit for bit on cuda:0."""
    import torch.distributed as dist
    from grtcode_tpu_torch.framework.driver import _mesh_all_gather
    from grtcode_tpu_torch.parallel import distributed, make_mesh
    from grtcode_tpu_torch.parallel.mesh import COLUMNS_AXIS, SPECTRAL_AXIS

    lw, sw, sol, batch, B, nlay = examples.rfmip_like(smoke=True,
                                                      device=cuda)
    driver = RadiationDriver(lw, sw, sol)
    atm = examples.atmosphere(batch)
    dev = distributed.initialize(f"file://{tmp_path}/store", 1, 0,
                                 timeout_s=60)
    try:
        assert dev.type == "cuda" and dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        got = driver.run(atm, mesh=mesh).tiers["csaf"]
        want = driver.run(atm).tiers["csaf"]
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        for axis in (COLUMNS_AXIS, SPECTRAL_AXIS):
            (part,) = _mesh_all_gather(mesh, axis, got["rsd"])
            assert part.device == dev
            assert part.data_ptr() != got["rsd"].data_ptr()
            assert torch.equal(part.view(torch.int32),
                               got["rsd"].view(torch.int32))
    finally:
        dist.destroy_process_group()


def test_native_scanner_parses_on_the_card_machine(tmp_path):
    """The .par scanner builds with g++ here and every parse takes it."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch import native
    from grtcode_tpu_torch.gas_optics import hitran

    driver_inputs.write_inputs(str(tmp_path))
    assert native.available()
    before = dict(hitran.parse_par_file.parses)
    cat = hitran.parse_par_file(str(tmp_path / "synthetic.par"), 1)
    assert cat.num_lines > 0
    assert hitran.parse_par_file.parses["native"] == before["native"] + 1
    assert hitran.parse_par_file.parses["python"] == before["python"]


def test_c_abi_selects_the_card_and_matches_the_direct_call(cuda):
    """grt_create_device(0) is cuda:0, and longwave fluxes through the
    ABI on the card equal the port's direct call bit for bit."""
    import ctypes
    from grtcode_tpu_torch import bindings
    from grtcode_tpu_torch.bindings import capi_impl
    from grtcode_tpu_torch.solvers.longwave import longwave_fluxes

    lib = bindings.load()
    assert lib.grt_initialize() == 0
    dev = ctypes.c_int64()
    assert lib.grt_create_device(ctypes.c_int(0), ctypes.byref(dev)) == 0
    assert lib.grt_use_device(dev) == 0
    assert capi_impl._default_device == torch.device("cuda", 0)
    nlayers, w0, nw = 6, 500.0, 64
    grid, opt = ctypes.c_int64(), ctypes.c_int64()
    assert lib.grt_create_spectral_grid(
        ctypes.c_double(w0), ctypes.c_double(w0 + nw - 1),
        ctypes.c_double(1.0), ctypes.byref(grid)) == 0
    assert lib.grt_create_optics(ctypes.c_int(nlayers), grid,
                                 ctypes.byref(opt)) == 0
    rng = np.random.default_rng(3)
    tau = rng.uniform(0.01, 2.0, (nlayers, nw))
    capi_impl._get(opt.value)["tau"][:] = tau
    tlev = np.linspace(220.0, 290.0, nlayers + 1)
    emis = np.full(nw, 0.97)
    up = np.zeros((nlayers + 1) * nw)
    down = np.zeros_like(up)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    assert lib.grt_longwave_fluxes(opt, ctypes.c_double(293.0), ptr(tlev),
                                   None, ptr(emis), ptr(up), ptr(down)) == 0

    def f32(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=torch.float32,
                               device=cuda)

    want = longwave_fluxes(
        f32(tau), f32(np.zeros_like(tau)), f32(np.float32(293.0)),
        f32(0.5 * (tlev[:-1] + tlev[1:])), f32(tlev), f32(emis),
        SpectralGrid(w0, w0 + nw - 1, 1.0).wavenumbers(cuda))
    assert up.tobytes() == want[0].cpu().numpy().astype(
        np.float64).ravel().tobytes()
    assert down.tobytes() == want[1].cpu().numpy().astype(
        np.float64).ravel().tobytes()


def test_c_abi_defaults_to_the_card(cuda, monkeypatch):
    """With no device selected the ABI computes on the current CUDA
    device: its longwave fluxes equal the port's direct call on cuda:0
    bit for bit."""
    import ctypes
    from grtcode_tpu_torch import bindings
    from grtcode_tpu_torch.bindings import capi_impl
    from grtcode_tpu_torch.solvers.longwave import longwave_fluxes

    lib = bindings.load()
    assert lib.grt_initialize() == 0
    monkeypatch.setattr(capi_impl, "_default_device", None)
    assert capi_impl._device() == torch.device("cuda", 0)
    nlayers, w0, nw = 5, 800.0, 48
    grid, opt = ctypes.c_int64(), ctypes.c_int64()
    assert lib.grt_create_spectral_grid(
        ctypes.c_double(w0), ctypes.c_double(w0 + nw - 1),
        ctypes.c_double(1.0), ctypes.byref(grid)) == 0
    assert lib.grt_create_optics(ctypes.c_int(nlayers), grid,
                                 ctypes.byref(opt)) == 0
    tau = np.random.default_rng(5).uniform(0.01, 2.0, (nlayers, nw))
    capi_impl._get(opt.value)["tau"][:] = tau
    tlev = np.linspace(215.0, 295.0, nlayers + 1)
    emis = np.full(nw, 0.95)
    up = np.zeros((nlayers + 1) * nw)
    down = np.zeros_like(up)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    assert lib.grt_longwave_fluxes(opt, ctypes.c_double(297.0), ptr(tlev),
                                   None, ptr(emis), ptr(up), ptr(down)) == 0
    assert capi_impl._default_device is None

    def f32(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=torch.float32,
                               device=cuda)

    want = longwave_fluxes(
        f32(tau), f32(np.zeros_like(tau)), f32(np.float32(297.0)),
        f32(0.5 * (tlev[:-1] + tlev[1:])), f32(tlev), f32(emis),
        SpectralGrid(w0, w0 + nw - 1, 1.0).wavenumbers(cuda))
    assert up.tobytes() == want[0].cpu().numpy().astype(
        np.float64).ravel().tobytes()
    assert down.tobytes() == want[1].cpu().numpy().astype(
        np.float64).ravel().tobytes()


def test_optics_sample_on_the_card(cuda):
    """Optics.sample from a 0.1 to a 1.0 sub-grid picks every tenth point
    on the card, as views, equal to the CPU's."""
    from grtcode_tpu_torch import Optics

    src, dst = SpectralGrid(1.0, 3250.0, 0.1), SpectralGrid(1.0, 3250.0, 1.0)
    gen = torch.Generator().manual_seed(0)
    cpu = Optics(*(torch.rand((3, 5, src.n), generator=gen)
                   for _ in range(3)), grid=src)
    card = Optics(cpu.tau.to(cuda), cpu.omega.to(cuda), cpu.g.to(cuda),
                  grid=src)
    got, want = card.sample(dst), cpu.sample(dst)
    assert got.grid == dst and got.tau.device.type == "cuda"
    for name in ("tau", "omega", "g"):
        t = getattr(got, name)
        assert t.data_ptr() == getattr(card, name).data_ptr()
        assert torch.equal(t, getattr(card, name)[..., ::10])
        assert torch.equal(t.cpu(), getattr(want, name))


def test_rayleigh_optics_on_the_card_matches_the_cpu(cuda):
    from grtcode_tpu_torch.solvers import rayleigh_optics

    grid = SpectralGrid(1.0, 50000.0, 1.0)
    p = np.sort(np.random.default_rng(3).uniform(0.01, 1013.0, (4, 55)),
                axis=1)
    got = rayleigh_optics(p, grid, device=cuda)
    want = rayleigh_optics(p, grid, device="cpu")
    assert got.grid == grid and got.tau.device.type == "cuda"
    tau = want.tau.numpy()
    np.testing.assert_allclose(got.tau.cpu().numpy(), tau, rtol=1e-6,
                               atol=1e-12 * tau.max())
    assert torch.equal(got.omega.cpu(), want.omega)
    assert torch.equal(got.g.cpu(), want.g)


def test_library_step_on_the_card_is_the_driver_step(cuda):
    from grtcode_tpu_torch import drive

    lw, sw, sol, batch, _, _ = examples.rfmip_like(smoke=True, device=cuda)
    atm = examples.atmosphere(batch)
    hand = drive.clear_sky_step(lw, sw, sol, atm)
    run = RadiationDriver(lw, sw, sol).run(atm).tiers["csaf"]
    for var in ("rlu", "rld", "rsu", "rsd"):
        assert torch.equal(hand[var], run[var]), var


def test_x64_validate_on_the_card(cuda, capsys):
    from grtcode_tpu_torch import x64_validate

    assert x64_validate.main(["--device", str(cuda)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("X64 OK") and len(out) == 21
    assert all(line.endswith("(torch.float64) ok") for line in out[:-1])


def _scatter_gas(device, method, hot=False, B=3, nlev=7):
    """tests/test_tiled.py's catalog (300 lines, some centred off the
    100-400 cm-1 grid at 0.1) in a GasOptics on ``device``, and B columns
    (``hot``: T + 300 K and p x 2, beyond the line_sample tables)."""
    from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics

    rng = np.random.default_rng(3)
    n = 300
    gas = GasOptics(SpectralGrid(100.0, 400.0, 0.1), line_chunk=64,
                    method=method, device=device)
    gas.add_catalog(synthetic_catalog(
        1, np.sort(rng.uniform(80.0, 420.0, n)), rng.uniform(1e-22, 1e-19, n),
        yair=rng.uniform(0.02, 0.1, n), yself=rng.uniform(0.05, 0.4, n),
        en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
        d=rng.uniform(-0.02, 0.02, n)))
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    if hot:
        p, t = p * 2.0, t + 300.0
    return gas, (p, t, {1: rng.uniform(1e-5, 1e-2, (B, nlev))})


@pytest.mark.parametrize("hot,block", [(False, None), (False, (2944, 128)),
                                       (True, None)])
def test_scatter_on_the_card_matches_the_cpu(cuda, hot, block):
    """index_add_ adds with atomics on the card, in no fixed order."""
    kw = {} if block is None else dict(block_start=block[0],
                                       block_size=block[1])
    outs = []
    for device in (cuda, torch.device("cpu")):
        gas, args = _scatter_gas(device, "scatter", hot)
        outs.append(gas.optical_depth(*args, **kw).cpu().numpy())
    got, want = outs
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.max() > 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_matches_scatter_on_the_card(cuda):
    """K1 (line_sample) against the scatter sum, which shares neither its
    near-core split nor its tables."""
    k1, args = _scatter_gas(cuda, "line_sample")
    scatter, _ = _scatter_gas(cuda, "scatter")
    launches = vk.accumulate_voigt.launches
    got = k1.optical_depth(*args)
    want = scatter.optical_depth(*args)
    assert vk.accumulate_voigt.launches == launches + 1
    assert float(want.max()) > 1.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    hot_args = _scatter_gas(cuda, "line_sample", hot=True)[1]
    with pytest.raises(ValueError, match='method="scatter"'):
        k1.optical_depth(*hot_args)


# ---------------------------------------------------------------------------
# Captured steps: each driver step on the card is a CUDA graph,
# captured once per key and replayed (grtcode_tpu_torch/utils/graphs.py)
# ---------------------------------------------------------------------------

def _graph_path(name, device):
    """(driver, atmosphere, run kwargs) of a path at smoke size."""
    import dataclasses

    if name in ("allsky", "disort"):
        driver, atm = examples.allsky_like(smoke=True, device=device)
        if name == "disort":
            driver = dataclasses.replace(driver, sw_solver="disort",
                                         disort_streams=4)
        return driver, atm, {}
    model, kw = {}, {}
    if name == "streamed":
        model, kw = dict(lw_method="wavenumber_sweep", lw_res=0.01), \
            dict(spectral_chunks=3)
    lw, sw, solar, batch, _, _ = examples.rfmip_like(smoke=True,
                                                     device=device, **model)
    return RadiationDriver(lw, sw, solar), examples.atmosphere(batch), kw


def _tiers(res):
    return {t: {k: v.clone() for k, v in fx.items()}
            for t, fx in res.tiers.items()}


@pytest.mark.parametrize("path", ["line_sample", "streamed", "allsky",
                                  "disort"])
def test_replay_equals_the_eager_step_bit_for_bit(cuda, path):
    from grtcode_tpu_torch.utils import debug

    driver, atm, kw = _graph_path(path, cuda)
    with debug.disable_jit():
        eager = _tiers(driver.run(atm, **kw))
    assert len(driver._step_cache.entries) == 0
    for i in range(3):               # warm-up, capture and replay, replay
        got = _tiers(driver.run(atm, **kw))
        for t in eager:
            for k in eager[t]:
                assert torch.equal(got[t][k], eager[t][k]), (t, k)
        if i == 0:                                 # a run called once
            assert len(driver._step_cache.entries) == 0
    assert len(driver._step_cache.entries) == (1 if path in (
        "line_sample", "streamed") else 2)     # smoke all-sky: 2 at night


def test_streamed_step_on_line_windows_is_bit_identical(cuda, monkeypatch):
    """The streamed bin-method step at S = 10: its replays equal its
    eager call and the eager call of the whole catalog's prep, bit for
    bit; the line-prep counter adds at the eager call and the capture,
    not at a replay."""
    from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
    from grtcode_tpu_torch.utils import debug

    lw, _, _, batch, _, _ = examples.rfmip_like(
        smoke=True, device=cuda, lw_method="wavenumber_sweep", lw_res=0.01)
    driver, atm = RadiationDriver(lw), examples.atmosphere(batch)
    with debug.disable_jit():
        eager = _tiers(driver.run(atm, spectral_chunks=10))
    once = dict(driver.step_stats()["line_prep"])
    assert once["prepped"] < 0.25 * once["catalog"]
    for i in range(4):            # warm-up, capture and replay, replays
        got = _tiers(driver.run(atm, spectral_chunks=10))
        for k in eager["csaf"]:
            assert torch.equal(got["csaf"][k], eager["csaf"][k]), (i, k)
        calls = 1 + min(i + 1, 2)              # eager calls and captures
        assert driver.step_stats()["line_prep"] == {
            k: calls * v for k, v in once.items()}
    assert driver.step_stats()["replays"] == 3
    monkeypatch.setattr(
        GasOptics, "_line_window", lambda self, mol_id, start_bin, nbins: (
            0, self.molecules[mol_id].num_lines,
            self._get_bin_ranges(mol_id)))
    with debug.disable_jit():
        whole = _tiers(driver.run(atm, spectral_chunks=10))
    for k in eager["csaf"]:
        assert torch.equal(whole["csaf"][k], eager["csaf"][k]), k


@pytest.mark.parametrize("path", ["line_sample", "streamed", "allsky",
                                  "disort"])
def test_eager_step_makes_no_host_sync(cuda, path, monkeypatch):
    from grtcode_tpu_torch.utils import debug

    driver, atm, kw = _graph_path(path, cuda)
    with debug.disable_jit():
        driver.run(atm, **kw)                 # builds the tables
        body = RadiationDriver._step_body

        def strict(self, *a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return body(self, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        monkeypatch.setattr(RadiationDriver, "_step_body", strict)
        res = driver.run(atm, **kw)
    assert torch.isfinite(res.tiers["csaf"]["rlu"]).all()


def test_new_lit_count_in_the_bucket_replays(cuda):
    import dataclasses

    from grtcode_tpu_torch.utils import debug

    lw, sw, solar, batch, _, _ = examples.rfmip_like(smoke=True,
                                                     batch_size=16,
                                                     device=cuda)
    driver = RadiationDriver(lw, sw, solar)
    atm = examples.atmosphere(batch)
    runs, entries = {}, driver._step_cache.entries
    for n_lit in (5, 6, 7):                   # lit bucket 8, night 16
        mu = np.full(16, -0.3)
        mu[:n_lit] = np.linspace(0.2, 0.9, n_lit)
        a = dataclasses.replace(atm, cos_zenith=mu)
        held = dict(entries)
        runs[n_lit] = (a, _tiers(driver.run(a)))
        # 5: the buckets' warm-up; 6: their capture; 7: replays alone.
        assert len(entries) == (0 if n_lit == 5 else 2), n_lit
        if n_lit == 7:
            assert all(entries[k] is e for k, e in held.items())
    for n_lit, (a, got) in runs.items():
        with debug.disable_jit():
            want = _tiers(driver.run(a))
        for k in want["csaf"]:
            assert torch.equal(got["csaf"][k], want["csaf"][k]), (n_lit, k)
        assert not got["csaf"]["rsd"][n_lit:].any()


def test_launch_counters_advance_on_replay(cuda):
    driver, atm, _ = _graph_path("line_sample", cuda)
    vk.accumulate_voigt.launches = 0
    for i in range(3):
        driver.run(atm)
        assert vk.accumulate_voigt.launches == 11 * (i + 1)
    (entry,) = driver._step_cache.entries.values()
    assert entry.launches == {vk.accumulate_voigt: 11,   # K1, K2, K3
                              bk.accumulate_bins_kernel: 0,  # captured
                              disort.layer_operators: 0}
    lw, sw, solar, batch, _, _ = examples.rfmip_like(
        smoke=True, device=cuda, lw_method="wavenumber_sweep", lw_res=0.01)
    streamed = RadiationDriver(lw, sw, solar)
    k2 = bk.accumulate_bins_kernel.launches
    for i in range(2):
        streamed.run(examples.atmosphere(batch), spectral_chunks=3)
        assert bk.accumulate_bins_kernel.launches - k2 == 21 * (i + 1)


def test_failed_capture_raises(cuda):
    from grtcode_tpu_torch.utils.graphs import CaptureError

    driver, atm, _ = _graph_path("allsky", cuda)
    callback = driver.cloud_optics

    def syncing(cloud_args, key, w_lw, w_sw):
        if float(cloud_args["cloud_fraction"].sum()) < 0:   # a host sync
            raise AssertionError
        return callback(cloud_args, key, w_lw, w_sw)

    driver.cloud_optics = syncing
    driver.run(atm)                     # the eager warm-up may sync
    for _ in range(2):                  # never falls back, never caches
        with pytest.raises(CaptureError, match="syncing"):
            driver.run(atm)
        assert len(driver._step_cache.entries) == 0
    # The card and the driver's graph pool are usable after the failures.
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    driver.cloud_optics = callback       # another key: warm-up, capture
    for _ in range(2):
        res = driver.run(atm)
    assert len(driver._step_cache.entries) == 2
    assert torch.isfinite(res.tiers["af"]["rlu"]).all()


def test_first_capture_turns_on_expandable_segments(cuda):
    driver, atm, _ = _graph_path("line_sample", cuda)
    for _ in range(2):
        driver.run(atm)                      # warm-up, capture
    pool = tuple(driver._step_cache.pool)
    segments = [s for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", ())) == pool]
    assert segments and all(s.get("is_expandable") for s in segments)


@pytest.mark.parametrize("where", ["warm-up", "capture"])
def test_out_of_memory_drops_the_graphs(cuda, where, monkeypatch):
    """A step that runs out of memory beside its cache's graphs drops
    them and runs again.  At the warm-up the card's memory is capped at
    what is reserved and 4 MiB more (the inputs' gathers); at the capture
    the first capture asks for 64 TiB inside the graph."""
    from grtcode_tpu_torch.utils import debug, graphs

    driver, atm, _ = _graph_path("line_sample", cuda)   # 4 columns
    with debug.disable_jit():
        want = _tiers(driver.run(atm, column_chunk=3))  # chunks of 3, 1
    for _ in range(2):
        driver.run(atm)                      # warm-up, capture
    assert len(driver._step_cache.entries) == 1
    index = torch.cuda.current_device()
    if where == "capture":
        driver.run(atm, column_chunk=3)      # both chunks' warm-up
        real, tries = graphs.CapturedStep, []

        def capture(fn, inputs, **kw):
            def hungry(x):
                if not tries:
                    tries.append(1)
                    torch.empty(1 << 46, dtype=torch.uint8, device=cuda)
                return fn(x)
            return real(hungry, inputs, **kw)

        monkeypatch.setattr(graphs, "CapturedStep", capture)
        got = _tiers(driver.run(atm, column_chunk=3))
        assert tries
    else:
        torch.cuda.synchronize(index)
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(index).total_memory
        cap = torch.cuda.memory_reserved(index) + (4 << 20)
        torch.cuda.set_per_process_memory_fraction(cap / total, index)
        try:
            got = _tiers(driver.run(atm, column_chunk=3))
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, index)
    for k in want["csaf"]:
        assert torch.equal(got["csaf"][k], want["csaf"][k]), k
    # The full batch's graph went; the chunks warmed up, or captured.
    assert len(driver._step_cache.entries) == (2 if where == "capture"
                                               else 0)


# ---------------------------------------------------------------------------
# Layer times: timing events captured in a step's graph, read in replays
# (grtcode_tpu_torch/utils/metrics.py)
# ---------------------------------------------------------------------------

def _kernel_ms(prof):
    """Device ms of the kernels (not copies, fills or ranges) in a
    profile."""
    ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation() or \
                e.name().startswith(("Memcpy", "Memset")):
            continue
        ns += e.duration_ns()
    return ns * 1e-6


def test_layer_times_of_replays_match_the_kernels(cuda):
    """A step of two layers, one matmul and three, captured and replayed
    five times inside layer_times(), each replay waited for as a caller
    that reads its outputs does: the layers' device ms against the
    profiler's kernel times of those replays, within 5 %."""
    from torch.profiler import ProfilerActivity, profile

    from grtcode_tpu_torch.utils import graphs, metrics

    x = torch.randn(4096, 4096, device=cuda)

    def step(inputs):
        (a,) = inputs
        with metrics.layer(metrics.STEP):
            with metrics.layer("one"):
                b = a @ a
            with metrics.layer("three"):
                c = b @ a
                c = c @ a
                c = c @ a
        return b, c

    cache = graphs.StepCache()
    for _ in range(2):                          # warm-up, capture
        cache(("mm",), step, (x,))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            metrics.layer_times():
        for _ in range(5):
            cache(("mm",), step, (x,))
            torch.cuda.synchronize()
    stats = cache.stats()
    assert (stats["eager"], stats["captures"], stats["replays"]) == (1, 1, 6)
    assert (stats["timed"], stats["untimed"]) == (5, 0)
    ms, kernels = stats["layer_ms"], _kernel_ms(prof)
    assert ms["one"] + ms["three"] == pytest.approx(kernels, rel=0.05)
    assert ms["one"] == pytest.approx(kernels / 4, rel=0.05)
    assert ms["three"] == pytest.approx(3 * kernels / 4, rel=0.05)
    assert ms["one"] + ms["three"] <= ms[metrics.STEP] <= 1.05 * kernels


def test_driver_step_stats_on_replay(cuda):
    """The driver's counts for a key's three calls, and each layer of the
    line_sample step timed in its replays inside layer_times()."""
    from grtcode_tpu_torch.utils import metrics

    driver, atm, _ = _graph_path("line_sample", cuda)
    with metrics.layer_times():
        for _ in range(3):                 # warm-up, capture, replay
            driver.run(atm)
    stats = driver.step_stats()
    assert {k: stats[k] for k in ("eager", "captures", "replays", "dropped",
                                  "timed", "untimed")} == dict(
        eager=1, captures=1, replays=2, dropped=0, timed=2, untimed=0)
    ms = stats["layer_ms"]
    assert set(ms) == {metrics.STEP, metrics.LINE_PREP, metrics.VOIGT,
                       metrics.ABSORBERS, metrics.LW_SOLVER,
                       metrics.INTEGRALS, metrics.SW}
    assert all(v > 0 for v in ms.values())
    assert sum(v for k, v in ms.items() if k != metrics.STEP) < \
        ms[metrics.STEP]
    driver.run(atm)                        # outside the block: not read
    assert driver.step_stats()["timed"] == 2
