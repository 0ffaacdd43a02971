"""The port's bin methods == the JAX package's (gas_optics/bins.py and the
plain version of the bin kernel).

* ``create_spectral_bins`` / ``build_bin_ranges`` build byte-identical
  tables in both modes, on grids with ppb <= 3 and ppb > 3, lines off the
  grid and empty bins;
* the plain version ``bins.accumulate_bins`` matches the JAX
  ``accumulate_bins`` (rtol 2e-6) and the JAX Pallas bin kernel run in
  interpret mode (rtol 2e-5 / atol 2e-6 x max, tests/test_bins_pallas.py),
  including the correction-path molecule and windows at start_bin > 0;
* ``interpolate_bins`` matches, including the nearest path and the
  last-bin switch inside a block;
* a block-local result equals the same slice of the full band.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtcode_tpu import constants as jconst
from grtcode_tpu.gas_optics import bins as jbins
from grtcode_tpu.gas_optics import bins_pallas as jbp
from grtcode_tpu.gas_optics import lines as jlines
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.spectral import SpectralGrid
from grtcode_tpu.utils import curtis_godson as jcg
from grtcode_tpu_torch.gas_optics import bins, lines
from grtcode_tpu_torch.gas_optics.bins_kernel import accumulate_bins_kernel
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog

CH = 16
# The plain version against the JAX jnp accumulate_bins: the same terms,
# summed in another order.
RTOL_JNP = 2e-6
# Against the JAX bin kernel (interpret mode): its own bar against
# accumulate_bins (tests/test_bins_pallas.py:88-93).
RTOL_KERNEL, ATOL_KERNEL = 2e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _catalog_args(w0, wn, n_lines, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(w0 - spread, wn + spread, n_lines))
    return (1, vnn, rng.uniform(1e-22, 1e-19, n_lines)), dict(
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))


def _grids():
    """(grid, catalog) cases: ppb 11 with lines off both grid ends; ppb 3
    (no interpolation); sparse lines leaving most bins empty; ppb 6 with
    a grid that divides evenly into bins (last_ppb == ppb)."""
    return {
        "ppb11_offgrid": ((100.0, 180.0, 0.1), (100.0, 180.0, 120, 5)),
        "ppb3": ((100.0, 160.0, 0.5), (100.0, 160.0, 80, 6)),
        "sparse": ((200.0, 320.0, 0.1), (200.0, 320.0, 6, 7, 0.0)),
        "even": ((300.0, 359.8, 0.2), (300.0, 359.8, 50, 8)),
    }


@pytest.mark.parametrize("case", list(_grids()))
@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
def test_bins_and_ranges_are_byte_identical(case, mode):
    (w0, wn, dw), cat = _grids()[case]
    grid = SpectralGrid(w0, wn, dw)
    args, kws = _catalog_args(*cat)
    jb = jbins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    pb = bins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    for f in ("num_wpoints", "ppb", "last_ppb", "n", "do_interp",
              "do_last_interp", "w0", "wres", "width"):
        assert getattr(pb, f) == getattr(jb, f), f
    for f in ("l", "r", "w"):
        a, b = getattr(pb, f), getattr(jb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jr = jbins.build_bin_ranges(
        jlines.bind_to_grid(jcatalog(*args, **kws), grid), jb, mode=mode)
    pr = bins.build_bin_ranges(
        lines.bind_to_grid(synthetic_catalog(*args, **kws), grid), pb,
        mode=mode)
    for f in ("local_lo", "local_cnt", "rem_lo", "rem_cnt_l",
              "rem_hi_start", "rem_cnt_r"):
        a, b = getattr(pr, f), getattr(jr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pr.lmax_local, pr.lmax_remote) == (jr.lmax_local,
                                               jr.lmax_remote)
    if case == "sparse":
        assert (pr.local_cnt == 0).sum() > pb.n // 4


def _setup(w0=100.0, wn=180.0, n_lines=120, seed=5):
    """tests/test_bins_pallas.py's setup: one molecule, 3 x 6 rows.  JAX
    prepares the lines; the port gets the same (rows, L) arrays."""
    grid = SpectralGrid(w0, wn, 0.1)
    args, kws = _catalog_args(w0, wn, n_lines, seed)
    bound = jlines.bind_to_grid(jcatalog(*args, **kws), grid)
    padded = bound.pad_to(-(-bound.num_lines // 64) * 64)
    rng = np.random.default_rng(seed + 100)
    nlev, B = 7, 3
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))
    p_atm = jnp.asarray(p, jnp.float32) * jconst.MB_TO_ATM
    n_air = jcg.number_densities(p_atm)
    pavg, tavg = jcg.layer_pressures_temperatures(
        p_atm, jnp.asarray(t, jnp.float32))
    psavg, ns = jcg.partial_pressures_and_densities(
        p_atm, jnp.asarray(x, jnp.float32), n_air)
    rows = B * (nlev - 1)
    jprep = jlines.prepare(padded, grid, pavg.reshape(rows),
                           tavg.reshape(rows), psavg.reshape(rows))
    prep = lines.PreparedLines(*(torch.as_tensor(np.array(a)) for a in (
        jprep.center_idx, jprep.center_frac, jprep.strength, jprep.lorentz,
        jprep.doppler)))
    port_bound = lines.bind_to_grid(synthetic_catalog(*args, **kws), grid)
    return (grid, bound, padded, jprep, jnp.asarray(ns).reshape(rows),
            port_bound, prep, torch.as_tensor(np.array(ns).reshape(rows)))


@pytest.fixture(scope="module")
def heavy():
    return _setup()


@pytest.fixture(scope="module")
def light():
    """Light molecule at 30,000-30,060 cm-1: remote lines fall inside
    Humlicek regions 1-4 (the JAX kernel's correction path)."""
    return _setup(w0=30000.0, wn=30060.0, n_lines=60, seed=11)


def _jnp(setup, mode):
    grid, bound, _, jprep, jns, *_ = setup
    jb = jbins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    br = jbins.build_bin_ranges(bound, jb, mode=mode)
    tau, bins_tau = jbins.accumulate_bins(
        jprep.center_idx, jprep.center_frac, jprep.strength, jprep.lorentz,
        jprep.doppler, jns,
        jnp.asarray(br.local_lo), jnp.asarray(br.local_cnt),
        jnp.asarray(br.rem_lo), jnp.asarray(br.rem_cnt_l),
        jnp.asarray(br.rem_hi_start), jnp.asarray(br.rem_cnt_r),
        jnp.asarray(jb.l, jnp.int32),
        ((jb.w - grid.w0) / grid.dw).astype(np.float32),
        ppb=jb.ppb, nbins=jb.n, lmax_local=br.lmax_local,
        lmax_remote=br.lmax_remote, dw=float(grid.dw), num_wpoints=grid.n)
    return jb, br, np.asarray(tau), np.asarray(bins_tau)


def _plain(setup, mode, **window):
    grid, *_, port_bound, prep, ns = setup
    pb = bins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    pr = bins.build_bin_ranges(port_bound, pb, mode=mode)
    launches = bins.accumulate_bins.launches
    fine, coarse = accumulate_bins_kernel(prep, ns, pr, pb, **window)
    assert bins.accumulate_bins.launches == launches + 1
    return pb, fine.numpy(), coarse.numpy()


@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
def test_plain_version_matches_jnp(heavy, mode):
    grid = heavy[0]
    _, _, tau_j, bins_tau_j = _jnp(heavy, mode)
    pb, fine, coarse = _plain(heavy, mode)
    assert fine.shape == (18, pb.n * pb.ppb)
    np.testing.assert_allclose(fine[:, :grid.n], tau_j, rtol=RTOL_JNP,
                               atol=0)
    assert not fine[:, grid.n:].any()       # past the grid end: dropped
    np.testing.assert_allclose(coarse, bins_tau_j, rtol=RTOL_JNP, atol=0)
    assert tau_j.max() > 0 and bins_tau_j.max() > 0


def _pallas(setup, mode, start_bin, nbins):
    grid, bound, padded, jprep, jns, *_ = setup
    jb, br, _, _ = _jnp(setup, mode)
    gap = (1.0 if mode == "bin_sweep" else 1.5) / grid.dw
    tables = jbp.build_bin_kernel_tables(
        br, jb, padded, ch=CH, G=8,
        region0_hw=jlines.region0_halfwidth(padded, grid.dw),
        min_gap_points=gap)
    fine, coarse = jbp.accumulate_bins_pallas(
        jprep, padded.c0, jns, tables, ppb=jb.ppb, dw=float(grid.dw),
        start_bin=start_bin, nbins_block=nbins, ch=CH, interpret=True)
    return tables, np.asarray(fine), np.asarray(coarse)


@pytest.mark.parametrize("which,mode,start_bin,nbins", [
    ("heavy", "bin_sweep", 0, 80),
    ("heavy", "line_sweep", 32, 32),
    ("heavy", "bin_sweep", 64, 32),
    ("light", "bin_sweep", 0, 56),
])
def test_plain_version_matches_pallas_kernel(heavy, light, which, mode,
                                             start_bin, nbins):
    setup = heavy if which == "heavy" else light
    tables, fine_k, coarse_k = _pallas(setup, mode, start_bin, nbins)
    assert tables.coarse_region0 == (which == "heavy")
    pb, fine, coarse = _plain(setup, mode, start_bin=start_bin, nbins=nbins)
    # Only the bins and fine points on the band: past it the Pallas kernel
    # computes the last bin's extra points, the plain version drops them.
    nb = min(nbins, pb.n - start_bin)
    nf = min(nbins * pb.ppb, pb.num_wpoints - start_bin * pb.ppb)
    for got, want in ((fine[:, :nf], fine_k[:, :nf]),
                      (coarse[:, :nb], coarse_k[:, :nb])):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=RTOL_KERNEL,
                                   atol=ATOL_KERNEL * np.abs(want).max())
    assert not fine[:, nf:].any() and not coarse[:, nb:].any()


def test_block_equals_slice_of_the_full_band(heavy):
    pb, fine, coarse = _plain(heavy, "bin_sweep")
    for b0, nb in ((0, 16), (24, 32), (64, 32)):
        _, fb, cb = _plain(heavy, "bin_sweep", start_bin=b0, nbins=nb)
        keep = min(nb, pb.n - b0)
        np.testing.assert_allclose(
            fb[:, :keep * pb.ppb],
            fine[:, b0 * pb.ppb:(b0 + keep) * pb.ppb], rtol=1e-6, atol=0)
        np.testing.assert_allclose(cb[:, :keep], coarse[:, b0:b0 + keep],
                                   rtol=1e-6, atol=0)


def _interp_inputs(ppb_grid, rows=5, seed=3):
    """A band whose last bin is short, and random coarse wings."""
    w0, wn, dw = ppb_grid
    grid = SpectralGrid(w0, wn, dw)
    jb = jbins.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    rng = np.random.default_rng(seed)
    bins_tau = rng.uniform(0.0, 2.0, (rows, jb.n, jbins.NIP)).astype(
        np.float32)
    fine = rng.uniform(0.0, 1.0, (rows, jb.n * jb.ppb)).astype(np.float32)
    w_rel = ((jb.w - grid.w0) / grid.dw).astype(np.float32)
    return jb, bins_tau, fine, w_rel


@pytest.mark.parametrize("ppb_grid,block", [
    ((100.0, 199.9, 0.1), None),     # ppb 11, last bin 10 points
    ((100.0, 131.5, 0.5), None),     # ppb 3: nearest, no switch
    ((100.0, 100.3, 0.1), None),     # one bin of 4 points, ppb 11
    ((100.0, 182.7, 0.1), None),     # last bin of 3 points: the switch
    ((100.0, 182.7, 0.1), (72, 8)),  # the switch inside a block
    ((100.0, 182.7, 0.1), (64, 8)),  # a block before the last bin
])
def test_interpolate_bins_matches_jax(ppb_grid, block):
    jb, bins_tau, fine, w_rel = _interp_inputs(ppb_grid)
    kw = dict(ppb=jb.ppb, last_ppb=jb.last_ppb, do_interp=jb.do_interp,
              do_last_interp=jb.do_last_interp)
    if block is None:
        b0, nb, nw = 0, jb.n, jb.num_wpoints
        extra = {}
    else:
        b0, nb = block
        nw = nb * jb.ppb
        extra = dict(bin0=b0, last_bin=jb.n - 1)
        assert jb.do_interp != jb.do_last_interp
    sl = slice(b0, b0 + nb)
    bl = jb.l[sl].astype(np.int32)
    tau = fine[:, b0 * jb.ppb:b0 * jb.ppb + nw]
    want = np.asarray(jbins.interpolate_bins(
        jnp.asarray(bins_tau[:, sl]), jnp.asarray(bl), w_rel[sl],
        num_wpoints=nw, tau=jnp.asarray(tau), **kw, **extra))
    got = bins.interpolate_bins(
        torch.as_tensor(bins_tau[:, sl]), torch.as_tensor(bl),
        torch.as_tensor(w_rel[sl]), num_wpoints=nw,
        tau=torch.as_tensor(tau.copy()), **kw, **extra).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got >= tau - 1e-7).all()      # wings clamp at zero


# Fine points of one block part of the bin kernel (csrc/voigt_bins.cu,
# kSlots): a bin of ppb points is split into parts of this many.
K_SLOTS = 128


@pytest.mark.parametrize("which", ["heavy", "light"])
@pytest.mark.parametrize("mode", ["bin_sweep", "line_sweep"])
def test_fine_tile_region0_rule_holds_for_every_sample(heavy, light, which,
                                                       mode):
    """The bin kernel decides once per (row, local line, bin part) whether
    every sample of the line in the part is Humlicek region 0, from the
    part's points nearest cidx - 1, cidx and cidx + 1 (|x| is monotone in
    the point on each side of the centre).  A part is a run of up to
    K_SLOTS points of one bin, from the bin's start; the local lines are
    the bin's own.  Brute force over every (row, local line, part point),
    with x rounded as the kernel rounds it, on bins of 11 points and of
    151 (two parts, the second partial): the least |x| over the part is
    always at one of those three points, so a line the rule sends down the
    region-0 path has no sample inside the region-0 limit."""
    grid, *_, port_bound, prep, _ = dict(heavy=heavy, light=light)[which]
    f32 = torch.float32
    dw = torch.tensor(grid.dw, dtype=f32)
    repwid = torch.tensor(jconst.SQRT_LN2, dtype=f32) / prep.doppler
    y = torch.clamp(repwid * prep.lorentz, max=70.0)
    xlim0 = torch.sqrt(15100.0 + y * (40.0 - y * 3.6))
    cidx = prep.center_idx

    def absx(g, sl):          # (rows, lines, points) |x| at fine points g
        c = cidx[:, sl, None]
        return ((((g.to(f32) - c.to(f32)) - prep.center_frac[:, sl, None])
                 * dw) * repwid[:, sl, None]).abs()

    tested = inside = parts = 0
    for width in (1.0, 15.0):
        pb = bins.create_spectral_bins(grid.n, grid.w0, grid.dw, width)
        bnd = bins.build_bin_ranges(port_bound, pb, mode=mode).bounds()
        for j in range(pb.n):
            if bnd[1, j] <= bnd[0, j]:
                continue
            sl = slice(int(bnd[0, j]), int(bnd[1, j]))
            for part in range(0, pb.ppb, K_SLOTS):
                first = j * pb.ppb + part
                last = min(j * pb.ppb + min(pb.ppb, part + K_SLOTS),
                           grid.n) - 1
                if last < first:
                    continue
                brute = absx(torch.arange(first, last + 1), sl).amin(2)
                near = torch.stack([torch.clamp(cidx[:, sl] + s, first, last)
                                    for s in (-1, 0, 1)], 2)
                rule = absx(near, sl).amin(2)
                assert torch.equal(rule, brute), (width, j, part)
                inside += int((brute < xlim0[:, sl]).sum())
                tested += brute.numel()
                parts += part > 0
    assert tested > 0 and 0 < inside < tested
    assert parts > 0          # some bin was split into parts
