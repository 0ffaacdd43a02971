"""The line_sample Voigt module of the port == the JAX package's.

Setup of tests/test_pallas.py (grid 100-180 cm-1 at 0.1, 120 lines, 3 x 6
rows, fsteps 30, near 4).  On CPU tensors ``accumulate_voigt`` takes the
plain PyTorch version, which must match both the Pallas kernel run in
interpret mode (``accumulate_voigt_pallas(..., interpret=True)``) and the
jnp ground truth (``accumulate_tiled`` far wings + ``accumulate_near_
pointwise`` near core), on the full block and at tile-aligned block
offsets.  The CUDA kernel itself is compared with the plain version on the
card by tests/test_torch_gpu.py and chip_smoke.py phase 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtcode_tpu import constants as jconst
from grtcode_tpu.gas_optics import lines as jlines
from grtcode_tpu.gas_optics import pallas_kernels as jpk
from grtcode_tpu.gas_optics.hitran import synthetic_catalog
from grtcode_tpu.gas_optics.optical_depth import (accumulate_near_pointwise,
                                                  accumulate_tiled)
from grtcode_tpu.spectral import SpectralGrid
from grtcode_tpu.utils import curtis_godson as jcg
from grtcode_tpu_torch.gas_optics import bins as bm, bins_kernel as bk
from grtcode_tpu_torch.gas_optics import lines, voigt_kernel as vk
from grtcode_tpu_torch.solvers import disort

TILE = 32
CH = 16
FSTEPS = 30
NEAR = 4
# The JAX kernel's own parity bar (tests/test_pallas.py:96).
RTOL, ATOL = 2e-6, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    grid = SpectralGrid(100.0, 180.0, 0.1)
    n_lines = 120
    rng = np.random.default_rng(5)
    vnn = np.sort(rng.uniform(90.0, 190.0, n_lines))
    cat = synthetic_catalog(
        1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))
    bound = jlines.bind_to_grid(cat, grid)

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
    prep = jlines.prepare(bound, grid, pavg.reshape(rows),
                          tavg.reshape(rows), psavg.reshape(rows))
    ns = ns.reshape(rows)
    # The same prepared lines as torch tensors.
    tprep = lines.PreparedLines(*(torch.from_numpy(np.array(a)) for a in (
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler)))
    tns = torch.from_numpy(np.array(ns))
    ranges = vk.build_chunk_ranges(bound.c0, grid.n, FSTEPS, TILE, CH,
                                   shift_margin=2)
    return grid, bound, prep, ns, tprep, tns, ranges


def _plain(setup, start, nw):
    grid, _, _, _, tprep, tns, ranges = setup
    return vk.accumulate_voigt(
        tprep, tns, ranges, num_wpoints=nw, dw=float(grid.dw),
        fsteps=FSTEPS, near=NEAR, num_global=grid.n, start=start).numpy()


def _pallas(setup, start, nw):
    grid, bound, prep, ns, _, _, _ = setup
    hw = NEAR + 2
    ranges = jpk.build_chunk_ranges(bound.c0, grid.n, FSTEPS, TILE, CH,
                                    shift_margin=2, near_hw=hw)
    return np.asarray(jpk.accumulate_voigt_pallas(
        prep, bound.c0, ns, ranges, num_wpoints=nw, dw=float(grid.dw),
        fsteps=FSTEPS, near=NEAR, hw=hw, tile=TILE, ch=CH,
        num_global=grid.n, start=start, interpret=True))


def _jnp_tiled_near(setup, nw):
    grid, bound, prep, ns, _, _, _ = setup
    tiles = jlines.build_tiles(bound, grid.n, FSTEPS, tile=TILE,
                               lane_multiple=8)
    far = accumulate_tiled(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, jnp.asarray(tiles.tile_lines), num_wpoints=nw,
        dw=float(grid.dw), fsteps=FSTEPS, tile=TILE, lchunk=8, start=0,
        num_global=grid.n, exclude_within=NEAR, far_kernel=True)
    pr = jlines.build_point_ranges(bound, grid.n, NEAR, shift_margin=2)
    return np.asarray(accumulate_near_pointwise(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, jnp.asarray(pr.lo), jnp.asarray(pr.hi),
        num_wpoints=nw, dw=float(grid.dw), near=NEAR, kpad=pr.kpad,
        tau0=far, start=0, num_global=grid.n))


def _on_grid(tau, start, n):
    """The columns of a block that lie on the grid (the block's padded
    tail past the grid end is not a grid point)."""
    return tau[:, :max(n - start, 0)]


def test_plain_matches_pallas_interpret_full(setup):
    grid = setup[0]
    nw = -(-grid.n // TILE) * TILE
    got = _plain(setup, 0, nw)
    want = _pallas(setup, 0, nw)
    np.testing.assert_allclose(_on_grid(got, 0, grid.n),
                               _on_grid(want, 0, grid.n), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert not got[:, grid.n:].any()   # no contribution past the grid


def test_plain_matches_jnp_tiled_plus_near(setup):
    grid = setup[0]
    nw = -(-grid.n // TILE) * TILE
    got = _plain(setup, 0, nw)
    want = _jnp_tiled_near(setup, nw)
    np.testing.assert_allclose(_on_grid(got, 0, grid.n),
                               _on_grid(want, 0, grid.n), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("start", range(0, 801, 4 * TILE))
def test_plain_blocks_match_pallas_interpret(setup, start):
    grid = setup[0]
    block = 4 * TILE
    got = _plain(setup, start, block)
    want = _pallas(setup, start, block)
    np.testing.assert_allclose(_on_grid(got, start, grid.n),
                               _on_grid(want, start, grid.n), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_take_the_plain_version(setup):
    grid = setup[0]
    kernel0 = vk.accumulate_voigt.launches
    plain0 = vk.voigt_line_sample_reference.launches
    tau0 = torch.ones((setup[4].strength.shape[0], 4 * TILE))
    out = vk.accumulate_voigt(
        setup[4], setup[5], setup[6], num_wpoints=4 * TILE,
        dw=float(grid.dw), fsteps=FSTEPS, near=NEAR, num_global=grid.n,
        tau0=tau0, start=0)
    assert out is tau0                          # updated in place
    assert vk.accumulate_voigt.launches == kernel0 == 0
    assert vk.voigt_line_sample_reference.launches == plain0 + 1
    np.testing.assert_allclose(out.numpy() - 1.0, _plain(setup, 0, 4 * TILE),
                               rtol=1e-6, atol=1e-6)


def _args(setup, **change):
    _, _, _, _, tprep, tns, ranges = setup
    fields = dict(center_idx=tprep.center_idx,
                  center_frac=tprep.center_frac, strength=tprep.strength,
                  lorentz=tprep.lorentz, doppler=tprep.doppler)
    fields.update({k: v for k, v in change.items() if k in fields})
    tau0 = change.get("tau0", torch.zeros((tns.shape[0], 4 * TILE)))
    return (lines.PreparedLines(**fields), change.get("ns", tns), tau0,
            ranges, change.get("start", 0), 4 * TILE,
            change.get("near", NEAR))


@pytest.mark.parametrize("bad", [
    "center_idx_dtype", "strength_dtype", "noncontiguous", "ns_shape",
    "tau0_shape", "misaligned_start", "near_beyond_tables"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(setup, bad):
    p = setup[4]
    change = {
        "center_idx_dtype": dict(center_idx=p.center_idx.long()),
        "strength_dtype": dict(strength=p.strength.double()),
        "noncontiguous": dict(lorentz=torch.cat(
            [p.lorentz, p.lorentz], 1)[:, ::2]),
        "ns_shape": dict(ns=setup[5][:-1]),
        "tau0_shape": dict(tau0=torch.zeros((3, 4 * TILE))),
        "misaligned_start": dict(start=TILE // 2),
        # The tables' near-core range holds near + shift margin <= hw.
        "near_beyond_tables": dict(near=FSTEPS - 1),
    }[bad]
    with pytest.raises(ValueError):
        vk._check_cuda_args(*_args(setup, **change))
    vk._check_cuda_args(*_args(setup))        # the unchanged call is fine


@pytest.mark.parametrize("kernel", ["voigt_line_sample", "voigt_bins",
                                    "disort_doubling"])
def test_other_devices_raise(setup, kernel):
    """Each dispatcher takes its plain version on the CPU, launches on
    CUDA and refuses any other device."""
    grid, bound = setup[0], setup[1]
    meta = lines.PreparedLines(*(a.to("meta") for a in (
        setup[4].center_idx, setup[4].center_frac, setup[4].strength,
        setup[4].lorentz, setup[4].doppler)))
    ns = setup[5].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "voigt_line_sample":
            vk.accumulate_voigt(meta, ns, setup[6], num_wpoints=4 * TILE,
                                dw=float(grid.dw), fsteps=FSTEPS, near=NEAR,
                                num_global=grid.n)
        elif kernel == "voigt_bins":
            bins = bm.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
            bk.accumulate_bins_kernel(
                meta, ns, bm.build_bin_ranges(bound, bins, mode="bin_sweep"),
                bins)
        else:
            mu0 = torch.tensor([0.6])
            sub = disort.sublayers(*torch.rand(3, 1, 2, 5), 8)
            disort.layer_operators(*(t.to("meta") for t in (
                *sub, mu0, *disort.beam_vectors(mu0, 8))))



# ---------------------------------------------------------------------------
# The zone tables of build_chunk_ranges
# ---------------------------------------------------------------------------

_ZONE_TABLES = ("lo", "nchunks", "cnl", "cnh", "m0l", "m0h", "fll", "flh",
                "frl", "frh")
# (fsteps, near, tile, ch): the line_sample window of the LW 0.1 band with
# the production tile and chunk, and small windows with small chunks.
_ZONE_CASES = [(250, 3, 64, 32), (60, 3, 32, 8), (30, 4, 32, 16)]


def _dense(w0=100.0, n_lines=3000, seed=7):
    """A dense catalogue on an 80 cm-1 grid at 0.1 from ``w0`` (several
    lines per grid point, so whole chunks fall into every zone), prepared
    by the port on 3 x 6 rows over 0.01-1013 mb.  At 30,000 cm-1 the
    Doppler widths put the region-0 half-width near 100 points."""
    from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog as tcat
    from grtcode_tpu_torch.spectral import SpectralGrid as TGrid
    from grtcode_tpu_torch.utils import curtis_godson as tcg
    grid = TGrid(w0, w0 + 80.0, 0.1)
    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(w0 - 10.0, w0 + 90.0, n_lines))
    cat = tcat(1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
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
    p_atm = torch.as_tensor(p, dtype=torch.float32) * jconst.MB_TO_ATM
    pavg, tavg = tcg.layer_pressures_temperatures(
        p_atm, torch.as_tensor(t, dtype=torch.float32))
    psavg, _ = tcg.partial_pressures_and_densities(
        p_atm, torch.as_tensor(x, dtype=torch.float32),
        tcg.number_densities(p_atm))
    rows = B * (nlev - 1)
    prep = lines.prepare(bound, grid, pavg.reshape(rows), tavg.reshape(rows),
                         psavg.reshape(rows))
    return grid, bound, prep


@pytest.fixture(scope="module", params=[100.0, 30000.0], ids=["ir", "uv"])
def dense(request):
    return _dense(w0=request.param)


@pytest.mark.parametrize("fsteps,near,tile,ch", _ZONE_CASES)
def test_zone_tables_byte_identical_to_jax(dense, fsteps, near, tile, ch):
    grid, bound, _ = dense
    margin = lines.shift_margin(bound, grid.dw)
    r0 = lines.region0_halfwidth(bound, grid.dw)
    kw = dict(shift_margin=margin, near_hw=near + margin, region0_hw=r0)
    want = jpk.build_chunk_ranges(bound.c0, grid.n, fsteps, tile, ch, **kw)
    got = vk.build_chunk_ranges(bound.c0, grid.n, fsteps, tile, ch, **kw)
    for name in _ZONE_TABLES:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.hw, got.shift_margin) == (near + margin, margin)
    interior = (got.flh - got.fll) + (got.frh - got.frl)
    if fsteps > 2 * tile:          # the production window: interior zones
        assert interior.sum() > got.nchunks.sum() // 4


@pytest.mark.parametrize("fsteps,near,tile,ch", _ZONE_CASES)
def test_zones_hold_for_every_sample(dense, fsteps, near, tile, ch):
    """Brute force over every (row, line, point) of every tile: a line the
    tables leave out of a tile adds nothing to it; an interior line is on
    the grid, in the window, beyond the near core and in Humlicek region 0
    (or the pure-Lorentz limit) at every point of the tile; an edge line
    is beyond the near core and in region 0 wherever it is in the window;
    every near-core sample's line lies in the near-core range and the
    core-adjacent zone.  Region 0 is tested as the kernel rounds it."""
    grid, bound, prep = dense
    n = grid.n
    margin = lines.shift_margin(bound, grid.dw)
    ranges = vk.build_chunk_ranges(
        bound.c0, n, fsteps, tile, ch, shift_margin=margin,
        near_hw=near + margin,
        region0_hw=lines.region0_halfwidth(bound, grid.dw))
    zones = ranges.zones().astype(np.int64)
    f32 = torch.float32
    cidx = prep.center_idx.to(torch.int64)[:, :, None]
    frac = prep.center_frac[:, :, None]
    repwid = torch.tensor(jconst.SQRT_LN2, dtype=f32) / prep.doppler
    y_true = (repwid * prep.lorentz)[:, :, None]
    y = torch.clamp(y_true, max=70.0)
    xlim0sq = 15100.0 + y * (40.0 - y * 3.6)
    lor = y_true >= 70.55
    dw = torch.tensor(grid.dw, dtype=f32)
    L = cidx.shape[1]
    idx = np.arange(L)
    counts = np.zeros(3, np.int64)
    for t, (lo, hi, nlo, nhi, clo, chi, l0, l1, r0, r1) in enumerate(zones):
        g = torch.arange(t * tile, min((t + 1) * tile, n))
        delta = g - cidx                                   # (rows, L, T)
        valid = (cidx >= 0) & (cidx < n)
        window = valid & (delta.abs() <= fsteps)
        xi = ((delta.to(f32) - frac) * dw) * repwid[:, :, None]
        region0 = lor | (xi * xi >= xlim0sq)
        beyond = delta.abs() > near
        reach = window.any(2).any(0).numpy()
        assert not reach[(idx < lo) | (idx >= hi)].any(), t
        core = (idx >= clo) & (idx < chi)
        interior = ~core & (((idx >= l0) & (idx < l1)) |
                            ((idx >= r0) & (idx < r1)))
        edge = (idx >= lo) & (idx < hi) & ~core & ~interior
        ok_int = (window & beyond & region0).all(2).all(0).numpy()
        assert ok_int[interior].all(), t
        ok_edge = (~window | (beyond & region0)).all(2).all(0).numpy()
        assert ok_edge[edge].all(), t
        near_line = (window & ~beyond & ~lor).any(2).any(0).numpy()
        assert (core & (idx >= nlo) & (idx < nhi))[near_line].all(), t
        counts += [interior.sum(), edge.sum(), core.sum()]
    assert counts[2] > 0 and (fsteps <= 2 * tile or counts.min() > 0)
