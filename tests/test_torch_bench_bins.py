"""The port's headline benchmark at the production LW resolution, and the
census of its step's kernel launches.

* ``make_step`` with ``lw_method="wavenumber_sweep"``, ``lw_res=0.01``
  (0.08 cm-1 at ``--smoke`` size: 40,614 LW points, so the bench streams
  the LW band in 2 blocks) gives the five outputs of ``bench.make_step``,
  the JAX side through its plain reference on the CPU.  The comparison
  runs on the first 2 columns of the smoke batch: both packages' plain
  bin-method versions take 35-75 s a step at 4 columns on the CPU, and
  every column is computed alone;
* ``kernel_work``'s launches and bound are the sum of
  ``kernel_bench.bound_ms`` over the step's K1 and K2 launches, each
  computed here from ``band_prep`` and the census, for line_sample
  (unblocked and in 2 blocks) and for the streamed bin-method step; column
  slices count the same operations in more launches.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import bench as jbench  # noqa: E402

from grtcode_tpu_torch import bench, kernel_bench  # noqa: E402
from grtcode_tpu_torch.gas_optics.bins import NIP  # noqa: E402

# tests/test_torch_driver.py's bars for the same model (see
# tests/test_torch_bench.py): every output relative per level with the 1 %
# floor, the streamed LW fluxes also at rtol 2e-5 / atol 1e-4.
TOLERANCE = 1e-4
STREAM_RTOL, STREAM_ATOL = 2e-5, 1e-4
OUTPUTS = ("rlu", "rld", "rsu", "rsd", "chain")
SWEEP = dict(lw_method="wavenumber_sweep", lw_res=0.01)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _worst_rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


def test_streamed_bin_step_matches_jax():
    jm = jbench.build(smoke=True, batch_size=2, **SWEEP)
    pm = bench.build(smoke=True, batch_size=2, device="cpu", **SWEEP)
    n = pm[0].grid.n
    assert n == jm[0].grid.n == 40614
    blocks = bench.default_lw_blocks(n)
    assert blocks == 2 and bench.lw_block_size(pm[0], blocks)[1] == 2
    assert bench.default_lw_blocks(32491) == 1      # LW 0.1: one block
    assert bench.default_lw_blocks(324901) == 10    # LW 0.01 full size
    want = jbench.make_step(*jm[:3], lw_blocks=blocks)(
        *bench.step_args(jm[3]), jnp.float32(0.0))
    got = bench.make_step(*pm[:3], lw_blocks=blocks)(
        *bench.step_args(pm[3]), torch.zeros(()))
    for var, g, w in zip(OUTPUTS, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (() if var == "chain" else (2, 55))
        assert np.isfinite(g).all(), var
        assert _worst_rel(g, w) <= TOLERANCE, (var, _worst_rel(g, w))
        if var in ("rlu", "rld"):
            np.testing.assert_allclose(g, w, rtol=STREAM_RTOL,
                                       atol=STREAM_ATOL, err_msg=var)
    assert float(got[0][0, 0]) > 0 and float(got[3][0, 0]) > 0


def _direct_bound(lw_gas, sw_gas, batch, lw_blocks):
    """The sum of kernel_bench.bound_ms over the step's launches, each from
    band_prep and the census: (ms, K1 launches, K2 launches)."""
    total, k1, k2 = 0.0, 0, 0
    for gas, blocks in ((lw_gas, lw_blocks), (sw_gas, 1)):
        q, n = gas.block_quantum, gas.grid.n
        size = -(-(-(-n // blocks)) // q) * q if blocks > 1 else n
        for mol in gas.molecules:
            prep, _, kw = kernel_bench.band_prep(gas, mol, batch, "cpu")
            rows, L = prep.strength.shape
            for start in range(0, n, size):
                if gas.method not in ("wavenumber_sweep", "line_sweep"):
                    ranges = gas.chunk_ranges[mol]
                    cen = kernel_bench.census_line_sample(
                        prep, ranges, **dict(kw, num_wpoints=size),
                        start=start)
                    samples = cen["samples"]
                    reached = kernel_bench.line_sample_lines_reached(
                        ranges, start, size, L)
                    nbytes = 4 * rows * (5 * reached + 1 + 2 * size)
                    k1 += 1
                else:
                    ranges, bins = gas._get_bin_ranges(mol), gas.bins
                    nb = -(-size // bins.ppb)
                    cen = kernel_bench.census_bins(
                        prep, ranges, bins, start_bin=start // bins.ppb,
                        nbins=nb)
                    samples = dict(cen["fine_samples"])
                    samples["region0"] += cen["coarse_total"]
                    reached = kernel_bench.lines_reached(
                        ranges, start // bins.ppb, nb)
                    nbytes = 4 * rows * (5 * reached + 1
                                         + 2 * nb * (bins.ppb + NIP))
                    k2 += 1
                total += kernel_bench.bound_ms(samples, nbytes)["bound_ms"]
    return total, k1, k2


@pytest.mark.parametrize("model,lw_blocks,launches", [
    ({}, 1, (11, 0)), ({}, 2, (18, 0)), (SWEEP, 2, (4, 14))])
def test_kernel_work_is_the_sum_over_the_launches(model, lw_blocks,
                                                  launches):
    lw, sw, _, batch, _, _ = bench.build(smoke=True, device="cpu", **model)
    want, k1, k2 = _direct_bound(lw, sw, batch, lw_blocks)
    assert (k1, k2) == launches
    work = bench.kernel_work(lw, sw, batch, lw_blocks=lw_blocks)
    assert work["launches"] == {"voigt_line_sample": k1, "voigt_bins": k2}
    assert work["bound_ms"] == pytest.approx(want, rel=1e-12)
    # Column slices: the same samples, each slice's launches apart.
    sliced = bench.kernel_work(lw, sw, batch, lw_blocks=lw_blocks, chunk=2)
    assert sliced["launches"] == {"voigt_line_sample": 2 * k1,
                                  "voigt_bins": 2 * k2}
    assert sliced["ops"] == pytest.approx(work["ops"], rel=1e-12)
