"""The frozen census against the port's kernel_bench at a small size: the
same samples by class from the same prepared lines, and within rounding
at class boundaries from the benchmark's own line prep."""
import numpy as np
import pytest
import torch

from grtcode_tpu_torch import kernel_bench
from rtbench import census, deployment, program, run, traffic
from rtbench.reference import rt
from rtbench.spec import Spec

from ._files import config

CUT = {"line_shrink": 256, "grid_coarsen": 8, "sites": 2, "experiments": 1}


def _case(name):
    cfg = dict(config(name), smoke=CUT)
    dep = deployment.build(cfg, 21, smoke=True)
    gas = program._gas(dep.bands["lw"], "cpu")
    cols = dep.columns([0, 0], [0, 1], [0.5, 0.5])
    batch = {"p_lev": cols["p_lev"], "t_lev": cols["t_lev"],
             "vmr": cols["ppmv"]}
    return dep, gas, cols, batch


def _mine(prep, L, band, windows):
    f64 = torch.float64
    pos = prep.center_idx[:, :L].to(f64) + prep.center_frac[:, :L].to(f64)
    return census.molecule_counts(pos, prep.lorentz[:, :L].to(f64),
                                  prep.doppler[:, :L].to(f64), band, windows)


def _close(ours, theirs, total):
    tol = max(4.0, 1e-5 * total)
    for k, name in enumerate(census.CLASSES):
        assert abs(float(ours[k]) - theirs[name]) <= tol, (name, ours,
                                                           theirs)


@pytest.mark.parametrize("mol", [1, 3, 7])
def test_line_sample_census_equals_kernel_bench(mol):
    dep, gas, cols, batch = _case("rfmip_irf")
    band = dep.bands["lw"]
    prep, _, kw = kernel_bench.band_prep(gas, mol, batch, "cpu")
    theirs = kernel_bench.census_line_sample(
        prep, gas.chunk_ranges[mol], **kw)
    L = band.lines[mol]["vnn"].size
    ours = _mine(prep, L, band, None)
    assert float(ours.sum()) == theirs["samples_total"]
    _close(ours, theirs["samples"], theirs["samples_total"])
    # The benchmark's own float64 line prep: the same work to rounding.
    c = rt.Column(dep.column(0, 0, 0.5), torch.float64, "cpu")
    pos, _, lor, dop = rt.line_prep(c, mol, band.lines[mol], band,
                                    rt.PartitionSums())
    own = census.molecule_counts(pos, lor, dop, band)
    one = _mine(kernel_bench.band_prep(
        gas, mol, {k: (v[:1] if not isinstance(v, dict) else
                       {m: a[:1] for m, a in v.items()})
                   for k, v in batch.items()}, "cpu")[0], L, band, None)
    assert np.allclose(own.numpy(), one.numpy(), rtol=1e-4, atol=4)


@pytest.mark.parametrize("mol", [2, 6])
def test_bin_census_equals_kernel_bench(mol):
    dep, gas, cols, batch = _case("rfmip_irf_fine")
    band = dep.bands["lw"]
    prep, _, _ = kernel_bench.band_prep(gas, mol, batch, "cpu")
    theirs = kernel_bench.census_bins(
        prep, gas._get_bin_ranges(mol), gas.bins, start_bin=0,
        nbins=gas.bins.n)
    v = band.lines[mol]["vnn"]
    windows = census.LocalWindows(band, v)
    ours = _mine(prep, v.size, band, windows)
    assert float(ours.sum()) == theirs["fine_total"]
    _close(ours, theirs["fine_samples"], theirs["fine_total"])
    assert windows.remote_samples * prep.strength.shape[0] == \
        theirs["coarse_total"]


def _launch_case():
    dep = deployment.build(dict(config("rfmip_irf_fine"), smoke=CUT), 21,
                           smoke=True)
    masked = traffic.Call(np.zeros(4, int), np.arange(4),
                          np.array([0.5, 0.7, 0.2, -0.3]))
    night = traffic.Call(np.zeros(4, int), np.arange(4), -np.ones(4))
    lw, sw = (len(dep.bands[b].lines) for b in ("lw", "sw"))
    return dep, [masked, night], lw, sw


def test_launches_agree_where_each_call_runs_one_key():
    dep, calls, lw, sw = _launch_case()
    card = torch.device("cuda")
    S = 3
    right = {"k2": 2 * lw * S, "k1": sw * S}
    assert run.launches_agree(right, dep, S, calls, card) is True
    for k in right:
        wrong = dict(right, **{k: right[k] + S})
        assert run.launches_agree(wrong, dep, S, calls, card) is False
    split = traffic.Call(np.zeros(4, int), np.arange(4),
                         np.array([0.5, -0.1, -0.2, -0.3]))
    assert run.launches_agree(right, dep, S, calls + [split], card) is None
    assert run.launches_agree(right, dep, S, calls,
                              torch.device("cpu")) is None


@pytest.mark.parametrize("metric,symbol,work", [
    ("k1_roofline_pct", "voigt_line_sample_kernel", "k1"),
    ("k2_roofline_pct", "voigt_bins_kernel", "k2")])
def test_a_launch_mismatch_withholds_the_roofline(metric, symbol, work):
    read = Spec().reader(metric)
    record = {"census": {work: {"ops": 1.0, "bytes": 1.0, "bound_s": 0.5}},
              "device_ops": {f"void {symbol}<64>(float*)": 2.0}}
    assert read(record) == pytest.approx(25.0)
    assert read(dict(record, launches_agree=True)) == pytest.approx(25.0)
    assert read(dict(record, launches_agree=False)) is None
