"""The port's command-line surface (``grtcode_tpu_torch.framework.cli`` and
the three apps' parsers) and the cloud tables' netCDF readers.

* ``shared_parser`` and each app's parser give the same Namespace as the
  JAX package's for the same argv: every shared flag, every app flag, and
  the defaults;
* ``-mesh 2x1`` without a process group exits telling the user to
  launch under torchrun (from ``mesh_from_args`` and from each app),
  ``-mesh nonsense`` exits;
* the device: ``-d N`` is ``cuda:N``, ``cuda:0`` without it; an app with
  no CUDA and no ``device`` exits and never runs on the CPU;
* ``configure`` sets the reference's verbosity level;
* ``PadeCloudOptics.from_netcdf`` and ``HuStamnesLiquidOptics.from_netcdf``
  read the same arrays as the JAX readers from the same files.
"""
import argparse

import h5py
import numpy as np
import pytest
import torch

from grtcode_tpu.apps import circ as jcirc, era5 as jera5, rfmip as jrfmip
from grtcode_tpu.clouds import hu_stamnes as jhs, pade as jpade
from grtcode_tpu.framework import cli as jcli
from grtcode_tpu.utils import ncio as jncio
from grtcode_tpu_torch.apps import circ, era5, rfmip
from grtcode_tpu_torch.clouds import hu_stamnes, pade
from grtcode_tpu_torch.framework import cli
from grtcode_tpu_torch.utils import verbosity

SHARED_FLAGS = [
    "-beta-path", "beta.nc", "-c", "20.5", "-d", "1", "-flux-at-level", "3",
    "-ice-path", "ice.nc", "-integrated", "-liquid-path", "liq.nc", "-o",
    "out.nc", "-r-lw", "0.5", "-r-sw", "2.0", "-w-lw", "10", "-w-sw", "100",
    "-W-lw", "3000", "-W-sw", "40000", "-h2o-ctm", "ctm", "-o3-ctm", "o3.csv",
    "-v", "-spectral-chunks", "4", "-mesh", "2x1"]

APP_ARGV = {
    "circ": [
        ["par", "sol"],
        ["par", "sol", "case.nc", "-a", "0.2", "-z", "2", "-Z", "7", "-H2O",
         "-CO2", "-O3", "-N2O", "-CO", "-CH4", "-O2", "-CFC-11", "c11.csv",
         "-CFC-12", "-CCl4", "ccl4.csv", "-N2-N2", "n2.csv", "-O2-N2",
         "-O2-O2", "o2.csv", "-clean", "-clouds"] + SHARED_FLAGS],
    "rfmip": [
        ["par", "sol", "in.nc", "2"],
        ["par", "sol", "in.nc", "1", "-x", "1", "-X", "3", "-H2O", "-CH4",
         "-CFC-11-eq", "c11.csv", "-HFC-134a-eq", "-SF6", "sf6.csv",
         "-HCFC-141b", "-N2-N2", "n2.csv", "-O2-N2"] + SHARED_FLAGS],
    "era5": [
        ["par", "sol", "era5.nc", "ghg.nc", "-year", "3"],
        ["par", "sol", "era5.nc", "ghg.nc", "-year", "3", "-ghg_start_year",
         "2", "-x", "1", "-X", "2", "-y", "0", "-Y", "1", "-t", "1", "-T",
         "1", "-clear", "-sw", "-H2O", "-CO2", "-HFC-134a-eq", "h.csv",
         "-CFC-12-eq", "-O2-O2", "o2.csv"] + SHARED_FLAGS],
}
APPS = {"circ": (jcirc, circ), "rfmip": (jrfmip, rfmip),
        "era5": (jera5, era5)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


class _Parsed(Exception):
    pass


def app_namespace(app, argv, monkeypatch, **kw):
    """The Namespace ``app.main(argv)`` parses, stopping right after."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as caught:
            app.main(argv, **kw)
    return vars(caught.value.args[0])


@pytest.mark.parametrize("argv", [["par", "sol"], ["par", "sol"]
                                  + SHARED_FLAGS])
def test_shared_parser_matches_jax(argv):
    got = vars(cli.shared_parser("t").parse_args(argv))
    want = vars(jcli.shared_parser("t").parse_args(argv))
    assert got == want


@pytest.mark.parametrize("app,case", [(a, i) for a in APPS for i in (0, 1)])
def test_app_parsers_match_jax(app, case, monkeypatch):
    jmod, mod = APPS[app]
    argv = APP_ARGV[app][case]
    got = app_namespace(mod, argv, monkeypatch, device="cpu")
    want = app_namespace(jmod, argv, monkeypatch)
    assert got == want
    assert len(got) > 20


def test_mesh_flag(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    p = cli.shared_parser("t")
    assert cli.mesh_from_args(p.parse_args(["a", "b"])) is None
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        cli.mesh_from_args(p.parse_args(["a", "b", "-mesh", "2x1"]))
    with pytest.raises(SystemExit):
        cli.mesh_from_args(p.parse_args(["a", "b", "-mesh", "nonsense"]))


@pytest.mark.parametrize("app", list(APPS))
def test_apps_refuse_a_mesh(app, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 8"):
        APPS[app][1].main(APP_ARGV[app][0] + ["-mesh", "4x2"], device="cpu")


def test_device_selection(monkeypatch):
    p = cli.shared_parser("t")
    args = p.parse_args(["a", "b"])
    assert cli.device_from_args(args, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.device_from_args(args) == torch.device("cuda", 0)
    assert cli.device_from_args(p.parse_args(["a", "b", "-d", "1"])) == \
        torch.device("cuda", 1)
    with pytest.raises(SystemExit, match="-d 2"):
        cli.device_from_args(p.parse_args(["a", "b", "-d", "2"]))


@pytest.mark.parametrize("app", list(APPS))
def test_apps_never_fall_back_to_the_cpu(app, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        APPS[app][1].main(APP_ARGV[app][0])


@pytest.mark.parametrize("verbose", [False, True])
def test_configure_sets_verbosity(verbose):
    argv = ["a", "b"] + (["-v"] if verbose else [])
    before = verbosity.verbosity()
    try:
        cli.configure(cli.shared_parser("t").parse_args(argv))
        assert verbosity.verbosity() == (
            verbosity.GRTCODE_INFO if verbose else verbosity.GRTCODE_WARN)
    finally:
        verbosity.set_verbosity(before)


def _write_pade(path, rng, nbnd=5, nreg=3, ncoef=3):
    """An RRTMGP-style Pade file: (coef, sizereg, band) coefficient
    layout, band and size-regime limits, reference radii."""
    with h5py.File(path, "w") as f:
        edges = np.linspace(10.0, 50000.0, nbnd + 1)
        f["Band_limits_lwr"], f["Band_limits_upr"] = edges[:-1], edges[1:]
        f["Effective_Radius_limits_lwr"] = np.array([2.5, 21.0, 60.0])
        f["Effective_Radius_limits_upr"] = np.array([21.0, 60.0, 90.0])
        f["Effective_Radius_Ref"] = np.array([9.0, 35.0, 70.0])
        for name in ("ext", "ssa", "asy"):
            for pq in ("p", "q"):
                f[f"Pade_{name}_{pq}"] = rng.uniform(
                    0.1, 1.0, (ncoef, nreg, nbnd))


def _write_hu_stamnes(path, rng, nbins=4, nbands=6):
    """A Hu & Stamnes coefficient file: radius bin bounds named by the
    ``bounds`` attribute, ``valid_range``, band bounds with
    ``last_IR_band``, a1..c3 on (radius, band)."""
    edges = np.array([2.5, 5.0, 10.0, 20.0, 60.0])
    with jncio.Writer(path) as w:
        w.create_dimension("radius", nbins, values=0.5 * (edges[:-1]
                                                          + edges[1:]))
        w.create_dimension("band", nbands)
        w.create_dimension("nv", 2)
        w.create_variable("radius_bnds", ("radius", "nv"),
                          np.stack([edges[:-1], edges[1:]], 1))
        w.create_variable("band_bnds", ("band", "nv"), np.stack(
            [np.linspace(0, 5e4, nbands + 1)[:-1],
             np.linspace(0, 5e4, nbands + 1)[1:]], 1), last_IR_band=2)
        for k in ("a", "b", "c"):
            for i in (1, 2, 3):
                w.create_variable(f"{k}{i}", ("radius", "band"),
                                  rng.uniform(-1.0, 1.0, (nbins, nbands)))
    with h5py.File(path, "a") as f:
        f["radius"].attrs["bounds"] = "radius_bnds"
        f["radius"].attrs["valid_range"] = np.array([3.0, 55.0])


def test_pade_from_netcdf_matches_jax(tmp_path):
    path = str(tmp_path / "pade.nc")
    _write_pade(path, np.random.default_rng(4))
    got = pade.PadeCloudOptics.from_netcdf(path, "cpu")
    want = jpade.PadeCloudOptics.from_netcdf(path)
    names = ("band_lims", "sizereg_bounds", "sizereg_ref", "ext_p", "ext_q",
             "ssa_p", "ssa_q", "asy_p", "asy_q")
    for name in names:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.ext_p.shape == (5, 3, 3)


def test_hu_stamnes_from_netcdf_matches_jax(tmp_path):
    path = str(tmp_path / "hu_stamnes.nc")
    _write_hu_stamnes(path, np.random.default_rng(5))
    got = hu_stamnes.HuStamnesLiquidOptics.from_netcdf(path, "cpu")
    want = jhs.HuStamnesLiquidOptics.from_netcdf(path)
    assert np.array_equal(got.radii, want.radii)
    assert got.radii.dtype == want.radii.dtype
    assert np.array_equal(got.band_lims.numpy(),
                          np.asarray(want.band_lims, np.float32))
    for name in ("a1", "b1", "c1", "a2", "b2", "c2", "a3", "b3", "c3"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (got.min_radius, got.max_radius) == \
        (want.min_radius, want.max_radius) == (3.0, 55.0)
