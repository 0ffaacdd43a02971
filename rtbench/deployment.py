"""A deployment's inputs, made in the process from its configuration file
and the run's seed.

Everything here is raw input in float64 numpy, handed alike to the
program under test (``rtbench.program``) and to the plain reference
(``rtbench.reference``): the line catalogs, the continua, cross sections
and solar spectrum on each band's grid, and the columns' profiles and
surface spectra.  What either side derives from them (grid-bound
catalogs, line prep, bin tables, folded CIA factors, spectra on the band
grids) it works out itself.

The columns come from the configuration's layout,
``rtbench/layouts/<layout>.py`` (``layout`` in the configuration,
``rfmip_irf`` where it names none): a later configuration brings its own
profiles, surface spectra, incident spectrum and sun as a new file.

The line parameters the program keeps in float32 (half-widths, lower
state energy, temperature exponent, shift) are drawn as float32 values,
so both sides start from the same numbers.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed.  Any whole
    number is a seed (negative ones map to their two's complement)."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def grid_points(w0: float, wn: float, dw: float) -> int:
    """Points of the uniform grid ``w0 + i dw`` reaching ``wn``
    (``ceil((wn - w0) / dw) + 1``, the grid rule of the reference C)."""
    return int(math.ceil((wn - w0) / dw)) + 1


@dataclasses.dataclass
class Band:
    """One band's grid and absorbers.  Tables are (n,) float64 on the
    grid; ``lines`` maps a HITRAN molecule id to its raw parameters."""

    name: str
    w0: float
    wn: float
    dw: float
    n: int
    method: str
    cutoff: float
    lines: dict
    h2o: dict
    o3: np.ndarray
    cfcs: dict          # CFC id -> sigma [cm2]
    cias: list          # (species 1, species 2, sigma [cm5])
    bin_width: float = 1.0
    local_bins: int = 1
    remote_bins: int = 25

    @property
    def wavenumbers(self) -> np.ndarray:
        return self.w0 + self.dw * np.arange(self.n, dtype=np.float64)


@dataclasses.dataclass
class Layout:
    """The columns a layout module makes: ``sites`` x ``experiments``
    columns, their ``profiles``, and where the layout has one the
    shortwave band's incident spectrum ``solar`` as (wavenumbers [cm-1],
    values) samples (else the configuration's analytic ``solar``).

    ``profiles`` holds, by site: ``p_lev`` (nsite, nlevels) [mb],
    ``mu_site`` (nsite,) cosines of zenith, ``tsi`` (nsite,) [W m-2], and
    the surface spectra ``emissivity_grid`` / ``emissivity`` (nsite, ne)
    and ``albedo_grid`` / ``albedo`` (nsite, na), grids [cm-1] ascending;
    by experiment and site: ``t_lev`` (nexpt, nsite, nlevels) [K],
    ``t_surf`` (nexpt, nsite), and ``ppmv`` (HITRAN id), ``cfc_ppmv`` and
    ``cia_ppmv`` (species id), each a dict of (nexpt, nsite, nlevels)
    abundances [ppmv] at levels."""

    sites: int
    experiments: int
    profiles: dict
    solar: tuple | None = None


@dataclasses.dataclass
class Deployment:
    config: dict
    bands: dict         # "lw" [/ "sw"] -> Band
    solar: np.ndarray | None    # (n_sw,) incident spectrum, integral 1
    profiles: dict      # see Layout
    sites: int
    experiments: int

    def columns(self, expts, sites, mu) -> dict:
        """The (B, ...) arrays of the columns (experiment, site) with
        cosines of zenith ``mu``: level pressure [mb] and temperature [K],
        surface temperature, abundances [ppmv] at levels, TSI, and the
        surface albedo and emissivity spectra (each column's grid and
        values)."""
        pr = self.profiles
        e, s = np.asarray(expts), np.asarray(sites)
        return {
            "p_lev": pr["p_lev"][s], "t_lev": pr["t_lev"][e, s],
            "t_surf": pr["t_surf"][e, s],
            "ppmv": {m: v[e, s] for m, v in pr["ppmv"].items()},
            "cfc_ppmv": {k: v[e, s] for k, v in pr["cfc_ppmv"].items()},
            "cia_ppmv": {k: v[e, s] for k, v in pr["cia_ppmv"].items()},
            "mu": np.asarray(mu, np.float64), "tsi": pr["tsi"][s],
            **{k: pr[k][s] for k in ("albedo_grid", "albedo",
                                     "emissivity_grid", "emissivity")},
        }

    def column(self, expt: int, site: int, mu: float) -> dict:
        """One column of :meth:`columns`: (nlevels,) arrays and
        numbers."""
        cols = self.columns([expt], [site], [mu])
        return {k: ({m: a[0] for m, a in v.items()} if isinstance(v, dict)
                    else v[0]) for k, v in cols.items()}


def layout(cfg: dict):
    """The configuration's layout module, ``rtbench/layouts/<layout>.py``."""
    module = f"{__package__}.layouts.{cfg.get('layout', 'rfmip_irf')}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as err:
        if err.name != module:
            raise
        raise ValueError(f"{cfg['name']}: no layout "
                         f"{module.replace('.', '/')}.py") from err


def _gauss(w, spec):
    return spec["peak"] * np.exp(-0.5 * ((w - spec["center"])
                                         / spec["width"]) ** 2)


def _band(cfg: dict, name: str, seed: int, smoke: dict | None) -> Band:
    b = cfg["bands"][name]
    dw = b["dw"] * (smoke["grid_coarsen"] if smoke else 1)
    n = grid_points(b["w0"], b["wn"], dw)
    last = b["w0"] + (n - 1) * dw
    draws = cfg["line_draws"]
    lines = {}
    for mol, count in b["lines"].items():
        count = max(64, count // smoke["line_shrink"]) if smoke else count
        g = rng(seed, 1 if name == "lw" else 2, int(mol))

        def f32(lo_hi):
            return g.uniform(*lo_hi, count).astype(np.float32) \
                .astype(np.float64)

        lines[int(mol)] = dict(
            vnn=np.sort(g.uniform(b["w0"], last, count)),
            s0=10.0 ** g.uniform(*draws["log10_s0"], count),
            yair=f32(draws["yair"]), yself=f32(draws["yself"]),
            en=f32(draws["en"]), n=f32(draws["n"]), d=f32(draws["d"]))
    w = b["w0"] + dw * np.arange(n, dtype=np.float64)
    c = cfg["continua"]["h2o"]
    h2o = {"cs": c["cs"][0] * np.exp(-w / c["cs"][1]) + c["cs"][2],
           "cf": c["cf"][0] * np.exp(-w / c["cf"][1]) + c["cf"][2],
           "t0s": c["t0s"][0] + c["t0s"][1] * np.sin(w / c["t0s"][2]),
           "t0f": c["t0f"][0] + c["t0f"][1] * np.cos(w / c["t0f"][2])}
    return Band(
        name=name, w0=b["w0"], wn=b["wn"], dw=dw, n=n, method=b["method"],
        cutoff=b["cutoff"], lines=lines, h2o=h2o,
        o3=_gauss(w, cfg["continua"]["o3"]),
        cfcs={int(k): _gauss(w, v) for k, v in cfg["cfcs"].items()},
        cias=[(c["pair"][0], c["pair"][1], _gauss(w, c))
              for c in cfg["cias"]],
        bin_width=b.get("bin_width", 1.0),
        local_bins=b.get("local_bins", 1),
        remote_bins=b.get("remote_bins", 25))


def build(cfg: dict, seed: int, smoke: bool = False) -> Deployment:
    """The deployment of configuration ``cfg`` drawn from ``seed``;
    ``smoke`` takes the configuration's ``smoke`` cuts (fewer lines,
    coarser grids, and whatever the layout cuts) for a run on the CPU."""
    cut = cfg["smoke"] if smoke else None
    bands = {name: _band(cfg, name, seed, cut) for name in cfg["bands"]}
    lay = layout(cfg).build(cfg, seed, cut)
    solar = None
    if "sw" in bands:
        if lay.solar is None:
            sol = cfg["solar"]
            x = np.linspace(sol["w0"], sol["wn"], sol["samples"])
            y = np.exp(-0.5 * ((x - sol["center"]) / sol["width"]) ** 2) \
                + sol["floor"]
        else:
            x, y = lay.solar
        w = bands["sw"].wavenumbers
        c = np.interp(w, x, y)
        solar = c / np.sum(0.5 * (c[:-1] + c[1:]) * np.diff(w))
    return Deployment(config=cfg, bands=bands, solar=solar,
                      profiles=lay.profiles, sites=lay.sites,
                      experiments=lay.experiments)
