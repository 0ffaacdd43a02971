"""A deployment's inputs, made in the process from its configuration file
and the run's seed.

Everything here is raw input in float64 numpy, handed alike to the
program under test (``rtbench.program``) and to the plain reference
(``rtbench.reference``): the line catalogs, the continua, cross sections
and solar spectrum on each band's grid, and the (experiment, site, level)
profiles of the RFMIP-IRF layout.  What either side derives from them
(grid-bound catalogs, line prep, bin tables, folded CIA factors) it
works out itself.

The line parameters the program keeps in float32 (half-widths, lower
state energy, temperature exponent, shift) are drawn as float32 values,
so both sides start from the same numbers.
"""
from __future__ import annotations

import dataclasses
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
class Deployment:
    config: dict
    bands: dict         # "lw" [/ "sw"] -> Band
    solar: np.ndarray | None    # (n_sw,) incident spectrum, integral 1
    profiles: dict      # see _profiles
    sites: int
    experiments: int

    def columns(self, expts, sites, mu) -> dict:
        """The (B, ...) arrays of the columns (experiment, site) with
        cosines of zenith ``mu``: level pressure [mb] and temperature [K],
        surface temperature, abundances [ppmv] at levels, TSI, grey
        albedo and emissivity."""
        pr = self.profiles
        e, s = np.asarray(expts), np.asarray(sites)
        return {
            "p_lev": pr["p_lev"][s], "t_lev": pr["t_lev"][e, s],
            "t_surf": pr["t_surf"][e, s],
            "ppmv": {m: v[e, s] for m, v in pr["ppmv"].items()},
            "cfc_ppmv": {k: v[e, s] for k, v in pr["cfc_ppmv"].items()},
            "cia_ppmv": {k: v[e, s] for k, v in pr["cia_ppmv"].items()},
            "mu": np.asarray(mu, np.float64), "tsi": pr["tsi"][s],
            "albedo": pr["albedo"][s], "emissivity": pr["emissivity"][s],
        }

    def column(self, expt: int, site: int, mu: float) -> dict:
        """One column of :meth:`columns`: (nlevels,) arrays and
        numbers."""
        cols = self.columns([expt], [site], [mu])
        return {k: ({m: a[0] for m, a in v.items()} if isinstance(v, dict)
                    else v[0]) for k, v in cols.items()}


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


def _layers_to_levels(lay, p_lay, p_lev):
    """Layer values to levels, linear in pressure, the end levels taking
    the nearest layer's value (the RFMIP-IRF app's rule)."""
    out = np.empty(lay.shape[:-1] + (p_lev.shape[-1],))
    out[..., 0], out[..., -1] = lay[..., 0], lay[..., -1]
    out[..., 1:-1] = lay[..., :-1] + (lay[..., 1:] - lay[..., :-1]) * (
        (p_lev[..., 1:-1] - p_lay[..., :-1])
        / (p_lay[..., 1:] - p_lay[..., :-1]))
    return out


def _profiles(cfg: dict, seed: int, nsite: int, nexpt: int) -> dict:
    pc = cfg["profiles"]
    L = cfg["levels"]
    g = rng(seed, 3)
    p_lev = (np.linspace(*pc["pressure_pa"], L)[None, :] * 0.01
             * g.uniform(*pc["site_pressure_factor"], (nsite, 1)))   # mb
    p_lay = 0.5 * (p_lev[:, :-1] + p_lev[:, 1:])
    expts = cfg["experiments_by_index"][:nexpt]
    warm = np.array([e.get("warming_k", 0.0) for e in expts])
    t_lev = (np.linspace(*pc["temperature_k"], L)[None, None, :]
             + g.uniform(-pc["temperature_jitter_k"],
                         pc["temperature_jitter_k"], (nexpt, nsite, L))
             + warm[:, None, None])
    base = {k: float(v) for k, v in cfg["present_day_ppmv"].items()}
    per_expt = []
    for e in expts:
        v = dict(base, **{k: float(x) for k, x in e.get("ppmv", {}).items()})
        for k, f in e.get("scale", {}).items():
            v[k] = v.get(k, 1.0) * f
        per_expt.append(v)

    def scale(key):
        return np.array([v.get(key, 1.0) if key in ("1", "3") else 1.0
                         for v in per_expt])[:, None, None]

    h2o = np.maximum(pc["h2o_floor"], pc["h2o_surface"]
                     * (p_lay[None] / 1000.0) ** pc["h2o_exponent"]
                     * g.uniform(*pc["h2o_jitter"], (nexpt, nsite, L - 1)))
    o3 = g.uniform(*pc["o3"], (nexpt, nsite, L - 1))
    ppmv = {1: _layers_to_levels(h2o * scale("1") * 1e6, p_lay[None],
                                 p_lev[None]),
            3: _layers_to_levels(o3 * scale("3") * 1e6, p_lay[None],
                                 p_lev[None])}
    molecules = sorted({int(m) for band in cfg["bands"].values()
                        for m in band["lines"]})
    full = (nexpt, nsite, L)
    for m in molecules:
        if m not in ppmv:
            ppmv[m] = np.broadcast_to(
                np.array([v[str(m)] for v in per_expt])[:, None, None], full)
    table = {}
    for prefix in ("cfc", "cia"):
        table[prefix] = {
            int(k.split("_")[1]): np.broadcast_to(
                np.array([v[k] for v in per_expt])[:, None, None], full)
            for k in base if k.startswith(prefix + "_")}
    zen = np.resize(np.asarray(pc["zenith_deg_by_site"], np.float64), nsite)
    return {
        "p_lev": p_lev, "t_lev": t_lev,
        "t_surf": t_lev[..., -1] + pc["surface_dt_k"],
        "ppmv": ppmv, "cfc_ppmv": table["cfc"], "cia_ppmv": table["cia"],
        "mu_site": np.cos(np.deg2rad(zen)),
        "tsi": np.full(nsite, float(pc["tsi"])),
        "albedo": g.uniform(*pc["albedo"], nsite),
        "emissivity": g.uniform(*pc["emissivity"], nsite),
    }


def build(cfg: dict, seed: int, smoke: bool = False) -> Deployment:
    """The deployment of configuration ``cfg`` drawn from ``seed``;
    ``smoke`` takes the configuration's ``smoke`` cuts (fewer lines,
    coarser grids, fewer sites and experiments) for a run on the CPU."""
    cut = cfg["smoke"] if smoke else None
    nsite = cut["sites"] if cut else cfg["sites"]
    nexpt = cut["experiments"] if cut else cfg["experiments"]
    bands = {name: _band(cfg, name, seed, cut) for name in cfg["bands"]}
    solar = None
    if "sw" in bands:
        sol = cfg["solar"]
        x = np.linspace(sol["w0"], sol["wn"], sol["samples"])
        y = np.exp(-0.5 * ((x - sol["center"]) / sol["width"]) ** 2) \
            + sol["floor"]
        w = bands["sw"].wavenumbers
        c = np.interp(w, x, y)
        solar = c / np.sum(0.5 * (c[:-1] + c[1:]) * np.diff(w))
    return Deployment(config=cfg, bands=bands, solar=solar,
                      profiles=_profiles(cfg, seed, nsite, nexpt),
                      sites=nsite, experiments=nexpt)
