"""The RFMIP-IRF layout: ``sites`` x ``experiments`` columns of
``levels`` levels, drawn from the run's seed in the configuration's
``profiles`` recipe (after ``examples.write_rfmip_input``), each
experiment's global-mean abundances from ``present_day_ppmv`` and
``experiments_by_index``.  Each site's surface is grey: its albedo and
emissivity drawn once, as the RFMIP-IRF app's two-point spectra on the
grid [1, 2] cm-1.  The shortwave band's incident spectrum is the
configuration's analytic ``solar``.

A layout module's ``build(cfg, seed, cut)`` returns a
``deployment.Layout``; ``rtbench.deployment`` finds it by the
configuration's ``layout`` name (``rfmip_irf`` where it names none).
"""
from __future__ import annotations

import numpy as np

from ..deployment import Layout, rng

FLAT_GRID = np.array([1.0, 2.0])        # [cm-1]


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


def build(cfg: dict, seed: int, cut: dict | None) -> Layout:
    """The layout of ``cfg`` drawn from ``seed``; ``cut`` (the
    configuration's ``smoke`` cuts, or None) sets fewer sites and
    experiments."""
    nsite = cut["sites"] if cut else cfg["sites"]
    nexpt = cut["experiments"] if cut else cfg["experiments"]
    pr = _profiles(cfg, seed, nsite, nexpt)
    for k in ("albedo", "emissivity"):
        pr[f"{k}_grid"] = np.tile(FLAT_GRID, (nsite, 1))
        pr[k] = np.repeat(pr[k][:, None], FLAT_GRID.size, axis=1)
    return Layout(sites=nsite, experiments=nexpt, profiles=pr)
