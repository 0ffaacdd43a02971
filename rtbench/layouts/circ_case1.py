"""The CIRC Phase I case 1 layout (Oreopoulos et al. 2012, JGR 117,
D06118), as GRTCODE's CIRC binary reads the case (basic-circ-test.c with
circ1.h): one clear, clean column of 55 levels.

The case's public data, the arrays read here, is frozen beside this file
(``circ_case1.npz``).  Per-layer abundances go to levels linearly in
pressure, each end level taking its nearest layer's value (the binary's
rule); N2 is well mixed at 0.781 for the CIA pairs, O2 takes its own
profile.  Emissivity is 1 (the grid [1, 2] cm-1); the surface albedo and
the incident solar spectrum are the case's 49,180-point spectra on
820-49,999 cm-1.  The sun is the case's: mu0 = cos 47.88 deg, and the
TSI is the case's horizontal TOA irradiance over mu0.

Nothing is drawn from the seed: every seed runs the same column (the
line catalogs are the configuration's, drawn by ``rtbench.deployment``).
A cut (a CPU rehearsal's) with ``sites`` above 1 holds two copies of the
column, the second under a lower sun, so that a rehearsal's batch has
columns that differ; two, whatever the cut asks, as the CPU's DISORT
takes ~40 s a column at 6,250 points.
"""
from __future__ import annotations

import os

import numpy as np

from ..deployment import Layout
from .rfmip_irf import FLAT_GRID, _layers_to_levels

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "circ_case1.npz")
MOLECULES = {1: "H2O", 2: "CO2", 3: "O3", 4: "N2O", 5: "CO", 6: "CH4",
             7: "O2"}
CFCS = {0: "CFC11", 1: "CFC12", 15: "CCl4"}
N2, O2 = 0, 1           # CIA species ids
N2_PPMV = 0.781e6


def case() -> dict:
    """The case's arrays, as frozen."""
    with np.load(DATA) as d:
        return {k: d[k] for k in d.files}


def build(cfg: dict, seed: int, cut: dict | None) -> Layout:
    """The case's column (``seed`` draws nothing); two copies of it
    under a cut with more than one site."""
    d = case()
    L = cfg["levels"]
    p_lev, p_lay = d["level_pressure"], d["layer_pressure"]
    if p_lev.size != L:
        raise ValueError(f"{cfg['name']}: levels {L}, the case has "
                         f"{p_lev.size}")
    nsite = 2 if cut and cut["sites"] > 1 else 1
    mu0 = np.cos(np.deg2rad(float(d["solar_zenith_angle"])))
    mu = np.array([mu0, 0.5 * mu0])[:nsite]

    def by_site(a):            # (L,) -> (1, nsite, L)
        return np.broadcast_to(a, (1, nsite) + a.shape)

    def level_ppmv(name):
        return by_site(_layers_to_levels(d[f"{name}_abundance"], p_lay,
                                         p_lev) * 1e6)

    ppmv = {m: level_ppmv(n) for m, n in MOLECULES.items()}
    albedo, wavenumber = d["surface_albedo"], d["wavenumber"]
    profiles = {
        "p_lev": np.broadcast_to(p_lev, (nsite, L)),
        "t_lev": by_site(d["level_temperature"]),
        "t_surf": np.full((1, nsite), float(d["surface_temperature"])),
        "ppmv": ppmv,
        "cfc_ppmv": {c: level_ppmv(n) for c, n in CFCS.items()},
        "cia_ppmv": {N2: by_site(np.full(L, N2_PPMV)), O2: ppmv[7]},
        "mu_site": mu,
        "tsi": np.full(nsite, float(d["toa_solar_irradiance"]) / mu0),
        "emissivity_grid": np.broadcast_to(FLAT_GRID, (nsite, 2)),
        "emissivity": np.ones((nsite, 2)),
        "albedo_grid": np.broadcast_to(wavenumber, (nsite,) + albedo.shape),
        "albedo": np.broadcast_to(albedo, (nsite,) + albedo.shape),
    }
    return Layout(sites=nsite, experiments=1, profiles=profiles,
                  solar=(wavenumber, d["toa_solar_function"]))
