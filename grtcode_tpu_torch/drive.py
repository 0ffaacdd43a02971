"""The port's library recipe, driven through its public imports only:
SpectralGrid -> GasOptics (a synthetic catalog) -> optical_depth ->
Optics -> longwave_fluxes / shortwave_fluxes -> trapezoid-integrated
fluxes, the counterpart of the JAX package's verify recipe.

    python -m grtcode_tpu_torch.drive [--device cuda:0|cpu]

checks the recipe's five physics invariants on one synthetic column
(:func:`physics_invariants`) and prints each value beside its bar; it
exits non-zero if one fails.  The default device is ``cuda:0``; without
a GPU it exits unless ``--device cpu`` is given.

:func:`clear_sky_step` is the same recipe at a model's full width: the
clear-sky aerosol-free (CSAF) fluxes of a batch of lit columns, built by
hand from the per-band gas optics, Rayleigh optics, ``+`` and the solvers,
with the same inputs and expression order as ``RadiationDriver.run``.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from grtcode_tpu_torch import Optics, SpectralGrid
from grtcode_tpu_torch.framework import Atmosphere
from grtcode_tpu_torch.gas_optics import GasOptics, synthetic_catalog
from grtcode_tpu_torch.solvers import (SolarFlux, longwave_fluxes,
                                       planck_law, rayleigh_optics,
                                       shortwave_fluxes)
from grtcode_tpu_torch.utils import interpolate_to_grid_np
from grtcode_tpu_torch.utils.interp import trapezoid_uniform

SIGMA = 5.670374419e-8   # Stefan-Boltzmann [W m-2 K-4]
DIFFUSE_MU = 0.5         # the driver's diffuse-beam cosine


def clear_sky_step(lw_gas: GasOptics, sw_gas: GasOptics, solar: SolarFlux,
                   atm: Atmosphere) -> dict:
    """Integrated CSAF fluxes {"rlu", "rld", "rsu", "rsd"}, each (B,
    nlevels), of ``atm`` (every column lit) on the gas optics' device."""
    if atm.cos_zenith is None or not np.all(atm.cos_zenith > 0.0):
        raise ValueError("clear_sky_step needs every column lit")
    dev = lw_gas.device
    lwg, swg = lw_gas.grid, sw_gas.grid

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=dev)

    def vmr(ppmv):
        return {k: np.asarray(v, np.float64) * 1e-6 for k, v in ppmv.items()}

    p, t = atm.level_pressure, atm.level_temperature
    xs = dict(cfc_vmr=vmr(atm.cfc_ppmv), cia_vmr=vmr(atm.cia_ppmv))
    t_lev, t_lay, t_surf = f32(t), f32(atm.layer_temperature), \
        f32(atm.surface_temperature)

    # Longwave: gas optics alone.
    gas_lw = Optics.from_tau(lw_gas.optical_depth(p, t, vmr(atm.ppmv), **xs),
                             lwg)
    emis = (np.ones((atm.batch, lwg.n)) if atm.emissivity is None else
            interpolate_to_grid_np(lwg, atm.emissivity_grid, atm.emissivity,
                                   extrapolate="constant"))
    flu, fld = longwave_fluxes(gas_lw.tau, gas_lw.omega, t_surf, t_lay,
                               t_lev, f32(emis), lwg.wavenumbers(dev))
    out = {"rlu": trapezoid_uniform(flu, lwg.dw),
           "rld": trapezoid_uniform(fld, lwg.dw)}
    del gas_lw, flu, fld

    # Shortwave: gas + Rayleigh, combined.
    opt = Optics.from_tau(sw_gas.optical_depth(p, t, vmr(atm.ppmv), **xs),
                          swg) + rayleigh_optics(p, swg, device=dev)
    albedo = f32(interpolate_to_grid_np(swg, atm.albedo_grid, atm.albedo,
                                        extrapolate="constant"))
    mu = torch.clamp(f32(atm.cos_zenith), min=1e-6)
    fsu, fsd = shortwave_fluxes(opt.tau, opt.omega, opt.g, mu,
                                torch.full_like(mu, DIFFUSE_MU), albedo,
                                albedo, f32(atm.total_solar_irradiance),
                                solar.incident_flux)
    out["rsu"] = trapezoid_uniform(fsu, swg.dw)
    out["rsd"] = trapezoid_uniform(fsd, swg.dw)
    return out


def _check(name, value, bar, ok):
    return {"name": name, "value": float(value), "bar": bar, "ok": bool(ok)}


def physics_invariants(device) -> list[dict]:
    """The recipe's five invariants on one synthetic 11-layer column
    (level 0 = TOA); each record holds its value, its bar and whether it
    holds."""
    dev = torch.device(device)
    grid = SpectralGrid(1.0, 3250.0, 0.5)
    nlev, ts = 12, 290.0
    w = grid.wavenumbers(dev)
    p = 0.01 + 1013.0 * (torch.arange(nlev, dtype=torch.float32,
                                      device=dev) / (nlev - 1.0)) ** 2
    t = torch.linspace(220.0, 288.0, nlev, device=dev)
    tl = 0.5 * (t[:-1] + t[1:])
    t_surf = torch.tensor(ts, device=dev)
    emis = torch.ones(grid.n, device=dev)

    def lw(tau):
        return longwave_fluxes(tau, torch.zeros_like(tau), t_surf, tl, t,
                               emis, w)

    def integral(y):
        return float(trapezoid_uniform(y, grid.dw))

    checks = []
    # 1. Transparent LW: OLR = sigma Ts^4 (the band ends at 3250 cm-1),
    #    no downwelling at the surface.
    up, dn = lw(torch.zeros((nlev - 1, grid.n), device=dev))
    bb = SIGMA * ts ** 4
    rel = abs(integral(up[0]) - bb) / bb
    checks.append(_check("1 transparent: |OLR - sigma Ts^4| / sigma Ts^4",
                         rel, "< 0.02", rel < 0.02))
    sfc = integral(dn[-1])
    checks.append(_check("1 transparent: surface down [W m-2]", sfc,
                         "< 1e-3", sfc < 1e-3))
    # 2. Opaque LW: surface down = sigma T^4 of the surface level.
    up, dn = lw(torch.full((nlev - 1, grid.n), 50.0, device=dev))
    bb = SIGMA * float(t[-1]) ** 4
    rel = abs(integral(dn[-1]) - bb) / bb
    checks.append(_check("2 opaque: |surface down - sigma T_sfc^4| / "
                         "sigma T_sfc^4", rel, "< 0.03", rel < 0.03))
    # 3. Clear SW: TOA down = TSI mu, TOA up = TSI mu albedo.
    swg = SpectralGrid(2000.0, 4000.0, 1.0)
    tau = torch.zeros((nlev - 1, swg.n), device=dev)
    sflux = torch.full((swg.n,), 1.0 / (swg.dw * (swg.n - 1)), device=dev)
    alb = torch.full((swg.n,), 0.2, device=dev)
    swup, swdn = shortwave_fluxes(
        tau, tau, tau, torch.tensor(0.6, device=dev),
        torch.tensor(DIFFUSE_MU, device=dev), alb, alb,
        torch.tensor(1361.0, device=dev), sflux)
    want = 1361.0 * 0.6
    rel = abs(float(trapezoid_uniform(swdn[0], swg.dw)) - want) / want
    checks.append(_check("3 clear SW: |TOA down - TSI mu| / TSI mu", rel,
                         "< 0.02", rel < 0.02))
    rel = abs(float(trapezoid_uniform(swup[0], swg.dw)) - want * 0.2) / \
        (want * 0.2)
    checks.append(_check("3 clear SW: |TOA up - TSI mu albedo| / "
                         "TSI mu albedo", rel, "< 0.05", rel < 0.05))
    # 4. Gas tau peaks at the strongest line; the pressure-broadened wing
    #    is stronger in the bottom layer than in the top one.
    gas = GasOptics(grid, line_chunk=32, device=dev)
    gas.add_catalog(synthetic_catalog(
        1, np.array([500.0, 1500.0, 2500.0]), np.array([1e-20, 5e-19, 1e-20]),
        yair=np.full(3, 0.08), yself=np.full(3, 0.3), en=np.zeros(3),
        n=np.full(3, 0.5), d=np.zeros(3)))
    tau = gas.optical_depth(p, t, {1: torch.full((nlev,), 3e-3, device=dev)})
    peak = int(torch.argmax(tau.sum(0)))
    off = abs(float(w[peak]) - 1500.0)
    checks.append(_check("4 gas: |peak wavenumber - 1500| [cm-1]", off,
                         "< 1", off < 1.0))
    ratio = float(tau[-1, peak + 20]) / float(tau[0, peak + 20])
    checks.append(_check("4 gas: wing tau bottom / top layer", ratio, "> 1",
                         ratio > 1.0))
    # 5. OLR at the line center is below pi B(Ts); in a window it is
    #    pi B(Ts).
    up, _ = lw(tau)
    b = math.pi * planck_law(t_surf, torch.tensor([1500.0, 800.0],
                                                  device=dev)).cpu().numpy()
    ratio = float(up[0, peak]) / b[0]
    checks.append(_check("5 line center: OLR / pi B(Ts)", ratio, "< 0.95",
                         ratio < 0.95))
    rel = abs(float(up[0, grid.point_index(800.0)]) - b[1]) / b[1]
    checks.append(_check("5 window: |OLR - pi B(Ts)| / pi B(Ts)", rel,
                         "< 0.02", rel < 0.02))
    return checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0; 'cpu' to run "
                        "without a GPU)")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    checks = physics_invariants(dev)
    for c in checks:
        print(f"{'ok  ' if c['ok'] else 'FAIL'} {c['name']}: "
              f"{c['value']:.6g} (bar {c['bar']})")
    failed = [c["name"] for c in checks if not c["ok"]]
    print(f"{len(checks) - len(failed)} of {len(checks)} checks hold on "
          f"{dev}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
