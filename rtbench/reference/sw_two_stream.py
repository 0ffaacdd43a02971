"""The reference's two-stream shortwave: delta-Eddington scaling and the
Meador-Weaver Eddington layer reflectance and transmittances, combined
by the adding method (Briegleb 1992), in the precision of its inputs.

A shortwave solver of the reference is ``rtbench/reference/
sw_<sw_solver>.py``, found by the configuration's ``sw_solver``, with
``fluxes(tau, omega, g, mu, albedo, tsi, solar, *, config)``.  Like the
rest of the reference it imports nothing of the program under test.
"""
from __future__ import annotations

import torch

DIFFUSE_MU = 0.5


def _two_stream(tau, omega, g, mu):
    """Delta-Eddington scaling and the Meador-Weaver Eddington layer
    reflectance and transmittances (direct total, diffuse, direct
    unscattered) for the beam of cosine ``mu``."""
    f = g * g
    omega_s = (1.0 - f) * omega / (1.0 - omega * f)
    g_s = g / (g + 1.0)
    t = tau * (1.0 - omega * f)
    g1 = 0.25 * (7.0 - omega_s * (4.0 + 3.0 * g_s))
    g2 = -0.25 * (1.0 - omega_s * (4.0 - 3.0 * g_s))
    g3 = 0.25 * (2.0 - 3.0 * g_s * mu)
    g4 = 1.0 - g3
    a1, a2 = g1 * g4 + g2 * g3, g1 * g3 + g2 * g4
    k = torch.sqrt(torch.clamp(g1 * g1 - g2 * g2, min=1e-12))
    e1, ek = torch.exp(-t / mu), torch.exp(-t * k)
    e2 = ek * ek
    den = (1.0 - k * k * mu * mu) * ((k + g1) + (k - g1) * e2)
    den = torch.where(den.abs() < 1e-12, torch.where(
        den < 0, -1e-12, 1e-12) * torch.ones_like(den), den)
    r = (omega_s / den) * ((1.0 - k * mu) * (a2 + k * g3)
                           - (1.0 + k * mu) * (a2 - k * g3) * e2
                           - 2.0 * k * (g3 - a2 * mu) * e1 * ek)
    tr = e1 - (omega_s / den) * ((1.0 + k * mu) * (a1 + k * g4) * e1
                                 - (1.0 - k * mu) * (a1 - k * g4) * e1 * e2
                                 - 2.0 * k * (g4 + a1 * mu) * ek)
    r_c = (g1 * t + (g3 - g1 * mu) * (1.0 - e1)) / (1.0 + g1 * t)
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    none, clear, cons = omega_s <= 0.0, t <= 0.0, omega_s >= 1.0
    r = torch.where(none | clear, zero, torch.where(cons, r_c, r))
    tr = torch.where(none, e1, torch.where(clear, one,
                                           torch.where(cons, 1.0 - r_c, tr)))
    pure = torch.where(clear & ~none, one, e1)
    return r, tr, pure


def fluxes(tau, omega, g, mu, albedo, tsi, solar, *, config=None):
    """Two-stream fluxes (nlevels, n), up and down, by the adding method
    (Briegleb 1992): ``tau``, ``omega``, ``g`` (nlayers, n), the direct
    beam's cosine ``mu``, the surface ``albedo`` (n,), ``tsi`` and the
    incident spectrum ``solar`` (n,).  ``config`` (the configuration)
    sets nothing here."""
    r_dir, t_dir, t_pure = _two_stream(tau, omega, g, mu)
    t_dir = torch.maximum(t_dir, t_pure)
    r_dif, t_dif, _ = _two_stream(tau, omega, g, DIFFUSE_MU)
    nlay = tau.shape[0]
    alb = albedo * torch.ones_like(tau[0])
    below_dir, below_dif = [alb], [alb]
    for k in reversed(range(nlay)):
        b = 1.0 / (1.0 - r_dif[k] * below_dif[-1])
        below_dir.append(r_dir[k] + (t_pure[k] * below_dir[-1] + (
            t_dir[k] - t_pure[k]) * below_dif[-1]) * t_dif[k] * b)
        below_dif.append(r_dif[k] + t_dif[k] ** 2 * below_dif[-1] * b)
    below_dir, below_dif = below_dir[::-1], below_dif[::-1]
    above = [r_dif[0]]
    for k in range(1, nlay):
        above.append(r_dif[k] + t_dif[k] ** 2 * above[-1]
                     / (1.0 - r_dif[k] * above[-1]))
    direct, diffuse = torch.ones_like(alb), torch.zeros_like(alb)
    up, down = [below_dir[0]], [torch.ones_like(alb)]
    for k in range(nlay):
        prev = above[k - 1] if k > 0 else torch.zeros_like(alb)
        diffuse = (direct * r_dir[k] * prev + diffuse) * t_dif[k] / (
            1.0 - r_dif[k] * prev) + direct * (t_dir[k] - t_pure[k])
        direct = direct * t_pure[k]
        b = 1.0 / (1.0 - below_dif[k + 1] * above[k])
        up.append((direct * below_dir[k + 1] + diffuse * below_dif[k + 1])
                  * b)
        down.append(direct * (1.0 + below_dir[k + 1] * above[k] * b)
                    + diffuse * b)
    scale = tsi * mu * solar
    return torch.stack(up) * scale, torch.stack(down) * scale
