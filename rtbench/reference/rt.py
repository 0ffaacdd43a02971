"""Plain clear-sky column fluxes: the layers of a ``RadiationDriver.run``
call, written out one after another for one column at a time.

1. Curtis-Godson layer averages and column densities.
2. Line prep: pressure-shifted centres, temperature-corrected strengths
   (TIPS partition sums), Lorentz and Doppler half-widths.
3. The Voigt sum in the band's method: ``line_sample`` (every line on
   the grid points within its cutoff of its nearest point) or
   ``wavenumber_sweep`` (each ~1 cm-1 bin takes its near lines exactly on
   its fine points and its far lines at three points, quadratically
   interpolated after every absorber), with the five-region Humlicek
   profile.
4. H2O and O3 continua, CFC and CIA cross sections.
5. The surface spectra on each band's grid, Rayleigh optics and the
   configuration's shortwave solver, ``sw_<sw_solver>.py`` beside this
   file (lit columns only: a night column's shortwave fluxes are zero),
   the four-stream absorption solver with Clough's effective Planck
   source (longwave).
6. Trapezoid integrals over each band.

Everything is computed in ``dtype`` (float64 by default; the control
runs it in a lower precision).  The semantics, constants and table rules
are those of the reference C (NOAA-GFDL GRTCODE) as the JAX package and
its port state them; the code is this file's own.  The constants below
are frozen copies of ``grtcode_tpu_torch/constants.py`` at commit 64ee402
(each the reference C's value).
"""
from __future__ import annotations

import importlib
import json
import math
import os

import numpy as np
import torch

PLANCK_C1 = 1.1910429526245744e-8     # 2 h c^2 [W cm4 m-2]
PLANCK_C2 = 1.4387773538277202        # h c / k [cm K]
LINE_STRENGTH_C2 = -1.4387686         # -h c / k of the line strengths
TREF = 296.0
SQRT_LN2 = 0.832554611
RSQRPI = 0.56418958
PI = 3.14159265358979323846
KB_CGS = 1.380658e-16
C_CGS = 2.99792458e10
AVOGADRO_REF = 6.023e23
COLUMN_DENSITY_C = 2.147822334314468e25
MB_TO_ATM = 0.000986923
MAX_EXP_ARG = 700.0
LW_SECANTS = (-14.402613260847248, -3.0302159969901132,
              -1.4925584280108841, -1.0746123148178333)
LW_WEIGHTS = (0.07587638482015649, 0.676114979733751, 1.3726594476601073,
              1.0169418413757783)
PLANCK_A, PLANCK_B = 0.193, 0.013     # Clough et al. 1992 eq. 16
CIA_FACTOR = (1.013e6 * 1.013e6) / (1.38064852e-16 * (28.97 / 6.02214076e23)
                                    * 980.0 * 2.0)
MU_FLOOR = 1e-6
# Principal-isotopologue molar masses [g mol-1] (molecules.c).
MOLAR_MASS = {1: 18.010565, 2: 43.98983, 3: 47.984745, 4: 44.001062,
              5: 27.994915, 6: 16.0313, 7: 31.98983}
H2O, O3 = 1, 3
NIP = 3                 # interpolation points of a bin

# Most (layer, line, point) samples evaluated at once.
SAMPLES_PER_STEP = 1 << 25

_CPF_C = (1.0117281, -0.75197147, 0.012557727, 0.010022008,
          -0.00024206814, 0.00000050084806)
_CPF_S = (1.393237, 0.23115241, -0.15535147, 0.0062183662, 0.000091908299,
          -0.00000062752596)
_CPF_T = (0.31424038, 0.94778839, 1.5976826, 2.2795071, 3.0206370,
          3.8897249)


class PartitionSums:
    """Q(T) of each molecule's principal isotopologue, linear in T
    between the tabulated temperatures and held at the table's ends."""

    def __init__(self, path: str | None = None):
        path = path or os.path.join(os.path.dirname(__file__),
                                    "tips2017_iso1.json")
        with open(path) as f:
            data = json.load(f)
        self.t = np.asarray(data["T"], np.float64)
        self.q = {int(m): np.asarray(v, np.float64)
                  for m, v in data["Q"].items()}

    def __call__(self, mol: int, t: np.ndarray) -> np.ndarray:
        return np.interp(t, self.t, self.q[mol])


def _xlim0(y):
    return torch.sqrt(15100.0 + y * (40.0 - y * 3.6))


def humlicek(x, y):
    """Humlicek's K(x, y) over the five regions of the RFM formulation
    (y < 70.55)."""
    yq = y * y
    ax = x.abs()
    xq = ax * ax
    xlim0 = _xlim0(y)
    xlim1 = torch.where(y >= 8.425, torch.zeros_like(y), torch.sqrt(
        torch.clamp(164.0 - y * (4.3 + y * 1.8), min=0.0)))
    xlim2 = 6.8 - y
    tiny = y <= 0.000001
    xlim1 = torch.where(tiny, xlim0, xlim1)
    xlim2 = torch.where(tiny, xlim0, xlim2)

    k0 = y * RSQRPI / (xq + yq)
    a0 = yq + 0.5
    k1 = RSQRPI * y * (a0 + xq) / (a0 * a0 + xq * (yq + yq - 1.0 + xq))
    h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)))
    h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0))
    h4 = 10.5 - yq * (6.0 - yq * 6.0)
    h6 = -6.0 + yq * 4.0
    e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq))
    e2 = 5.25 + yq * (1.0 + yq * 3.0)
    e4 = 0.75 * h6
    k2 = RSQRPI * y * (e0 + xq * (e2 + xq * (e4 + xq))) / (
        h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq))))

    def poly(coeffs):
        out = torch.zeros_like(y) + coeffs[-1]
        for c in reversed(coeffs[:-1]):
            out = c + y * out
        return out

    z = [poly(c) for c in (
        (272.1014, 1280.829, 2802.870, 3764.966, 3447.629, 2256.981,
         1074.409, 369.1989, 88.26741, 13.39880, 1.0),
        (211.678, 902.3066, 1758.336, 2037.310, 1549.675, 793.4273,
         266.2987, 53.59518, 5.0),
        (78.86585, 308.1852, 497.3014, 479.2576, 269.2916, 80.39278, 10.0),
        (22.03523, 55.02933, 92.75679, 53.59518, 10.0),
        (1.496460, 13.39880, 5.0))]
    p = [poly(c) for c in (
        (153.5168, 549.3954, 919.4955, 946.8970, 662.8097, 328.2151,
         115.3772, 27.93941, 4.264678, 0.3183291),
        (-34.16955, -1.322256, 124.5975, 189.7730, 139.4665, 56.81652,
         12.79458, 1.2733163),
        (2.584042, 10.46332, 24.01655, 29.81482, 12.79568, 1.9099744),
        (-0.07272979, 0.9377051, 4.266322, 1.273316),
        (0.0005480304, 0.3183291))]
    k3 = 1.7724538 * (p[0] + xq * (p[1] + xq * (p[2] + xq * (
        p[3] + xq * p[4])))) / (z[0] + xq * (z[1] + xq * (z[2] + xq * (
            z[3] + xq * (z[4] + xq)))))

    ypy0 = y + 1.5
    ypy0q = ypy0 * ypy0
    k4a = torch.zeros_like(x)
    k4b = torch.zeros_like(x)
    for c, s, t in zip(_CPF_C, _CPF_S, _CPF_T):
        dm, dp = x - t, x + t
        mq, pq = dm * dm, dp * dp
        mf, pf = 1.0 / (mq + ypy0q), 1.0 / (pq + ypy0q)
        xm, ym, xp, yp = mf * dm, mf * ypy0, pf * dp, pf * ypy0
        k4a = k4a + c * (ym + yp) - s * (xm - xp)
        k4b = k4b + (c * (mq * mf - 1.5 * ym) + s * (y + 3.0) * xm) / (
            mq + 2.25) + (c * (pq * pf - 1.5 * yp) - s * (y + 3.0) * xp) / (
            pq + 2.25)
    k4 = torch.where(ax <= 18.1 * y + 1.65, k4a, y * k4b + torch.exp(-xq))

    return torch.where(ax >= xlim0, k0, torch.where(
        ax >= xlim1, k1, torch.where(ax >= xlim2, k2, torch.where(
            ax < 2.4 * y, k3, k4))))


def voigt(dv, lorentz, doppler):
    """The Voigt profile [cm] at offsets ``dv`` [cm-1] from a line centre
    of Lorentz and Doppler (sqrt(ln 2) convention) half-widths: the
    Lorentz wing where Humlicek's region 0 holds, the pure Lorentz
    profile for y >= 70.55, else the five-region K."""
    repwid = SQRT_LN2 / doppler
    y = repwid * lorentz
    x, y, repwid = torch.broadcast_tensors(dv * repwid, y, repwid)
    lor = y >= 70.55
    yc = torch.clamp(y, max=70.0)
    ax = x.abs()
    k = torch.where(lor, repwid * y / (PI * (x * x + y * y)),
                    RSQRPI * repwid * (yc * RSQRPI) / (ax * ax + yc * yc))
    core = ~lor & (ax < _xlim0(yc))
    if bool(core.any()):
        k[core] = RSQRPI * repwid[core] * humlicek(x[core], yc[core])
    return k


class Column:
    """The layers of one column, or of a batch of columns (level arrays
    (B, nlevels)), as rows (column-major, then layer): ``p`` [atm] and
    ``t_lev`` [K] at levels, layer means, air column densities [cm-2]."""

    def __init__(self, col: dict, dtype, device):
        self.dtype, self.device = dtype, device
        self.col = col
        self.p = np.asarray(col["p_lev"], np.float64) * MB_TO_ATM
        self.t_lev = np.asarray(col["t_lev"], np.float64)
        self.pavg = self.mean(self.p)
        self.tavg = self.mean(self.t_lev)
        self._n = COLUMN_DENSITY_C * np.abs(self.p[..., :-1]
                                            - self.p[..., 1:])
        self.n = self._n.reshape(-1)

    @staticmethod
    def mean(x_lev):
        """Layer means of level values, as rows."""
        return (0.5 * (x_lev[..., :-1] + x_lev[..., 1:])).reshape(-1)

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device
                               ).to(self.dtype)

    def species(self, x_lev):
        """(partial pressure [atm], column density [cm-2]) by row of a
        species at level mole fractions ``x_lev``."""
        p0, p1 = self.p[..., :-1], self.p[..., 1:]
        x0, x1 = x_lev[..., :-1], x_lev[..., 1:]
        ps = (x0 * p0 + x1 * p1) / 3.0 + (x0 * p1 + x1 * p0) / 6.0
        return ps.reshape(-1), (self._n * 0.5 * (x0 + x1)).reshape(-1)


def line_prep(column: Column, mol: int, lines: dict, band, tips):
    """(centre position [grid units], strength x column density,
    Lorentz, Doppler), each (nlayers, L), of one molecule's lines."""
    c = column
    x = np.asarray(c.col["ppmv"][mol], np.float64) * 1e-6
    ps, ns = c.species(x)
    T, P, PS = (c.tensor(a)[:, None] for a in (c.tavg, c.pavg, ps))
    v0, s0, yair, yself, en, n_exp, d = (
        c.tensor(lines[k])[None, :]
        for k in ("vnn", "s0", "yair", "yself", "en", "n", "d"))
    pos = (v0 - band.w0) / band.dw + d * P / band.dw
    q_ratio = c.tensor(tips(mol, np.array([TREF]))[0]
                       / tips(mol, c.tavg))[:, None]
    boltz = (torch.exp(LINE_STRENGTH_C2 * en / T)
             * (1.0 - torch.exp(LINE_STRENGTH_C2 * v0 / T))) / (
        torch.exp(LINE_STRENGTH_C2 * en / TREF)
        * (1.0 - torch.exp(LINE_STRENGTH_C2 * v0 / TREF)))
    strength = s0 * q_ratio * boltz * c.tensor(ns)[:, None]
    lorentz = torch.pow(TREF / T, n_exp) * (yair * (P - PS) + yself * PS)
    mass = MOLAR_MASS[mol] / AVOGADRO_REF
    doppler = SQRT_LN2 * (v0 + d * P) * torch.sqrt(
        2.0 * KB_CGS * T / (mass * C_CGS * C_CGS))
    return pos, strength, lorentz, doppler


def _index_add(target, index, values):
    target.view(-1).index_add_(0, index.reshape(-1), values.reshape(-1))


def line_sample(tau, pos, strength, lorentz, doppler, band):
    """Every line, whose shifted centre rounds to a grid point, on the
    grid points within ceil(cutoff / dw) points of that point."""
    nlay, L = pos.shape
    n = tau.shape[1]
    fsteps = int(math.ceil(band.cutoff / band.dw))
    offsets = torch.arange(-fsteps, fsteps + 1, device=tau.device)
    rows = (torch.arange(nlay, device=tau.device) * n)[:, None, None]
    step = max(1, SAMPLES_PER_STEP // (nlay * offsets.numel()))
    for a in range(0, L, step):
        sl = slice(a, a + step)
        p = pos[:, sl]
        centre = torch.floor(p + 0.5)
        g = centre.long()[..., None] + offsets
        keep = ((centre >= 0) & (centre < n))[..., None] & (g >= 0) & (g < n)
        k = voigt((g.to(tau.dtype) - p[..., None]) * band.dw,
                  lorentz[:, sl, None], doppler[:, sl, None])
        _index_add(tau, rows + g.clamp(0, n - 1),
                   torch.where(keep, strength[:, sl, None] * k,
                               torch.zeros_like(k)))


class Bins:
    """The ~1 cm-1 bins of a band (spectral_bin.c): ``ppb`` fine points
    each, the last one ``last_ppb``; a bin's three interpolation points
    are its first, middle and last fine points."""

    def __init__(self, band):
        n = band.n
        self.w0, self.dw = band.w0, band.dw
        self.ppb = int(np.floor(band.bin_width / band.dw)) + 1
        rem = n % self.ppb
        self.last_ppb = self.ppb if rem == 0 else rem
        self.count = n // self.ppb + (self.ppb != self.last_ppb)
        self.first = np.arange(self.count, dtype=np.int64) * self.ppb
        self.size = np.full(self.count, self.ppb, np.int64)
        self.size[-1] = self.last_ppb
        # Interpolation points in grid units.
        self.points = np.stack([self.first, self.first + (self.size - 1) / 2,
                                self.first + self.size - 1], 1).astype(
                                    np.float64)

    def ranges(self, v: np.ndarray, local: int, remote: int):
        """Per bin, the lines (``v`` sorted centres [cm-1]) it takes on
        its fine points and at its interpolation points: (local first,
        local last, remote-left first, remote-right last), inclusive,
        and the masks of non-empty ones.  The local window runs from the
        first point of bin j - local to the last of bin j + local, the
        remote one over ``remote`` bins each way; each is widened by one
        line on either side (the reference C's bracket), and a bin whose
        window misses every line is empty."""
        w = lambda idx: self.w0 + self.dw * idx     # noqa: E731
        j = np.arange(self.count)
        left = w(self.points[np.maximum(j - local, 0), 0])
        right = w(self.points[np.minimum(j + local, self.count - 1), 2])
        left_r = w(self.points[np.maximum(j - remote, 0), 0])
        right_r = w(self.points[np.minimum(j + remote, self.count - 1), 2])

        def at_or_below(x):      # last line <= x (0 when none)
            i = np.searchsorted(v, x, side="right") - 1
            return np.clip(i, 0, len(v) - 1)

        def at_or_above(x):      # first line >= x (the last when none)
            return np.clip(np.searchsorted(v, x, side="left"), 0, len(v) - 1)

        lo, hi = at_or_below(left), at_or_above(right)
        lo = np.where(left > v[-1], len(v), lo)
        local_ok = (left <= v[-1]) & (right >= v[0])
        left_ok = (left >= v[0]) & (left_r <= v[-1])
        right_ok = (right <= v[-1]) & (right_r >= v[0])
        return (lo, hi, at_or_below(left_r), at_or_above(right_r),
                local_ok, left_ok, right_ok)


def _pairs(first, count):
    """(bin, line) index pairs of per-bin line runs [first, first+count)."""
    count = np.maximum(count, 0)
    b = np.repeat(np.arange(first.size), count)
    start = np.repeat(first - np.concatenate([[0], np.cumsum(count)[:-1]]),
                      count)
    return b, start + np.arange(b.size)


def bin_sweep(tau, coarse, pos, strength, lorentz, doppler, band, bins,
              v):
    """One molecule's bin-method sums: each bin's local lines exactly on
    its fine points into ``tau`` (nlayers, n), its remote lines at its
    three points into ``coarse`` (nlayers, bins, 3)."""
    dev, dt = tau.device, tau.dtype
    nlay, n = tau.shape
    lo, hi, rlo, rhi, ok, lok, rok = bins.ranges(v, band.local_bins,
                                                 band.remote_bins)
    lb, li = _pairs(np.where(ok, lo, 0), np.where(ok, hi - lo + 1, 0))
    right_start = np.where(ok, hi + 1, lo)
    rb = [_pairs(np.where(lok, rlo, 0), np.where(lok, lo - rlo, 0)),
          _pairs(np.where(rok, right_start, 0),
                 np.where(rok, rhi - right_start + 1, 0))]
    rows = torch.arange(nlay, device=dev)[:, None, None]
    fine = torch.arange(bins.ppb, device=dev)
    first = torch.as_tensor(bins.first, device=dev)
    last = first + torch.as_tensor(bins.size, device=dev) - 1
    points = torch.as_tensor(bins.points, device=dev).to(dt)

    def run(b_host, i_host, width, add):
        step = max(1, SAMPLES_PER_STEP // (nlay * width))
        for a in range(0, b_host.size, step):
            b = torch.as_tensor(b_host[a:a + step], device=dev)
            i = torch.as_tensor(i_host[a:a + step], device=dev)
            add(b, i, pos[:, i], strength[:, i], lorentz[:, i], doppler[:, i])

    def local(b, i, p, s, lor, dop):
        g = first[b][:, None] + fine                      # (P, ppb)
        k = voigt((g.to(dt)[None] - p[..., None]) * band.dw, lor[..., None],
                  dop[..., None])
        keep = (g <= last[b][:, None])[None]
        _index_add(tau, rows * n + g.clamp(max=n - 1)[None],
                   torch.where(keep, s[..., None] * k, torch.zeros_like(k)))

    def remote(b, i, p, s, lor, dop):
        k = voigt((points[b][None] - p[..., None]) * band.dw,
                  lor[..., None], dop[..., None])
        idx = rows * (bins.count * NIP) + (b[:, None] * NIP
                                           + torch.arange(NIP, device=dev))
        _index_add(coarse, idx, s[..., None] * k)

    run(lb, li, bins.ppb, local)
    for b_host, i_host in rb:
        run(b_host, i_host, NIP, remote)


def interpolate_bins(tau, coarse, bins):
    """Each bin's far-line sum at its three points, carried onto its fine
    points by the quadratic through them, clamped at zero (or copied to
    the nearest point for bins of three points or fewer), added to tau."""
    dev, dt = tau.device, tau.dtype
    n = tau.shape[1]
    size = torch.as_tensor(bins.size, device=dev).to(dt)[:, None]
    p = torch.arange(bins.ppb, device=dev).to(dt)[None, :]   # from x0
    x1, x2 = (size - 1) / 2, size - 1
    y0, y1, y2 = (coarse[..., i, None] for i in range(NIP))
    quad = torch.clamp((p - x1) * (p - x2) / (x1 * x2) * y0
                       + p * (p - x2) / (x1 * (x1 - x2)) * y1
                       + p * (p - x1) / (x2 * (x2 - x1)) * y2, min=0.0)
    k = p.long().clamp(0, NIP - 1)
    near = torch.where(k == 0, y0, torch.where(k == 1, y1, y2))
    vals = torch.where((size > 3)[None], quad, near)
    tau += vals.reshape(tau.shape[0], -1)[:, :n]


def band_tau(column: Column, band, tips):
    """(nlayers, n) gas optical depth of a band."""
    c = column
    tau = torch.zeros((c.pavg.size, band.n), dtype=c.dtype, device=c.device)
    bins = coarse = None
    if band.method == "wavenumber_sweep":
        bins = Bins(band)
        coarse = torch.zeros((c.pavg.size, bins.count, NIP), dtype=c.dtype,
                             device=c.device)
    elif band.method != "line_sample":
        raise ValueError(f"no reference for method {band.method!r}")
    T, P = (c.tensor(a)[:, None] for a in (c.tavg, c.pavg))
    for mol, lines in band.lines.items():
        pos, s, lor, dop = line_prep(c, mol, lines, band, tips)
        if bins is None:
            line_sample(tau, pos, s, lor, dop, band)
        else:
            bin_sweep(tau, coarse, pos, s, lor, dop, band, bins,
                      np.asarray(lines["vnn"], np.float64))
        del pos, s, lor, dop
        x = np.asarray(c.col["ppmv"][mol], np.float64) * 1e-6
        ps, ns = c.species(x)
        ns_t, ps_t = c.tensor(ns)[:, None], c.tensor(ps)[:, None]
        if mol == H2O:
            h = {k: c.tensor(v)[None, :] for k, v in band.h2o.items()}
            tau += ns_t * (TREF / T) * (
                h["cs"] * ps_t * torch.exp(h["t0s"] * (TREF - T))
                + h["cf"] * (P - ps_t) * torch.exp(h["t0f"] * (TREF - T)))
        elif mol == O3:
            tau += ns_t * c.tensor(band.o3)[None, :]
    for cfc_id, sigma in band.cfcs.items():
        x = np.asarray(c.col["cfc_ppmv"][cfc_id], np.float64) * 1e-6
        tau += c.tensor(np.outer(c.n * c.mean(x), sigma))
    for s1, s2, sigma in band.cias:
        x1, x2 = (np.asarray(c.col["cia_ppmv"][s], np.float64) * 1e-6
                  for s in (s1, s2))
        dp2 = (c.p[..., :-1] ** 2 - c.p[..., 1:] ** 2).reshape(-1)
        # |c (p_i^2 - p_i+1^2) / T 1/4 (x1_i + x1_i+1) (x2_i + x2_i+1)|
        pair = np.abs(CIA_FACTOR * dp2 / c.tavg * c.mean(x1) * c.mean(x2))
        # The column factor (~8e46) and the cross section (~1e-44) lie
        # outside the lower precisions' range; their product does not.
        tau += c.tensor(np.outer(pair, sigma))
    if bins is not None:
        interpolate_bins(tau, coarse, bins)
    return tau


def planck(t, w):
    """Spectral radiance [W cm m-2]."""
    e = torch.clamp(PLANCK_C2 * w / t, max=MAX_EXP_ARG)
    return PLANCK_C1 * w * w * w / (torch.exp(e) - 1.0)


def longwave(tau, t_lay, t_lev, t_surf, emis, w):
    """Four-stream absorption-only fluxes (nlevels, n), up and down."""
    sec, wts = (torch.tensor(v, dtype=torch.float64, device=tau.device)
                .to(tau.dtype) for v in (LW_SECANTS, LW_WEIGHTS))
    ext = torch.exp(torch.clamp(sec[:, None, None] * tau[None],
                                max=MAX_EXP_ARG))            # (4, L, n)
    s = PLANCK_A * tau + PLANCK_B * tau * tau
    src = planck(t_lay[:, None], w)

    def blended(t_edge):
        return (src + s * planck(t_edge[:, None], w)) / (1.0 + s)

    b_down, b_up = blended(t_lev[1:]), blended(t_lev[:-1])
    nlay = tau.shape[0]
    i = torch.zeros_like(ext[:, 0])
    down = [torch.zeros_like(tau[0])]
    for k in range(nlay):
        i = (1.0 - ext[:, k]) * b_down[k] + i * ext[:, k]
        down.append((wts[:, None] * i).sum(0))
    i = emis * planck(t_surf, w) + (1.0 - emis) * i
    up = [(wts[:, None] * i).sum(0)]
    for k in reversed(range(nlay)):
        i = (1.0 - ext[:, k]) * b_up[k] + i * ext[:, k]
        up.append((wts[:, None] * i).sum(0))
    return torch.stack(up[::-1]), torch.stack(down)


def trapezoid(y, dw):
    return (0.5 * (y[..., :-1] + y[..., 1:])).sum(-1) * dw


def surface(grid, values, w: np.ndarray) -> np.ndarray:
    """A surface spectrum (``values`` on the ascending ``grid`` [cm-1]) on
    the wavenumbers ``w``, in float64: linear inside the grid, its first
    value below it and its second-to-last value past its last point (the
    reference C's interpolate2, utilities.c:216-219)."""
    x = np.asarray(grid, np.float64)
    y = np.asarray(values, np.float64)
    out = np.interp(w, x, y)
    out[w > x[-1]] = y[-2]
    return out


def sw_solver(cfg: dict):
    """The ``fluxes`` of the configuration's shortwave solver
    (``sw_solver``, "two_stream" where it names none): the module
    ``sw_<sw_solver>.py`` beside this file."""
    name = cfg.get("sw_solver", "two_stream")
    module = f"{__package__}.sw_{name}"
    try:
        return importlib.import_module(module).fluxes
    except ModuleNotFoundError as err:
        if err.name != module:
            raise
        raise ValueError(f"{cfg['name']}: the reference has no shortwave "
                         f"solver {name!r}: no file rtbench/reference/"
                         f"sw_{name}.py") from err


def column_fluxes(dep, col: dict, *, dtype=torch.float64, device="cpu",
                  tips: PartitionSums | None = None) -> dict:
    """{"rlu", "rld", "rsu", "rsd"}: (nlevels,) float64 numpy band
    integrals [W m-2] of one column (``col`` holds one column of
    ``Deployment.columns``' arrays); "rlu" and "rld" alone where the
    deployment has no shortwave band."""
    tips = tips or PartitionSums()
    c = Column(col, dtype, torch.device(device))
    lw, sw = dep.bands["lw"], dep.bands.get("sw")
    w = c.tensor(lw.wavenumbers)
    tau = band_tau(c, lw, tips)
    emis = surface(col["emissivity_grid"], col["emissivity"],
                   lw.wavenumbers)
    up, down = longwave(tau, c.tensor(c.tavg), c.tensor(c.t_lev),
                        c.tensor(col["t_surf"]), c.tensor(emis), w)
    del tau
    out = {"rlu": trapezoid(up, lw.dw), "rld": trapezoid(down, lw.dw)}
    del up, down
    mu = float(col["mu"])
    if sw is not None and mu > 0.0:
        w = c.tensor(sw.wavenumbers)
        gas = band_tau(c, sw, tips)
        ww = w * 1e-4
        ray = c.tensor(c.n)[:, None] * (1e-20 * ww ** 4) / (
            0.268675e5 * (9.38076e2 - 10.8426 * ww * ww))
        tau = gas + ray
        albedo = surface(col["albedo_grid"], col["albedo"], sw.wavenumbers)
        up, down = sw_solver(dep.config)(
            tau, ray / tau, torch.zeros_like(tau), max(mu, MU_FLOOR),
            c.tensor(albedo), c.tensor(col["tsi"]), c.tensor(dep.solar),
            config=dep.config)
        out["rsu"], out["rsd"] = trapezoid(up, sw.dw), trapezoid(down, sw.dw)
    elif sw is not None:
        out["rsu"] = out["rsd"] = torch.zeros_like(out["rlu"])
    return {k: v.double().cpu().numpy() for k, v in out.items()}
