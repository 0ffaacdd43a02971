"""Branch-free Voigt line shape, Humlicek / RFM formulation (port of
grtcode_tpu/gas_optics/voigt.py).

The scalar per-point region branches of the reference are elementwise
``torch.where`` selects over the whole (row, line, point) plane.  This is
the plain-PyTorch truth that the CUDA kernel in
:mod:`grtcode_tpu_torch.gas_optics.voigt_kernel` is held against.

Normalization: returns K such that the cross-section contribution is
``S * K`` with K = sqrt(ln2/pi)/alpha_d * K_humlicek(x, y),
x = sqrt(ln2) (v - v0)/alpha_d,  y = sqrt(ln2) alpha_l/alpha_d.
"""
from __future__ import annotations

import torch

from .. import constants
from ..utils.graphs import device_constant

_PI = 3.14159265358979323846

# 6-term CPF expansion coefficients.
_C = (1.0117281, -0.75197147, 0.012557727, 0.010022008, -0.00024206814,
      0.00000050084806)
_S = (1.393237, 0.23115241, -0.15535147, 0.0062183662, 0.000091908299,
      -0.00000062752596)
_T = (0.31424038, 0.94778839, 1.5976826, 2.2795071, 3.0206370, 3.8897249)


def _div(num: float, t):
    """``num / t`` as one IEEE division, as XLA and the CUDA kernel compute
    it (PyTorch evaluates a Python number over a tensor as
    ``t.reciprocal() * num``, one rounding more)."""
    return device_constant(num, t.device, t.dtype) / t


def humlicek_region(abx, y):
    """The RFM region (0-4) of each ``|x|``, ``y`` sample: 0 is the
    Lorentz wing, 1 and 2 the rational expansions, 3 the core rational and
    4 the 6-term CPF.  The one statement of the region limits, which the
    CUDA kernel rounds the same way."""
    xlim0 = torch.sqrt(15100.0 + y * (40.0 - y * 3.6))
    xlim1 = torch.where(y >= 8.425, 0.0,
                        torch.sqrt(torch.clamp(164.0 - y * (4.3 + y * 1.8),
                                               min=0.0)))
    xlim2 = 6.8 - y
    tiny_y = y <= 0.000001
    xlim1 = torch.where(tiny_y, xlim0, xlim1)
    xlim2 = torch.where(tiny_y, xlim0, xlim2)
    return torch.where(
        abx >= xlim0, 0,
        torch.where(abx >= xlim1, 1,
                    torch.where(abx >= xlim2, 2,
                                torch.where(abx < 2.4 * y, 3, 4))))


def humlicek_k(xi, y):
    """Humlicek K(x, y) over the five RFM regions; ``xi`` and ``y``
    broadcast elementwise and ``y`` must be < 70.55 (the caller handles
    the pure-Lorentz limit)."""
    xi, y = torch.broadcast_tensors(xi, y)
    yq = y * y
    abx = xi.abs()
    xq = abx * abx
    region = humlicek_region(abx, y)

    yrrtpi = y * constants.RSQRPI

    # Region 0: |x| >= xlim0 — Lorentz wing.
    k0 = yrrtpi / (xq + yq)

    # Region 1: xlim1 <= |x| < xlim0.
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    k1 = _div(constants.RSQRPI, d0 + xq * (d2 + xq)) * y * (a0 + xq)

    # Region 2: xlim2 <= |x| < xlim1.
    h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)))
    h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0))
    h4 = 10.5 - yq * (6.0 - yq * 6.0)
    h6 = -6.0 + yq * 4.0
    e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq))
    e2 = 5.25 + yq * (1.0 + yq * 3.0)
    e4 = 0.75 * h6
    k2 = _div(constants.RSQRPI,
              h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq)))) * \
        y * (e0 + xq * (e2 + xq * (e4 + xq)))

    # Region 3: |x| < xlim3.
    z0 = 272.1014 + y * (1280.829 + y * (2802.870 + y * (3764.966
         + y * (3447.629 + y * (2256.981 + y * (1074.409 + y * (369.1989
         + y * (88.26741 + y * (13.39880 + y)))))))))
    z2 = 211.678 + y * (902.3066 + y * (1758.336 + y * (2037.310
         + y * (1549.675 + y * (793.4273 + y * (266.2987
         + y * (53.59518 + y * 5.0)))))))
    z4 = 78.86585 + y * (308.1852 + y * (497.3014 + y * (479.2576
         + y * (269.2916 + y * (80.39278 + y * 10.0)))))
    z6 = 22.03523 + y * (55.02933 + y * (92.75679 + y * (53.59518
         + y * 10.0)))
    z8 = 1.496460 + y * (13.39880 + y * 5.0)
    p0 = 153.5168 + y * (549.3954 + y * (919.4955 + y * (946.8970
         + y * (662.8097 + y * (328.2151 + y * (115.3772 + y * (27.93941
         + y * (4.264678 + y * 0.3183291))))))))
    p2 = -34.16955 + y * (-1.322256 + y * (124.5975 + y * (189.7730
         + y * (139.4665 + y * (56.81652 + y * (12.79458
         + y * 1.2733163))))))
    p4 = 2.584042 + y * (10.46332 + y * (24.01655 + y * (29.81482
         + y * (12.79568 + y * 1.9099744))))
    p6 = -0.07272979 + y * (0.9377051 + y * (4.266322 + y * 1.273316))
    p8 = 0.0005480304 + y * 0.3183291
    k3 = _div(1.7724538,
              z0 + xq * (z2 + xq * (z4 + xq * (z6 + xq * (z8 + xq))))) * \
        (p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8))))

    # Region 4: xlim3 <= |x| < xlim2 — 6-term CPF.
    y0 = 1.5
    y0q = 2.25
    ypy0 = y + y0
    ypy0q = ypy0 * ypy0
    k4a = torch.zeros_like(xi)
    k4b = torch.zeros_like(xi)
    yf = y + 3.0  # Y + Y0PY0
    for j in range(6):
        d = xi - _T[j]
        mq = d * d
        mf = 1.0 / (mq + ypy0q)
        xm = mf * d
        ym = mf * ypy0
        dp = xi + _T[j]
        pq = dp * dp
        pf = 1.0 / (pq + ypy0q)
        xp = pf * dp
        yp = pf * ypy0
        k4a = k4a + _C[j] * (ym + yp) - _S[j] * (xm - xp)
        k4b = k4b + (
            (_C[j] * (mq * mf - y0 * ym) + _S[j] * yf * xm) / (mq + y0q)
            + (_C[j] * (pq * pf - y0 * yp) - _S[j] * yf * xp) / (pq + y0q)
        )
    k4b = y * k4b + torch.exp(-xq)
    k4 = torch.where(abx <= 18.1 * y + 1.65, k4a, k4b)

    return torch.where(
        region == 0, k0,
        torch.where(region == 1, k1,
                    torch.where(region == 2, k2,
                                torch.where(region == 3, k3, k4))))


def voigt_far_wing(dv, lorentz_hwhm, doppler_hwhm):
    """Far-wing Voigt: Humlicek regions 0/1 only (plus the pure-Lorentz
    limit), exact wherever |x| >= sqrt(164) ~ 12.81, where the full region
    select can only pick region 0 or 1.  All three rationals share one
    division: numerator and denominator are selected first."""
    repwid = _div(constants.SQRT_LN2, doppler_hwhm)
    y_true = repwid * lorentz_hwhm
    y = torch.clamp(y_true, max=70.0)
    yq = y * y
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    xlim0sq = 15100.0 + y * (40.0 - y * 3.6)
    c_scale = constants.RSQRPI * constants.RSQRPI * repwid  # 1/pi
    num0 = c_scale * y                         # region 0: y / (pi (xq+yq))
    lor_num = repwid * y_true / _PI            # Lorentz limit numerator
    ytq = y_true * y_true

    xi = dv * repwid
    xq = xi * xi
    num1 = num0 * (a0 + xq)                    # region 1 numerator
    den1 = d0 + xq * (d2 + xq)
    reg0 = xq >= xlim0sq
    lor = y_true >= 70.55
    num = torch.where(lor, lor_num, torch.where(reg0, num0, num1))
    den = torch.where(lor, xq + ytq, torch.where(reg0, xq + yq, den1))
    return num / den


def voigt_line_shape(dv, lorentz_hwhm, doppler_hwhm):
    """Voigt profile K(v - v0) [cm] matching rfm_voigt_line_shape.

    Args:
      dv: offsets from the (pressure-shifted) line center [cm-1].
      lorentz_hwhm: Lorentz HWHM [cm-1].
      doppler_hwhm: Doppler HWHM including sqrt(ln2) [cm-1].

    Every sample takes the region-0 (Lorentz-wing) value or the
    pure-Lorentz limit; the samples inside the region-0 limit take the
    full five-region ``humlicek_k`` (on the CPU it runs on those samples
    alone, on the card on every sample and is selected), with the same
    operations, so the result is that of ``humlicek_k`` everywhere.
    """
    repwid = _div(constants.SQRT_LN2, doppler_hwhm)
    y = repwid * lorentz_hwhm
    xi = dv * repwid
    xi, y, repwid = torch.broadcast_tensors(xi, y, repwid)
    # Pure-Lorentz limit for y >= 70.55.
    lor = y >= 70.55
    lorentz = repwid * y / (_PI * (xi * xi + y * y))
    # Clamp y in the Humlicek path to avoid spurious NaNs in unused lanes.
    y_safe = torch.clamp(y, max=70.0)
    abx = xi.abs()
    scale = constants.RSQRPI * repwid
    k = scale * ((y_safe * constants.RSQRPI) / (abx * abx + y_safe * y_safe))
    k = torch.where(lor, lorentz, k)
    core = (humlicek_region(abx, y_safe) != 0) & ~lor
    if k.is_cuda:
        # On the card the step is captured, and a graph cannot size the
        # core samples on the host: every sample takes the five-region
        # value, the same on the selected ones (as the JAX function
        # computes it).  The CPU evaluates the core samples alone.
        return torch.where(core, scale * humlicek_k(xi, y_safe), k)
    if bool(core.any()):
        k[core] = scale[core] * humlicek_k(xi[core], y_safe[core])
    return k
