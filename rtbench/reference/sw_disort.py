"""The reference's multi-stream shortwave: azimuthally averaged
discrete ordinates (Stamnes and Swanson 1981; Stamnes et al. 1988,
DISORT), solved layer by layer from the eigen-solution of each
homogeneous layer, and the layers joined by adding.

The configuration's ``disort_streams`` (N) sets the streams: h = N / 2
cosines a hemisphere, weights summing to 1.  ``quadrature="gauss"``, the
default and the rule that decides ``correct``, takes the positive half
of the N-point Gauss-Legendre rule on (-1, 1), the quadrature the
program states; ``"double_gauss"`` takes the h-point rule on (0, 1),
cdisort's default, for comparing the two rules.  The phase function is Henyey-Greenstein's, its Legendre moments
g^l for l < N, delta-M scaled at N (f = g^N), as cdisort runs by
default.  A conservative layer (omega = 1 after scaling) takes omega =
1 - ``DITHER`` (1 - the precision's epsilon, where that is larger), as
DISORT does, so that no eigenvalue is zero.  The
surface is Lambertian: it reflects ``albedo`` times the flux that
reaches it, the same in every stream.

Each layer:

1. The homogeneous problem, +-M dI+-/dtau = (1 - omega/2 P++ W) I+-
   - omega/2 P+- W I-+, reduces to the eigenproblem of the h x h
   product (alpha + beta)(alpha - beta).  Scaled by W^1/2 M^1/2 it is
   the product of two symmetric matrices, B- B+, with B- positive
   definite; with B- = L L^T the eigenvalues k^2 and the eigenvectors
   come from the symmetric L^T B+ L (``torch.linalg.eigh``).
2. The layer's diffuse reflection R and transmission T, from the
   solutions that decay from the top (e^-k tau) and from the bottom
   (e^-k (tau_L - tau)): with G+- the eigenvectors' two hemispheres and
   E = e^-k tau_L, R + T = (G+ + G- E)(G- + G+ E)^-1 and R - T =
   (G+ - G- E)(G- - G+ E)^-1.  Only decaying exponentials appear, so a
   thick layer is as stable as a thin one.
3. The beam's particular solution Z+- e^-tau/mu0 (a 2h x 2h solve), and
   the layer's beam sources, the upward intensity at its top and the
   downward one at its bottom for a unit beam at its top and nothing
   else entering: s_r = Z+ - R Z- - T Z+ d and s_t = Z- d - T Z- -
   R Z+ d, with d = e^-tau_L/mu0.

The adding method then gives the reflection and source of the stack
below each level, from the surface up, and the downward intensities at
each level, from the top down.  Fluxes are sum_i w_i mu_i I_i, plus the
direct beam's mu0 e^-tau/mu0 downward; the incident beam carries
``tsi * solar`` on a surface normal to it.

The wavenumbers are solved ``BLOCK`` at a time.  The arithmetic is in
the inputs' precision, float64 for the reference.  bfloat16 has no
Cholesky factorisation, eigensolver, inverse or linear solve: there the
inputs of those operations are rounded to float32, the operation runs
in float32 and its result is rounded back to bfloat16 (``_lapack``);
every other operation runs in bfloat16.  Matmuls never use TF32.  Like the
rest of the reference it imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 4096            # wavenumbers solved at once
DITHER = 1e-9           # 1 - omega of a conservative layer
# Matrices a batched eigh takes at once: cuSOLVER's batched symmetric
# eigensolver refuses 32,768 8 x 8 matrices (CUSOLVER_STATUS_INVALID_VALUE
# on an H100 with CUDA 12.8) and takes 16,384.
EIGH_BATCH = 16384


def streams(n: int, quadrature: str = "gauss"):
    """(mu, w): the h = n / 2 cosines of a hemisphere, ascending, and
    their weights (sum 1), float64 numpy: the positive half of the
    n-point Gauss-Legendre rule on (-1, 1) (``"gauss"``) or the h-point
    rule on (0, 1) (``"double_gauss"``)."""
    if n < 4 or n % 2:
        raise ValueError(f"disort_streams {n}: an even number >= 4")
    if quadrature == "double_gauss":
        x, w = np.polynomial.legendre.leggauss(n // 2)
        return 0.5 * (x + 1.0), 0.5 * w
    if quadrature != "gauss":
        raise ValueError(f"quadrature {quadrature!r}: \"gauss\" or "
                         f"\"double_gauss\"")
    x, w = np.polynomial.legendre.leggauss(n)
    keep = x > 0.0
    order = np.argsort(x[keep])
    return x[keep][order], w[keep][order]


def legendre(x: np.ndarray, lmax: int) -> np.ndarray:
    """P_l(x) for l = 0..lmax, (lmax + 1, x.size), float64."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    p = np.empty((lmax + 1, x.size))
    p[0] = 1.0
    if lmax > 0:
        p[1] = x
    for l in range(2, lmax + 1):
        p[l] = ((2 * l - 1) * x * p[l - 1] - (l - 1) * p[l - 2]) / l
    return p


def _lapack(fn, *args):
    """``fn(*args)`` in the arguments' precision, or, for bfloat16 (no
    such kernels), in float32 on inputs and outputs rounded to it."""
    dtype = args[0].dtype
    if dtype in (torch.float32, torch.float64):
        return fn(*args)
    out = fn(*(a.float() for a in args))
    if isinstance(out, tuple):
        return tuple(o.to(dtype) for o in out)
    return out.to(dtype)


def _eigh(a):
    """``torch.linalg.eigh`` of a batch, ``EIGH_BATCH`` matrices at a
    time."""
    flat = a.reshape((-1,) + a.shape[-2:])
    parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
             for i in range(0, flat.shape[0], EIGH_BATCH)]
    return (torch.cat([p[0] for p in parts]).reshape(a.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(a.shape))


def _mv(a, v):
    return (a @ v[..., None])[..., 0]


def _layers(tau, omega, g, mu0, n, quadrature):
    """R, T (L, W, h, h), s_r, s_t (L, W, h) and the beam's layer
    transmittance d (L, W) of each layer."""
    dt, dev = tau.dtype, tau.device
    mu_np, w_np = streams(n, quadrature)
    h = n // 2

    def c(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).to(dt)

    mu, w = c(mu_np), c(w_np)
    ls = np.arange(n)
    pl = legendre(mu_np, n - 1)                          # (n, h)
    p0 = legendre([mu0], n - 1)[:, 0]                    # (n,)
    coef = 2 * ls + 1
    # Per moment l: (2l+1) P_l(mu_i) P_l(mu_j), P_l(mu_i) P_l(+-mu0).
    pp = c(coef[:, None, None] * pl[:, :, None] * pl[:, None, :])
    sign = c((-1.0) ** ls)
    beam = c(coef[:, None] * pl * p0[:, None])           # (n, h)

    # Henyey-Greenstein moments, delta-M scaled.
    f = g ** n
    chi = (g[..., None] ** c(ls) - f[..., None]) / (1.0 - f[..., None])
    tau = (1.0 - omega * f) * tau
    eps = torch.finfo(dt).eps
    omega = torch.clamp((1.0 - f) * omega / (1.0 - omega * f),
                        max=1.0 - max(DITHER, eps))
    del f
    half = 0.5 * omega[..., None, None]
    p_same = torch.einsum("...l,lij->...ij", chi, pp)    # p(mu_i, mu_j)
    p_opp = torch.einsum("...l,lij->...ij", chi * sign, pp)  # (mu_i, -mu_j)
    q_up = 0.5 * omega[..., None] * torch.einsum("...l,li->...i",
                                                 chi * sign, beam)
    q_dn = 0.5 * omega[..., None] * torch.einsum("...l,li->...i", chi,
                                                 beam)
    del chi
    eye = torch.eye(h, dtype=dt, device=dev)
    a0 = eye - half * p_same * w                          # 1 - w/2 P++ W
    b0 = half * p_opp * w                                 # w/2 P+- W

    # 1. Eigen-solution.  s = W^1/2, B+- = M^-1/2 (1 - w/2 s S+- s) M^-1/2.
    s = torch.sqrt(w)
    r = 1.0 / torch.sqrt(mu)
    rr = r[:, None] * r[None, :]
    sym = s[:, None] * s[None, :]
    a_plus = eye - half * (p_same + p_opp) * sym          # W^1/2 S+ W^1/2
    b_plus = a_plus * rr
    b_minus = (eye - half * (p_same - p_opp) * sym) * rr
    del p_same, p_opp, sym, rr
    # (alpha + beta)(alpha - beta) is W^-1/2 M^-1/2 B- B+ M^1/2 W^1/2, and
    # B- B+ = L (L^T B+ L) L^-1.
    low = _lapack(torch.linalg.cholesky, b_minus)
    k2, y = _lapack(_eigh, low.transpose(-1, -2) @ b_plus @ low)
    x = (low @ y) * (r / s)[:, None]  # eigenvectors X = G+ + G-
    del low, y, b_plus, b_minus
    # G+ - G- = -(alpha - beta) X / k, (alpha - beta) X =
    # M^-1 W^-1/2 (W^1/2 S+ W^1/2) W^1/2 X.
    amb = (a_plus @ (x * s[:, None])) / (s * mu)[:, None]
    k = torch.sqrt(torch.clamp(k2, min=eps))             # (L, W, h)
    g_up = 0.5 * (x - amb / k[..., None, :])
    g_dn = 0.5 * (x + amb / k[..., None, :])
    del x, amb, a_plus

    # 2. Layer reflection and transmission.
    e = torch.exp(-k * tau[..., None])[..., None, :]
    solve_right = (lambda a, b: torch.linalg.solve(b, a, left=False))
    r_plus_t = _lapack(solve_right, g_up + g_dn * e, g_dn + g_up * e)
    r_minus_t = _lapack(solve_right, g_up - g_dn * e, g_dn - g_up * e)
    R = 0.5 * (r_plus_t + r_minus_t)
    T = 0.5 * (r_plus_t - r_minus_t)
    del e, g_up, g_dn, r_plus_t, r_minus_t

    # 3. The beam's particular solution and the layer's sources.
    m0 = torch.diag_embed(mu / mu0).expand_as(a0)
    system = torch.cat([torch.cat([a0 + m0, -b0], -1),
                        torch.cat([-b0, a0 - m0], -1)], -2)
    z = _lapack(torch.linalg.solve, system,
                torch.cat([q_up, q_dn], -1)[..., None])[..., 0]
    z_up, z_dn = z[..., :h], z[..., h:]
    d = torch.exp(-tau / mu0)
    dd = d[..., None]
    s_r = z_up - _mv(R, z_dn) - _mv(T, z_up) * dd
    s_t = z_dn * dd - _mv(T, z_dn) - _mv(R, z_up) * dd
    return R, T, s_r, s_t, d


def _block(tau, omega, g, mu0, albedo, n, quadrature):
    """(F_up, F_dn), (L + 1, W), for a unit beam (flux 1 normal to it)."""
    R, T, s_r, s_t, d = _layers(tau, omega, g, mu0, n, quadrature)
    nlay, W, h = s_r.shape
    mu_np, w_np = streams(n, quadrature)
    mu, w = (torch.as_tensor(a, dtype=torch.float64, device=tau.device)
             .to(tau.dtype) for a in (mu_np, w_np))
    wmu = w * mu
    eye = torch.eye(h, dtype=tau.dtype, device=tau.device)
    # The surface: I_up = albedo F_dn / sum(w mu) in every stream.
    lam = (albedo / wmu.sum())[:, None]
    below_r = [None] * (nlay + 1)
    below_s = [None] * (nlay + 1)
    below_r[nlay] = (lam[..., None] * wmu).expand(W, h, h)
    below_s[nlay] = (lam * mu0).expand(W, h)
    # Each layer over the stack below it: (1 - R Rb)^-1, and the beam's
    # downward source at its bottom, s_t + R sb d, for a unit beam on top.
    back, source = [None] * nlay, [None] * nlay
    for i in reversed(range(nlay)):
        rb, sb = below_r[i + 1], below_s[i + 1]
        back[i] = inv = _lapack(torch.linalg.inv, eye - R[i] @ rb)
        source[i] = s_t[i] + _mv(R[i], sb * d[i][:, None])
        below_r[i] = R[i] + T[i] @ rb @ inv @ T[i]
        below_s[i] = s_r[i] + _mv(T[i], _mv(rb @ inv, source[i])
                                  + sb * d[i][:, None])
    direct = torch.ones(W, dtype=tau.dtype, device=tau.device)
    down = torch.zeros((W, h), dtype=tau.dtype, device=tau.device)
    f_up, f_dn = [], []
    for i in range(nlay + 1):
        up = _mv(below_r[i], down) + below_s[i] * direct[:, None]
        f_up.append((up * wmu).sum(-1))
        f_dn.append((down * wmu).sum(-1) + mu0 * direct)
        if i == nlay:
            break
        down = _mv(back[i], _mv(T[i], down) + direct[:, None] * source[i])
        direct = direct * d[i]
    return torch.stack(f_up), torch.stack(f_dn)


def fluxes(tau, omega, g, mu, albedo, tsi, solar, *, config,
           quadrature="gauss"):
    """Discrete-ordinates fluxes (nlevels, n), up and down: ``tau``,
    ``omega``, ``g`` (nlayers, n), the direct beam's cosine ``mu`` (> 0),
    the surface ``albedo`` (n,), ``tsi`` and the incident spectrum
    ``solar`` (n,), at ``config["disort_streams"]`` streams on the
    ``quadrature`` rule (``streams``)."""
    n = int(config["disort_streams"])
    mu0 = float(mu)
    ups, downs = [], []
    for a in range(0, tau.shape[-1], BLOCK):
        sl = slice(a, a + BLOCK)
        up, down = _block(tau[:, sl], omega[:, sl], g[:, sl], mu0,
                          albedo[sl], n, quadrature)
        ups.append(up)
        downs.append(down)
    scale = tsi * solar
    return torch.cat(ups, -1) * scale, torch.cat(downs, -1) * scale
