"""Pade-approximant cloud optics, RRTMGP-style coefficient tables (port of
grtcode_tpu/clouds/pade.py).

One vectorised evaluation over (..., band): the first size regime that
holds the radius, Horner polynomials in the offset from the regime's
reference radius, coefficients in dense (nbnd, nsizereg, ncoef) tensors.
Tables come from RRTMGP-style netCDF files (:meth:`PadeCloudOptics.
from_netcdf`, through the port's ``utils.ncio``) or from arrays
(:meth:`PadeCloudOptics.from_arrays`, :func:`synthetic_pade_table`), on
the device the caller names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PadeCloudOptics:
    """One condensed-phase Pade table as float32 tensors on one device."""

    band_lims: torch.Tensor       # (2, nbnd) [cm-1] lower/upper
    sizereg_bounds: torch.Tensor  # (2, nsizereg) effective-radius bounds
    sizereg_ref: torch.Tensor     # (nsizereg,) reference radius per regime
    ext_p: torch.Tensor           # (nbnd, nsizereg, n)
    ext_q: torch.Tensor           # (nbnd, nsizereg, m)
    ssa_p: torch.Tensor
    ssa_q: torch.Tensor
    asy_p: torch.Tensor
    asy_q: torch.Tensor

    @property
    def nbnd(self) -> int:
        return int(self.band_lims.shape[1])

    @classmethod
    def from_arrays(cls, band_lims, sizereg_bounds, sizereg_ref, ext_p,
                    ext_q, ssa_p, ssa_q, asy_p, asy_q, *, device):
        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        return cls(f(band_lims), f(sizereg_bounds), f(sizereg_ref),
                   f(ext_p), f(ext_q), f(ssa_p), f(ssa_q), f(asy_p),
                   f(asy_q))

    @classmethod
    def from_netcdf(cls, path: str, device):
        """Read an RRTMGP-style Pade file (netCDF4 through ``ncio``; the
        variable names of cloud_pade_optics.c:38-126)."""
        from ..utils.ncio import Dataset

        with Dataset(path) as f:
            def v(name):
                return f.var(name)

            def coeffs(name):
                # File layout (coef, sizereg, band) -> (band, sizereg, coef).
                return np.transpose(v(name), (2, 1, 0))

            return cls.from_arrays(
                np.stack([v("Band_limits_lwr"), v("Band_limits_upr")]),
                np.stack([v("Effective_Radius_limits_lwr"),
                          v("Effective_Radius_limits_upr")]),
                v("Effective_Radius_Ref"),
                coeffs("Pade_ext_p"), coeffs("Pade_ext_q"),
                coeffs("Pade_ssa_p"), coeffs("Pade_ssa_q"),
                coeffs("Pade_asy_p"), coeffs("Pade_asy_q"), device=device)

    def to_netcdf(self, path: str):
        """Write the table as an RRTMGP-style Pade file, the layout
        :meth:`from_netcdf` reads (float64, coefficients (coef, sizereg,
        band)), through the port's own HDF5 writer."""
        from ..utils.hdf5 import FileWriter

        def host(t):
            return t.cpu().numpy().astype(np.float64)

        with FileWriter(path) as f:
            for name, data in (
                    ("Band_limits_lwr", host(self.band_lims)[0]),
                    ("Band_limits_upr", host(self.band_lims)[1]),
                    ("Effective_Radius_limits_lwr",
                     host(self.sizereg_bounds)[0]),
                    ("Effective_Radius_limits_upr",
                     host(self.sizereg_bounds)[1]),
                    ("Effective_Radius_Ref", host(self.sizereg_ref))):
                f.create_dataset(name, data)
            for name in ("ext_p", "ext_q", "ssa_p", "ssa_q", "asy_p",
                         "asy_q"):
                f.create_dataset(f"Pade_{name}",
                                 host(getattr(self, name)).transpose(2, 1, 0))

    def evaluate(self, content, radius):
        """(extinction, ssa, g), each (..., nbnd), of condensate amounts
        ``content`` (...,) at effective radii ``radius`` (...,) [microns].
        Extinction is per content unit times content; zero content or a
        radius in no size regime gives zeros."""
        c = torch.as_tensor(content, dtype=torch.float32)[..., None]
        r = torch.as_tensor(radius, dtype=torch.float32)[..., None]
        lo, hi = self.sizereg_bounds[0], self.sizereg_bounds[1]
        in_reg = (lo <= r) & (r <= hi)                       # (..., nreg)
        irad = torch.argmax(in_reg.to(torch.int8), dim=-1)  # first match
        valid = in_reg.any(dim=-1) & (c[..., 0] > 0.0)
        x = (r[..., 0] - self.sizereg_ref[irad])[..., None]  # (..., 1)

        def pade(pc, qc):
            pcoef = torch.movedim(pc[:, irad, :], 0, -2)    # (..., nbnd, n)
            qcoef = torch.movedim(qc[:, irad, :], 0, -2)

            def horner(co):
                acc = co[..., 0]
                for i in range(1, co.shape[-1]):
                    acc = co[..., i] + x * acc
                return acc

            return horner(pcoef) / horner(qcoef)            # (..., nbnd)

        ext = pade(self.ext_p, self.ext_q) * c
        ssa = pade(self.ssa_p, self.ssa_q)
        asy = pade(self.asy_p, self.asy_q)
        mask = valid[..., None]
        return (torch.where(mask, ext, 0.0), torch.where(mask, ssa, 0.0),
                torch.where(mask, asy, 0.0))


def synthetic_pade_table(nbnd: int = 16, w0: float = 1.0,
                         wn: float = 3250.0, seed: int = 0, *,
                         device) -> PadeCloudOptics:
    """A physically plausible synthetic table for tests and data-free runs
    (the JAX package's, draw for draw): smooth positive extinction (~0.05-
    0.3 m2 g-1), ssa in (0, 1), g in (0, 0.95), two size regimes."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(w0, wn, nbnd + 1)
    band_lims = np.stack([edges[:-1], edges[1:]])
    sizereg = np.array([[2.0, 20.0], [20.0, 90.0]])
    ref = np.array([10.0, 40.0])
    n, m = 3, 3

    def coeffs(scale, base, jitter):
        p = rng.uniform(0.5, 1.5, (nbnd, 2, n)) * scale
        p[..., -1] = base * rng.uniform(1.0 - jitter, 1.0 + jitter, (nbnd, 2))
        q = np.concatenate(
            [rng.uniform(-0.002, 0.002, (nbnd, 2, m - 1)),
             np.ones((nbnd, 2, 1))], axis=-1)
        return p, q

    # Water-cloud-like magnitudes: strong scattering (ssa ~0.98) with a
    # forward-peaked phase (g ~0.85); extinction ~0.15 m2 g-1.
    ep, eq = coeffs(1e-4, 0.15, 0.2)
    sp, sq = coeffs(1e-6, 0.98, 0.01)
    ap, aq = coeffs(1e-6, 0.85, 0.05)
    return PadeCloudOptics.from_arrays(band_lims, sizereg, ref, ep, eq,
                                       sp, sq, ap, aq, device=device)
