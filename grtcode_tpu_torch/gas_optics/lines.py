"""Per-layer spectral line preparation (port of
grtcode_tpu/gas_optics/lines.py).

The host half (grid binding, padding, half-width sizing) is a numpy copy
of the JAX package's, so the tables it builds are byte-identical.  The
device half, :func:`prepare`, is batched tensor math over a (rows, lines)
plane.

Absolute line positions are never held in float32: at bind time each
line's center is split on the host in float64 into an integer grid index
``c0`` and a fractional offset ``frac0`` (grid units); the device tracks
only the small pressure-shift correction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants
from . import molecules as mol_registry
from . import tips as tips_mod
from .hitran import LineCatalog
from ..spectral import SpectralGrid
from ..utils.graphs import device_constant

_DEVICE_FIELDS = ("c0", "frac0", "vnn", "snn", "yair", "yself", "en", "n",
                  "d", "iso0")


@dataclasses.dataclass
class GridLines:
    """A line catalog bound to a spectral grid (host-side, numpy).

    ``c0``/``frac0`` encode the unshifted line center as
    ``(vnn - w0)/dw = c0 + frac0`` with ``|frac0| <= 0.5``.
    """

    mol_id: int
    mass_g: float
    num_iso: int
    c0: np.ndarray       # (L,) int32
    frac0: np.ndarray    # (L,) float32
    vnn: np.ndarray      # (L,) float32 (only used in strength/doppler factors)
    snn: np.ndarray      # (L,) float32 renormalized strength * 1e20
    yair: np.ndarray
    yself: np.ndarray
    en: np.ndarray
    n: np.ndarray
    d: np.ndarray        # pressure shift [cm-1 atm-1]
    iso0: np.ndarray     # (L,) int32 0-based isotopologue index (clipped)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def num_lines(self) -> int:
        return int(self.c0.shape[0])

    def tensors(self, device) -> dict:
        """The per-line arrays as tensors on ``device`` (copied once)."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = {
                f: torch.as_tensor(getattr(self, f), device=device)
                for f in _DEVICE_FIELDS}
        return self._on_device[key]

    def pad_to(self, L: int) -> "GridLines":
        """Pad with zero-strength sentinel lines to a static size."""
        pad = L - self.num_lines
        if pad < 0:
            raise ValueError("pad_to smaller than catalog")
        if pad == 0:
            return self

        def pz(a, val=0):
            return np.concatenate([a, np.full(pad, val, dtype=a.dtype)])

        # Sentinel center +1e9 is out of every grid (so the validity test
        # rejects it) and keeps ``c0`` sorted for tile bucketing.
        return GridLines(
            self.mol_id, self.mass_g, self.num_iso,
            pz(self.c0, 10 ** 9), pz(self.frac0), pz(self.vnn, 1.0),
            pz(self.snn), pz(self.yair, 1e-3), pz(self.yself, 1e-3),
            pz(self.en), pz(self.n), pz(self.d), pz(self.iso0),
        )


def bind_to_grid(catalog: LineCatalog, grid: SpectralGrid) -> GridLines:
    """Split float64 line centers into (int index, float32 fraction), with
    the lines sorted by center."""
    mol = mol_registry.get(catalog.mol_id)
    order = np.argsort(catalog.vnn, kind="stable")
    vnn = catalog.vnn[order]
    pos = (vnn - grid.w0) / grid.dw  # float64
    c0 = np.floor(pos + 0.5).astype(np.int64)
    frac0 = (pos - c0).astype(np.float32)
    num_iso = max(mol.num_isotopologues, 1)
    iso0 = np.clip(catalog.iso[order].astype(np.int32) - 1, 0, num_iso - 1)
    return GridLines(
        mol_id=int(catalog.mol_id), mass_g=mol.mass_g, num_iso=num_iso,
        c0=c0.astype(np.int32), frac0=frac0,
        vnn=vnn.astype(np.float32),
        snn=catalog.snn[order].astype(np.float32),
        yair=catalog.yair[order], yself=catalog.yself[order],
        en=catalog.en[order], n=catalog.n[order], d=catalog.d[order],
        iso0=iso0,
    )


_X_FAR_SAFE = 13.0  # > sqrt(164): beyond every region-1 lower bound

# The warmest layer and the highest layer pressure the grid tables are
# sized for (near-core and region-0 half-widths, shift margins):
# GasOptics.optical_depth refuses rows beyond them on the line_sample path.
TMAX_K = 500.0
PMAX_ATM = 1.5


def shift_margin(lines: GridLines, dw: float) -> int:
    """Grid-point margin covering the largest pressure-induced rounding
    drift of a line center: ceil(|d| * 1.5 atm / dw + 0.5)."""
    if lines.num_lines == 0:
        return 1
    dmax = float(np.max(np.abs(lines.d)))
    return max(1, int(np.ceil(dmax * PMAX_ATM / dw + 0.5)))


def _x_threshold_halfwidth(lines: GridLines, dw: float, x_min: float,
                           tmax: float) -> int:
    """Grid-point half-width guaranteeing |x| >= x_min outside it for every
    temperature up to ``tmax``."""
    c = constants
    if lines.num_lines == 0:
        return 1
    vmax = float(np.max(np.abs(lines.vnn))) + 1.0
    mc2 = lines.mass_g * c.C_CGS * c.C_CGS
    dv = x_min * vmax * np.sqrt(2.0 * c.KB_CGS * tmax / mc2)
    return max(int(np.ceil(dv / dw)) + 1, 1)


def near_core_halfwidth(lines: GridLines, dw: float,
                        tmax: float = TMAX_K) -> int:
    """Half-width [grid points] of the near-core window outside which the
    far-wing Voigt (Humlicek regions 0/1) is exact (|x| >= 13)."""
    return _x_threshold_halfwidth(lines, dw, _X_FAR_SAFE, tmax)


# max over y of xlim0 = 15100 + y (40 - 3.6 y) is 15211.1 at y = 5.56;
# sqrt = 123.33, so |x| >= 124 is region 0 for every y.
_X_REGION0_SAFE = 124.0


def region0_halfwidth(lines: GridLines, dw: float,
                      tmax: float = TMAX_K) -> int:
    """Half-width [grid points] outside which every point is Humlicek
    region 0 for every line, layer and physical temperature."""
    return _x_threshold_halfwidth(lines, dw, _X_REGION0_SAFE, tmax)


@dataclasses.dataclass
class PreparedLines:
    """Per-(row, line) device tensors ready for Voigt accumulation."""

    center_idx: torch.Tensor   # (rows, L) int32 nearest grid index
    center_frac: torch.Tensor  # (rows, L) f32 fractional grid offset
    strength: torch.Tensor     # (rows, L) f32, scaled by 1e20
    lorentz: torch.Tensor      # (rows, L) f32 HWHM [cm-1]
    doppler: torch.Tensor      # (rows, L) f32 HWHM*sqrt(ln2)-convention

    def kernel_layout(self) -> dict:
        """``name: (tensor, shape, dtype)`` of each field as the line
        kernels take them (:func:`..cuda_build.check_tensors`)."""
        return {f.name: (getattr(self, f.name), self.strength.shape,
                         torch.int32 if f.name == "center_idx"
                         else torch.float32)
                for f in dataclasses.fields(self)}


def prepare(lines: GridLines, grid: SpectralGrid, pavg, tavg, psavg,
            tips=None, window: tuple[int, int] | None = None
            ) -> PreparedLines:
    """Line prep for one molecule over all rows (rows = columns x layers).

    Args:
      lines: grid-bound catalog.
      pavg, tavg: (rows,) f32 layer pressure [atm] / temperature [K].
      psavg: (rows,) f32 layer partial pressure of this species [atm].
      tips: partition-function provider.
      window: ``(lo, hi)``: prep only the lines ``[lo, hi)``, read as
        views of the catalog's device tensors.  Prep is elementwise in
        (row, line), so the result is columns ``[lo, hi)`` of the whole
        catalog's prep.
    """
    if tips is None:
        tips = tips_mod.default_tips()
    c2 = constants.LINE_STRENGTH_C2
    tref = constants.TREF
    dev = lines.tensors(pavg.device)
    if window is not None:
        lo, hi = window
        dev = {f: t[lo:hi] for f, t in dev.items()}

    pavg = pavg.to(torch.float32)[:, None]
    tavg = tavg.to(torch.float32)[:, None]
    psavg = psavg.to(torch.float32)[:, None]
    d = dev["d"]

    # Pressure-shifted centers in split representation (vnn = v0 + d p).
    dw = device_constant(grid.dw, pavg.device)
    shift = d * pavg / dw                            # (rows, L) grid units
    frac = dev["frac0"][None, :] + shift
    adj = torch.floor(frac + 0.5)
    center_idx = dev["c0"][None, :] + adj.to(torch.int32)
    center_frac = frac - adj

    # Partition-function factor per (row, isotopologue), picked per line.
    qinv = tips_mod.q_inverse_layers(tips, lines.mol_id, tavg[:, 0],
                                     lines.num_iso).to(torch.float32)
    qline = qinv.index_select(1, dev["iso0"].long())

    # Temperature-corrected strengths (uses the *unshifted* center).
    strength = dev["snn"] * torch.exp(c2 * dev["en"] / tavg) * \
        (1.0 - torch.exp(c2 * dev["vnn"] / tavg)) * qline

    # Lorentz half-widths.
    lorentz = torch.pow(tref / tavg, dev["n"]) * \
        (dev["yair"] * (pavg - psavg) + dev["yself"] * psavg)

    # Doppler half-widths with the shifted center:
    # alpha = sqrt(ln2) * vnn * sqrt(2 k T / (m c^2)).
    vnn_shifted = dev["vnn"] + d * pavg
    mc2 = device_constant(lines.mass_g, pavg.device) * \
        constants.C_CGS * constants.C_CGS
    doppler = constants.SQRT_LN2 * vnn_shifted * torch.sqrt(
        2.0 * constants.KB_CGS * tavg / mc2)

    return PreparedLines(center_idx.contiguous(), center_frac.contiguous(),
                         strength.contiguous(), lorentz.contiguous(),
                         doppler.contiguous())
