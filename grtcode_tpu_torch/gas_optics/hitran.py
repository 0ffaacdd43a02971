"""HITRAN ``.par`` line-database parsing (port of
grtcode_tpu/gas_optics/hitran.py).

Fixed-width HITRAN2012/2016 records, the hex-like single-character
isotopologue code ('0' -> 10, 'A' -> 11, ...) and the parse-time
renormalization of each intensity by its 296 K Boltzmann /
stimulated-emission factor and Q(296).  The catalog is a plain
struct-of-numpy-arrays; device preparation happens in
:mod:`grtcode_tpu_torch.gas_optics.lines`.  The record scan runs in the
native C++ scanner (:mod:`grtcode_tpu_torch.native`) and in Python only
when that cannot be built; ``parse_par_file.parses`` counts the parses by
path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants

RECORD_LEN = 160

# Scale factor applied to stored line strengths so that float32 device math
# stays in the normal range (S0 ~ 1e-19..1e-30 cm-1/(molec cm-2)).
STRENGTH_SCALE = 1.0e20


def _iso_code(ch: str) -> int:
    """Hex-like isotopologue code."""
    if ch == "0":
        return 10
    if "A" <= ch <= "Z":
        return ord(ch) - ord("A") + 11
    return int(ch)


@dataclasses.dataclass
class LineCatalog:
    """Raw per-line parameters for one molecule (strengths renormalized and
    scaled by STRENGTH_SCALE)."""

    mol_id: int
    iso: np.ndarray      # (L,) int32, 1-based isotopologue index
    vnn: np.ndarray      # (L,) float64 vacuum wavenumber [cm-1]
    snn: np.ndarray      # (L,) float64 renormalized strength * STRENGTH_SCALE
    yair: np.ndarray     # (L,) float32 air-broadened HWHM [cm-1 atm-1]
    yself: np.ndarray    # (L,) float32 self-broadened HWHM [cm-1 atm-1]
    en: np.ndarray       # (L,) float32 lower-state energy [cm-1]
    n: np.ndarray        # (L,) float32 T exponent of air broadening
    d: np.ndarray        # (L,) float32 air pressure shift [cm-1 atm-1]

    @property
    def num_lines(self) -> int:
        return int(self.vnn.shape[0])

    def window(self, w0: float, wn: float) -> "LineCatalog":
        """Lines with centers inside [w0, wn] (the parse filter)."""
        m = (self.vnn >= w0) & (self.vnn <= wn)
        return LineCatalog(
            self.mol_id, self.iso[m], self.vnn[m], self.snn[m], self.yair[m],
            self.yself[m], self.en[m], self.n[m], self.d[m],
        )


def renormalize_strengths(s0, vnn, en, iso, mol_id, tips) -> np.ndarray:
    """Pre-divide raw intensities by their 296 K factor:

    ``snn = s0 * Q(296) / (exp(c2 En / 296) * (1 - exp(c2 vnn / 296)))``
    """
    c2 = constants.LINE_STRENGTH_C2
    tref = constants.TREF
    q296 = np.array(
        [tips.q(mol_id, tref, int(i)) for i in np.unique(iso)], dtype=np.float64
    )
    iso_map = {int(i): k for k, i in enumerate(np.unique(iso))}
    qvals = q296[[iso_map[int(i)] for i in iso]]
    return s0 * qvals / (np.exp(c2 * en / tref) * (1.0 - np.exp(c2 * vnn / tref)))


def parse_par_file(path: str, mol_id: int, w0: float = -1.0, wn: float = -1.0,
                   tips=None) -> LineCatalog:
    """Parse a HITRAN .par file for one molecule.

    Args:
      path: .par file (160-char fixed-width records).
      mol_id: HITRAN molecule id to select.
      w0, wn: optional line-center window [cm-1]; negative = unbounded.
      tips: partition-function provider (default: tips.default_tips()).
    """
    if tips is None:
        from . import tips as tips_mod
        tips = tips_mod.default_tips()

    from .. import native
    parsed = native.parse_par_native(path, mol_id, w0, wn)
    if parsed is not None:
        parse_par_file.parses["native"] += 1
        iso, vnn, s0, yair, yself, en, nexp, d = parsed
        snn = renormalize_strengths(s0, vnn, en, iso, mol_id, tips) \
            * STRENGTH_SCALE
        return LineCatalog(
            mol_id=mol_id, iso=iso.astype(np.int32), vnn=vnn, snn=snn,
            yair=yair.astype(np.float32), yself=yself.astype(np.float32),
            en=en.astype(np.float32), n=nexp.astype(np.float32),
            d=d.astype(np.float32))

    parse_par_file.parses["python"] += 1
    mol_prefix = f"{mol_id:2d}"
    rows = []
    with open(path, "r") as fh:
        for ln, raw in enumerate(fh, 1):
            line = raw.rstrip("\n\r")
            if len(line) < RECORD_LEN:
                raise ValueError(
                    f"bad record at line {ln} in {path}: "
                    f"{len(line)} < {RECORD_LEN} chars")
            if line[0:2] != mol_prefix:
                continue
            rows.append(line)

    L = len(rows)
    iso = np.empty(L, dtype=np.int32)
    vnn = np.empty(L, dtype=np.float64)
    s0 = np.empty(L, dtype=np.float64)
    yair = np.empty(L, dtype=np.float64)
    yself = np.empty(L, dtype=np.float64)
    en = np.empty(L, dtype=np.float64)
    nexp = np.empty(L, dtype=np.float64)
    d = np.empty(L, dtype=np.float64)
    for k, line in enumerate(rows):
        iso[k] = _iso_code(line[2])
        vnn[k] = float(line[3:15])
        s0[k] = float(line[15:25])
        yair[k] = float(line[35:40])
        yself[k] = float(line[40:45])
        en[k] = float(line[45:55])
        nexp[k] = float(line[55:59])
        d[k] = float(line[59:67])

    if not (w0 < 0 and wn < 0):
        m = (vnn >= w0) & (vnn <= wn)
        iso, vnn, s0, yair, yself, en, nexp, d = (
            a[m] for a in (iso, vnn, s0, yair, yself, en, nexp, d))

    snn = renormalize_strengths(s0, vnn, en, iso, mol_id, tips) * STRENGTH_SCALE
    return LineCatalog(
        mol_id=mol_id, iso=iso, vnn=vnn, snn=snn,
        yair=yair.astype(np.float32), yself=yself.astype(np.float32),
        en=en.astype(np.float32), n=nexp.astype(np.float32),
        d=d.astype(np.float32),
    )


parse_par_file.parses = {"native": 0, "python": 0}


def synthetic_catalog(mol_id: int, vnn, s0, yair, yself, en, n, d, iso=None,
                      tips=None, renormalize: bool = True) -> LineCatalog:
    """Build a catalog from raw arrays (test fixture / custom line lists).

    ``s0`` is the raw HITRAN-convention intensity; when ``renormalize`` the
    296 K factor is divided out exactly as for file parsing.
    """
    vnn = np.asarray(vnn, dtype=np.float64)
    s0 = np.asarray(s0, dtype=np.float64)
    en = np.asarray(en, dtype=np.float64)
    L = vnn.shape[0]
    iso = np.ones(L, dtype=np.int32) if iso is None else np.asarray(iso, np.int32)
    if renormalize:
        if tips is None:
            from . import tips as tips_mod
            tips = tips_mod.default_tips()
        snn = renormalize_strengths(s0, vnn, en, iso, mol_id, tips)
    else:
        snn = s0
    return LineCatalog(
        mol_id=mol_id, iso=iso, vnn=vnn, snn=snn * STRENGTH_SCALE,
        yair=np.asarray(yair, np.float32), yself=np.asarray(yself, np.float32),
        en=en.astype(np.float32), n=np.asarray(n, np.float32),
        d=np.asarray(d, np.float32),
    )
