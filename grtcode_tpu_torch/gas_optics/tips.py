"""Total internal partition sums Q(molecule, T, isotopologue) (port of
grtcode_tpu/gas_optics/tips.py).

:class:`TabulatedTips` interpolates TIPS-2017-style tables linearly in T;
:class:`PowerLawTips` is the analytic fallback
``Q(T) = Q(296) * (T/296)**beta``.  Both live on the host;
:func:`q_inverse_layers` evaluates 1/Q(T) per layer on the device.

The default table is the package's ``data/tips2017.npz``, a copy of the
JAX package's.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from .. import constants
from ..utils.graphs import device_constant
from . import molecules as mol_registry

DEFAULT_TABLE_ENV = "GRTCODE_TPU_TIPS"

# Principal-isotopologue Q(296 K) for the molecules whose partition
# functions the reference test suite pins (H2O/CO2/O3/N2O/CH4).
_Q296 = {1: 174.5813, 2: 286.09, 3: 3483.71, 4: 4984.90, 6: 590.48}

# Reference-pinned Q(275.234324 K, iso 1); each (Q296, Qpin) pair fixes the
# power-law exponent.
_T_PIN = 275.234324
_Q_PIN = {1: 156.6091754, 2: 261.25798746, 3: 3087.3115616,
          4: 4524.7762498, 6: 528.26422608}
_BETA_CAL = {m: float(np.log(_Q_PIN[m] / _Q296[m])
                      / np.log(_T_PIN / constants.TREF))
             for m in _Q_PIN}


class PowerLawTips:
    """Power-law fallback Q(T) = Q(296)·(T/296)^beta (no data files)."""

    def __init__(self, q296: Mapping[tuple, float] | None = None):
        self._q296 = {(m, 1): q for m, q in _Q296.items()}
        self._q296.update(q296 or {})

    def beta(self, mol_id: int) -> float:
        cal = _BETA_CAL.get(int(mol_id))
        if cal is not None:
            return cal
        return 1.0 if mol_registry.get(mol_id).linear else 1.5

    def q(self, mol_id: int, t, iso: int = 1):
        q296 = self._q296.get((int(mol_id), int(iso)), 1.0)
        return q296 * (np.asarray(t) / constants.TREF) ** self.beta(mol_id)

    def q_ratio(self, mol_id: int, t, iso: int = 1):
        """Q(296)/Q(T), the factor that enters line strengths."""
        return (constants.TREF / np.asarray(t)) ** self.beta(mol_id)

    def q296(self, mol_id: int, iso: int = 1) -> float:
        """Absolute Q(296 K) normalization used at parse time; the same
        instance must be passed to parse_par_file and prepare so it cancels
        against :func:`q_inverse_layers`."""
        return self._q296.get((int(mol_id), int(iso)), 1.0)


class TabulatedTips:
    """Temperature-interpolated TIPS tables loaded from an npz file.

    Molecules absent from the tables delegate to a :class:`PowerLawTips`
    fallback; isotopologues absent from a tabulated molecule use its
    principal-isotopologue table.
    """

    def __init__(self, path: str, fallback: "PowerLawTips | None" = None):
        data = np.load(path)
        tables = {}
        for key in data.files:
            if key.startswith("Q_"):
                _, mid, iso = key.split("_")
                tables[(int(mid), int(iso))] = data[key]
        if not tables:
            raise ValueError(f"no Q_<mol>_<iso> tables found in {path}")
        self._set(data["T"], tables, fallback)

    @classmethod
    def from_arrays(cls, tgrid, tables: Mapping[tuple, np.ndarray],
                    fallback: "PowerLawTips | None" = None):
        """Tables given as arrays: ``tables[(mol_id, iso)]`` on ``tgrid``."""
        tips = cls.__new__(cls)
        tips._set(tgrid, tables, fallback)
        return tips

    def _set(self, tgrid, tables, fallback):
        self._tgrid = np.asarray(tgrid, dtype=np.float64)
        self._tables = {(int(m), int(i)): np.asarray(v, dtype=np.float64)
                        for (m, i), v in tables.items()}
        self.fallback = fallback if fallback is not None else PowerLawTips()
        self._on_device = {}

    def device_tables(self, mol_id: int, num_iso: int, device, dtype):
        """(T grid (nT,), tables (num_iso, nT)) of a tabulated molecule
        as ``dtype`` tensors on ``device``, copied once: isotopologues the
        table lacks take the principal one's."""
        key = (int(mol_id), int(num_iso), torch.device(device), dtype)
        if key not in self._on_device:
            tables = [self._tables[(int(mol_id),
                                    iso if self.has(mol_id, iso) else 1)]
                      for iso in range(1, num_iso + 1)]
            self._on_device[key] = (
                torch.as_tensor(self._tgrid, dtype=dtype, device=device),
                torch.as_tensor(np.stack(tables), dtype=dtype,
                                device=device))
        return self._on_device[key]

    def has(self, mol_id: int, iso: int = 1) -> bool:
        return (int(mol_id), int(iso)) in self._tables

    def has_molecule(self, mol_id: int) -> bool:
        return (int(mol_id), 1) in self._tables

    def q(self, mol_id: int, t, iso: int = 1):
        key = (int(mol_id), int(iso))
        if key not in self._tables:
            if (int(mol_id), 1) not in self._tables:
                return self.fallback.q(mol_id, t, iso)
            key = (int(mol_id), 1)
        table = self._tables[key]
        return np.interp(np.asarray(t, dtype=np.float64), self._tgrid, table)

    def q_ratio(self, mol_id: int, t, iso: int = 1):
        return self.q(mol_id, constants.TREF, iso) / self.q(mol_id, t, iso)

    def q296(self, mol_id: int, iso: int = 1) -> float:
        """Q(296 K) from the table (the principal isotopologue's for a
        missing one), or the fallback's for a molecule the table lacks."""
        if not self.has_molecule(mol_id):
            return self.fallback.q296(mol_id, iso)
        key = (int(mol_id), int(iso)) if self.has(mol_id, iso) \
            else (int(mol_id), 1)
        return float(np.interp(constants.TREF, self._tgrid,
                               self._tables[key]))


_PACKAGED_TABLE = os.path.join(os.path.dirname(__file__), os.pardir,
                               "data", "tips2017.npz")
_default_cache = None


def default_tips():
    """The default partition-function provider, in preference order:
    $GRTCODE_TPU_TIPS table file > the packaged ``data/tips2017.npz`` >
    the power-law fallback."""
    global _default_cache
    path = os.environ.get(DEFAULT_TABLE_ENV)
    if path and os.path.exists(path):
        return TabulatedTips(path)
    if _default_cache is None:
        if os.path.exists(_PACKAGED_TABLE):
            _default_cache = TabulatedTips(_PACKAGED_TABLE)
        else:
            _default_cache = PowerLawTips()
    return _default_cache


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """Linear interpolation of ``fp(xp)`` at ``x`` clamped to ``fp[0]`` /
    ``fp[-1]`` outside ``[xp[0], xp[-1]]`` (``jnp.interp`` semantics).
    ``fp`` may carry leading axes; returns ``fp.shape[:-1] + x.shape``."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[..., i - 1], fp[..., i]
    out = f0 + ((x - x0) / (x1 - x0)) * (f1 - f0)
    out = torch.where(x < xp[0], fp[..., :1], out)
    return torch.where(x > xp[-1], fp[..., -1:], out)


def q_inverse_layers(tips, mol_id: int, tavg: torch.Tensor, num_iso: int):
    """(nlayers, num_iso) tensor of 1/Q(mol, T_layer, iso).

    Both variants return the *absolute* 1/Q(T): parse_par_file multiplied
    strengths by Q(296) from the same tips instance, so the absolute
    normalization cancels, leaving the Q(296)/Q(T) ratio in the strength.
    """
    if isinstance(tips, TabulatedTips) and not tips.has_molecule(mol_id):
        tips = tips.fallback
    if isinstance(tips, PowerLawTips):
        ratio = (constants.TREF / tavg) ** tips.beta(mol_id)
        q296 = device_constant(tuple(float(tips.q296(mol_id, iso))
                                     for iso in range(1, num_iso + 1)),
                               tavg.device)
        return ratio[:, None] / q296[None, :]
    tgrid, table = tips.device_tables(mol_id, num_iso, tavg.device,
                                      tavg.dtype)            # (num_iso, nT)
    qt = _interp(tavg, tgrid, table)                         # (num_iso, L)
    return (1.0 / qt).T
