"""The comparison that decides ``correct``.

For each checked column and each band-integrated flux profile (``rlu``,
``rld``, ``rsu``, ``rsd``, W m-2 at every level), the gap is the largest
distance between the program's and the reference's values over the
levels, as a share of the reference's largest value in that profile (at
least 1 W m-2, so a night column's zero shortwave is held to an absolute
1 W m-2 scale).  Each flux's number is the largest gap over the checked
columns, held to the cell's limit in ``rtbench/limits/<cell>.json``.  The
fluxes compared are those the reference gives: the longwave pair alone
for a deployment without a shortwave band.
"""
from __future__ import annotations

import numpy as np

FLUXES = ("rlu", "rld", "rsu", "rsd")
SCALE_FLOOR = 1.0       # [W m-2]


def gap(program: np.ndarray, reference: np.ndarray) -> float:
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if not np.all(np.isfinite(program)):
        return float("inf")
    scale = max(float(np.max(np.abs(reference))), SCALE_FLOOR)
    return float(np.max(np.abs(program - reference))) / scale


def gaps(pairs) -> dict:
    """``pairs``: (program, reference) flux dicts of each checked column.
    Returns {"<flux>_gap": largest gap}."""
    out = {}
    for prog, ref in pairs:
        for k in ref:
            out[f"{k}_gap"] = max(out.get(f"{k}_gap", 0.0),
                                  gap(prog[k], ref[k]))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [number, limit]}) over the limits' numbers:
    correct when every number is at or below its limit (a missing
    number, NaN and inf fail)."""
    table = {k: [numbers.get(k, float("inf")), float(v["limit"])]
             for k, v in limits.items() if k.endswith("_gap")}
    ok = all(v <= lim for v, lim in table.values())
    return ok, table
